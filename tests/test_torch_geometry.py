"""SE(3) operations and reprojection residuals of the PyTorch port against
the JAX package, on the same numpy inputs.

Tolerance: 1e-6 of each output's scale (its largest magnitude, at least
1): the two sides evaluate the same float32 formulas and differ only in
the last bits of transcendental functions and in the summation order of
the small matrix products, which cancel in the pose Jacobians (measured
2.2e-6 relative on entries of ~1e3 whose array peaks near 1e4).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_with_comment_tpu.geometry import se3 as jse3
from orb_slam2_with_comment_tpu.optim import residuals as jres
from orb_slam2_with_comment_tpu_torch.geometry import se3
from orb_slam2_with_comment_tpu_torch.optim import residuals as res

torch.set_num_threads(2)



def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= 1e-6 * scale


def _inputs():
    rng = np.random.RandomState(11)
    w = rng.normal(0, 0.8, (64, 3)).astype(np.float32)
    w[:4] = [[0, 0, 0], [1e-6, 0, 0], [0, 3.1415, 0], [0, 0, -1e-5]]
    xi = rng.normal(0, 0.3, (64, 6)).astype(np.float32)
    t = rng.normal(0, 1.0, (64, 3)).astype(np.float32)
    X = (rng.uniform(-2, 2, (64, 3)) + [0, 0, 4]).astype(np.float32)
    return w, xi, t, X


def _both(fn_t, fn_j, *args):
    out_t = fn_t(*(torch.as_tensor(a) for a in args))
    out_j = fn_j(*(jnp.asarray(a) for a in args))
    if isinstance(out_t, tuple):
        return [o.numpy() for o in out_t], [np.asarray(o) for o in out_j]
    return [out_t.numpy()], [np.asarray(out_j)]


@pytest.mark.parametrize("name", ["hat", "exp_so3", "log_so3", "exp_se3",
                                  "retract", "compose", "inverse",
                                  "transform", "orthonormalize",
                                  "matrix_to_quat"])
def test_se3_matches_jax(name):
    w, xi, t, X = _inputs()
    R = np.asarray(jse3.exp_so3(jnp.asarray(w)))
    args = {"hat": (w,), "exp_so3": (w,), "log_so3": (R,), "exp_se3": (xi,),
            "retract": (R, t, xi), "compose": (R, t, R[::-1].copy(), X),
            "inverse": (R, t), "transform": (R, t, X),
            "orthonormalize": (R * 1.001,), "matrix_to_quat": (R,)}[name]
    got, want = _both(getattr(se3, name), getattr(jse3, name), *args)
    for g, wv in zip(got, want):
        _close(g, wv)


def test_residuals_match_jax():
    w, _, t, X = _inputs()
    R = np.asarray(jse3.exp_so3(jnp.asarray(w * 0.1)))
    rng = np.random.RandomState(12)
    uvr = rng.uniform(0, 640, (64, 3)).astype(np.float32)
    uvr[::3, 2] = -1.0  # mono rows
    cam_t = res.CamParams.of(500.0, 505.0, 320.0, 240.0, 40.0)
    cam_j = jres.CamParams(*[jnp.float32(v) for v in cam_t])
    Xc = X
    pairs = [
        (res.project_uvr(cam_t, torch.as_tensor(Xc)),
         jres.project_uvr(cam_j, jnp.asarray(Xc))),
        (res.dproj_dXc(cam_t, torch.as_tensor(Xc)),
         jres.dproj_dXc(cam_j, jnp.asarray(Xc))),
        (res.huber_weight(torch.as_tensor(uvr[:, 0] / 40.0), 2.0),
         jres.huber_weight(jnp.asarray(uvr[:, 0] / 40.0), 2.0)),
    ]
    targs = [torch.as_tensor(a) for a in (R, t, X, uvr)]
    jargs = [jnp.asarray(a) for a in (R, t, X, uvr)]
    pairs += list(zip(res.reproj_residual(cam_t, *targs),
                      jres.reproj_residual(cam_j, *jargs)))
    pairs += list(zip(res.reproj_jacobians(cam_t, *targs),
                      jres.reproj_jacobians(cam_j, *jargs)))
    for a, b in pairs:
        _close(a.numpy(), np.asarray(b))
