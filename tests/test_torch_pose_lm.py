"""The pose-only LM of the PyTorch port (optim/pose_opt.py) against the JAX
package's optim/pose_opt.optimize_pose, at full width (B = 3 poses, N =
1000 edges), and the wrapper of its CUDA kernel (csrc/pose_lm.cu).

On the CPU ``optimize_pose`` is the plain version; the kernel runs only on
a card (tests/test_torch_cuda.py, chip_smoke.py). Every problem comes from
``dataio.synthetic.pose_problem`` with a numpy seed, one JAX solve per pose.

Tolerances: inlier masks and counts exact; R and t within 1e-4; chi2 within
1e-3 relative. The 40 LM steps run in float32 and the two packages take
their sums (H, b, chi2) in another order, so accept decisions near
convergence may fall apart by a rounding's worth.
"""
import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_with_comment_tpu.optim import pose_opt as jpose
from orb_slam2_with_comment_tpu.optim.residuals import CamParams as JCam
from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
    POSE_CASES, pose_problem)
from orb_slam2_with_comment_tpu_torch.ops import cuda_lib
from orb_slam2_with_comment_tpu_torch.optim import pose_opt
from orb_slam2_with_comment_tpu_torch.optim.residuals import CamParams

torch.set_num_threads(2)

CAM = CamParams.of(500.0, 500.0, 320.0, 240.0, 40.0)
JCAM = JCam(*[jnp.float32(v) for v in CAM])
KEYS = ("R0", "t0", "Xw", "obs_uvr", "inv_sigma2", "valid")
# one compile for every case of one shape
_jax_solve = jax.jit(jpose.optimize_pose)


def _torch_args(p):
    return [torch.as_tensor(p[k]) for k in KEYS]


def _jax_row(p, b):
    obs = p["obs_uvr"][b] if p["obs_uvr"].ndim == 3 else p["obs_uvr"]
    s2 = p["inv_sigma2"][b] if p["inv_sigma2"].ndim == 2 else p["inv_sigma2"]
    return _jax_solve(JCAM, p["R0"][b], p["t0"][b], p["Xw"][b], obs, s2,
                      p["valid"][b])


def _assert_row(out, b, ref):
    np.testing.assert_array_equal(out.inliers[b].numpy(),
                                  np.asarray(ref.inliers))
    assert int(out.n_inliers[b]) == int(ref.n_inliers)
    np.testing.assert_allclose(out.R[b].numpy(), np.asarray(ref.R), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(out.t[b].numpy(), np.asarray(ref.t), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(float(out.chi2[b]), float(ref.chi2),
                               rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("case", POSE_CASES)
def test_pose_lm_matches_jax(case):
    seed = 100 + POSE_CASES.index(case)
    p = pose_problem(case, seed)
    out = pose_opt.optimize_pose(CAM, *_torch_args(p))
    assert out.inliers.dtype == torch.bool
    assert out.n_inliers.dtype == torch.int32
    for b in range(3):
        _assert_row(out, b, _jax_row(p, b))
    n = out.n_inliers.tolist()
    if case == "no_valid_row":
        # H = 0: each damped step is 0 and rejected, the pose stays
        assert n[1] == 0 and float(out.chi2[1]) == 0.0
        np.testing.assert_allclose(out.t[1].numpy(), p["t0"][1], atol=0)
        np.testing.assert_allclose(out.R[1].numpy(), p["R0"][1], atol=1e-6)
    elif case == "three_valid_row":
        assert n[2] <= 3 and min(n[:2]) > 800
    else:
        assert min(n) > 700, n


def test_broadcast_forms_equal_the_batched_forms():
    """obs_uvr [N,3] and inv_sigma2 [N] give what their copies per row,
    [B,N,3] and [B,N], give."""
    p = pose_problem("outliers", 3)
    args = _torch_args(p)
    a = pose_opt.optimize_pose(CAM, *args)
    B = args[0].shape[0]
    args[3] = args[3].expand(B, -1, -1).contiguous()
    args[4] = args[4].expand(B, -1).contiguous()
    b = pose_opt.optimize_pose(CAM, *args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    args = _torch_args(pose_problem("mixed", 5, B=2, N=64))
    before = dict(pose_opt.LAUNCHES)
    got = pose_opt.optimize_pose(CAM, *args)
    want = pose_opt.optimize_pose_plain(CAM, *args)
    assert pose_opt.LAUNCHES == before
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_wrapper_refuses_mixed_devices_and_float64():
    args = _torch_args(pose_problem("mixed", 6, B=2, N=32))
    mixed = list(args)
    mixed[2] = mixed[2].to("meta")
    with pytest.raises(ValueError):
        pose_opt.optimize_pose(CAM, *mixed)
    for i in range(5):
        wide = list(args)
        wide[i] = wide[i].double()
        with pytest.raises(ValueError):
            pose_opt.optimize_pose(CAM, *wide)
    with pytest.raises(ValueError):
        pose_opt.optimize_pose(CAM, *args[:5], args[5].int())
    with pytest.raises(ValueError):  # Xw of another N
        pose_opt.optimize_pose(CAM, args[0], args[1], args[2][:, :5],
                               *args[3:])


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "long long": ctypes.c_longlong, "float": ctypes.c_float,
            "int": ctypes.c_int}


class _FakeFn:
    """Takes the argtypes and restype a ctypes function would."""


def test_binding_matches_the_extern_c_interface():
    """The symbols the wrapper binds are the source's extern "C" functions,
    with the same parameter types in the same order, and the source's edge
    limit (edges a block holds times blocks a pose may have) is the
    wrapper's."""
    src_path = os.path.join(cuda_lib.CSRC_DIR, "pose_lm.cu")
    with open(src_path) as f:
        src = f.read()
    extern = src[src.index('extern "C" {'):]

    def const(name):
        return int(re.search(rf"{name} = (\d+);", src).group(1))

    assert re.search(r"kMaxEdges = kBlockEdges \* kMaxCluster;", src)
    assert const("kBlockEdges") * const("kMaxCluster") == pose_opt.MAX_EDGES

    class Lib:
        pose_lm_solve = _FakeFn()
        pose_lm_blocks_per_pose = _FakeFn()

    lib = pose_opt._bind(Lib())
    for fn in ("pose_lm_solve", "pose_lm_blocks_per_pose"):
        m = re.search(rf"int {fn}\(([^)]*)\)", extern)
        assert m, f"{fn} is not in the extern \"C\" block"
        params = [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]
        assert getattr(lib, fn).argtypes == [_C_TYPES[p] for p in params]
        assert getattr(lib, fn).restype is ctypes.c_int
