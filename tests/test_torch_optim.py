"""Pose-only LM and the local-BA Schur solver of the PyTorch port against
the JAX package, on synthetic problems made from a numpy seed.

Tolerances: the pose within 1e-4 and identical inlier masks (the 40-step
LM runs in float32 with reductions summed in another order); BA chi2
within 1e-3 relative, poses and points within 1e-3 (dense float32 Schur
solve assembled in another order).
"""
import numpy as np
import jax.numpy as jnp
import torch

from orb_slam2_with_comment_tpu.geometry import se3 as jse3
from orb_slam2_with_comment_tpu.optim import ba as jba
from orb_slam2_with_comment_tpu.optim import pose_opt as jpose
from orb_slam2_with_comment_tpu.optim.residuals import CamParams as JCam
from orb_slam2_with_comment_tpu_torch.optim import ba, pose_opt
from orb_slam2_with_comment_tpu_torch.optim.residuals import CamParams

torch.set_num_threads(2)

CAM = CamParams.of(500.0, 500.0, 320.0, 240.0, 40.0)
JCAM = JCam(*[jnp.float32(v) for v in CAM])


def _rot(w):
    return np.asarray(jse3.exp_so3(jnp.asarray(np.float32(w))))


def _project(R, t, X):
    Xc = X @ R.T + t
    u = CAM.fx * Xc[:, 0] / Xc[:, 2] + CAM.cx
    v = CAM.fy * Xc[:, 1] / Xc[:, 2] + CAM.cy
    return np.stack([u, v, u - CAM.bf / Xc[:, 2]], 1)


def _pose_problem(rng):
    n = 300
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(2, 6, n)], 1).astype(np.float32)
    R, t = _rot([0.01, -0.02, 0.005]), np.float32([0.05, 0.01, -0.03])
    uvr = _project(R, t, X) + rng.normal(0, 0.7, (n, 3))
    uvr[::4, 2] = -1.0  # mono observations
    bad = rng.rand(n) < 0.1
    uvr[bad, :2] += rng.uniform(-40, 40, (bad.sum(), 2))
    octave = rng.randint(0, 4, n)
    inv_s2 = (1.0 / 1.44 ** octave).astype(np.float32)
    valid = rng.rand(n) < 0.9
    return X, uvr.astype(np.float32), inv_s2, valid


def test_pose_opt_batched_matches_jax():
    rng = np.random.RandomState(21)
    X, uvr, inv_s2, valid = _pose_problem(rng)
    inits = [(_rot([0.0, 0.0, 0.0]), np.zeros(3, np.float32)),
             (_rot([0.02, -0.01, 0.0]), np.float32([0.08, -0.02, 0.0])),
             (_rot([-0.01, -0.03, 0.01]), np.float32([0.0, 0.03, -0.08]))]
    B = len(inits)
    out = pose_opt.optimize_pose(
        CAM, torch.as_tensor(np.stack([r for r, _ in inits])),
        torch.as_tensor(np.stack([t for _, t in inits])),
        torch.as_tensor(np.broadcast_to(X, (B,) + X.shape).copy()),
        torch.as_tensor(uvr), torch.as_tensor(inv_s2),
        torch.as_tensor(np.broadcast_to(valid, (B, len(valid))).copy()))
    for b, (R0, t0) in enumerate(inits):
        ref = jpose.optimize_pose(JCAM, jnp.asarray(R0), jnp.asarray(t0),
                                  jnp.asarray(X), jnp.asarray(uvr),
                                  jnp.asarray(inv_s2), jnp.asarray(valid))
        np.testing.assert_allclose(out.R[b].numpy(), np.asarray(ref.R),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(out.t[b].numpy(), np.asarray(ref.t),
                                   rtol=0, atol=1e-4)
        np.testing.assert_array_equal(out.inliers[b].numpy(),
                                      np.asarray(ref.inliers))
        assert int(out.n_inliers[b]) == int(ref.n_inliers) > 150


def _ba_problem(rng):
    P, L, D = 6, 300, 4
    Rs = np.stack([_rot([0.0, 0.05 * p, 0.0]) for p in range(P)])
    ts = np.stack([np.float32([-0.1 * p, 0.0, 0.0]) for p in range(P)])
    X = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1, 1, L),
                  rng.uniform(3, 6, L)], 1).astype(np.float32)
    obs_pose = np.stack([rng.choice(P, D, replace=False) for _ in range(L)])
    uvr = np.zeros((L, D, 3), np.float32)
    for d in range(D):
        for p in range(P):
            sel = obs_pose[:, d] == p
            uvr[sel, d] = _project(Rs[p], ts[p], X[sel])
    uvr += rng.normal(0, 0.8, uvr.shape).astype(np.float32)
    uvr[:, 1::2, 2] = -1.0
    w = np.where(rng.rand(L, D) < 0.85, 1.0 / 1.44 ** rng.randint(0, 3, (L, D)),
                 0.0).astype(np.float32)
    R0 = np.stack([_rot(rng.normal(0, 0.003, 3)) @ R for R in Rs])
    t0 = (ts + rng.normal(0, 0.01, ts.shape)).astype(np.float32)
    X0 = (X + rng.normal(0, 0.03, X.shape)).astype(np.float32)
    fixed = np.array([True, True, False, False, False, False])
    pvalid = rng.rand(L) < 0.95
    return (R0.astype(np.float32), t0, X0, obs_pose.astype(np.int32), uvr, w,
            fixed, pvalid)


def test_ba_chunk_matches_jax():
    R0, t0, X0, obs_pose, uvr, w, fixed, pvalid = _ba_problem(
        np.random.RandomState(31))
    jres = jba.ba_solve(JCAM, jba.BAProblem(
        *(jnp.asarray(a) for a in (R0, t0, X0, obs_pose, uvr, w, fixed,
                                   pvalid))), iters=3, robust=True,
        init_lambda=jnp.float32(1e-4))
    tres = ba.ba_solve(CAM, ba.BAProblem(
        *(torch.as_tensor(a) for a in (R0, t0, X0, obs_pose.astype(np.int64),
                                       uvr, w, fixed, pvalid))),
        iters=3, robust=True, init_lambda=1e-4)
    chi2_j, chi2_t = float(jres.chi2), float(tres.chi2)
    assert abs(chi2_t - chi2_j) <= 1e-3 * chi2_j
    assert float(tres.final_lambda) == float(jres.final_lambda)
    for a, b in ((tres.R, jres.R), (tres.t, jres.t), (tres.X, jres.X)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-3)
    np.testing.assert_allclose(tres.obs_chi2.numpy(), np.asarray(
        jres.obs_chi2), rtol=1e-2, atol=1e-3)
    # the solve made progress from the perturbed start
    start = ba.ba_solve(CAM, ba.BAProblem(
        *(torch.as_tensor(a) for a in (R0, t0, X0, obs_pose.astype(np.int64),
                                       uvr, w, fixed, pvalid))), iters=0)
    assert chi2_t < 0.5 * float(start.chi2)
