"""Pose-only optimization (port of optim/pose_opt.py).

One SE3 pose per batch row against fixed landmarks: 4 rounds x 10 LM
iterations, Huber kernel in the first two rounds, chi2 inlier
reclassification between rounds, then one orthonormalization. The batch
axis carries the three independent solves of a tracking frame
(pipeline/steps.py track_frame_core) through one schedule.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from .residuals import (CHI2_MONO, CHI2_STEREO, HUBER_MONO, HUBER_STEREO,
                        CamParams, huber_weight, reproj_residual)


class PoseOptResult(NamedTuple):
    R: torch.Tensor  # [B, 3, 3]
    t: torch.Tensor  # [B, 3]
    inliers: torch.Tensor  # [B, N] bool
    n_inliers: torch.Tensor  # [B] int32
    chi2: torch.Tensor  # [B]


def _per_obs_chi2(cam, R, t, Xw, obs_uvr, inv_sigma2):
    e, _, _ = reproj_residual(cam, R[:, None], t[:, None], Xw, obs_uvr)
    return (e * e).sum(-1) * inv_sigma2


def _components(cam, R, t, Xw, obs_uvr, srow):
    """Residual [B, N, 3] and pose Jacobian [B, N, 3, 6] (left update)."""
    Xc = se3.transform(R[:, None], t[:, None], Xw)
    x, y = Xc[..., 0], Xc[..., 1]
    z = Xc[..., 2]
    z = torch.where(z.abs() < 1e-9, 1e-9, z)
    iz = 1.0 / z
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    e = torch.stack([obs_uvr[..., 0] - u, obs_uvr[..., 1] - v,
                     (obs_uvr[..., 2] - ur) * srow], -1)
    zero = torch.zeros_like(x)
    Jproj = torch.stack([
        torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1),
        torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1),
        torch.stack([(cam.fx * iz) * srow, zero,
                     (-cam.fx * x * iz2 + cam.bf * iz2) * srow], -1)], -2)
    Xc = torch.stack([x, y, z], -1)
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(Jproj.shape)
    return e, -(Jproj @ torch.cat([eye, -se3.hat(Xc)], -1))


def optimize_pose(cam: CamParams, R0, t0, Xw, obs_uvr, inv_sigma2, valid,
                  rounds: int = 4, iters_per_round: int = 10) -> PoseOptResult:
    """R0 [B,3,3], t0 [B,3]; Xw [B,N,3]; obs_uvr [N,3] or [B,N,3];
    inv_sigma2 [N] or [B,N]; valid [B,N] bool."""
    is_stereo = obs_uvr[..., 2] >= 0
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    delta = torch.where(is_stereo, HUBER_STEREO, HUBER_MONO)
    srow = is_stereo.to(obs_uvr.dtype)
    B, N = valid.shape
    dev = R0.device
    R, t = R0, t0
    lam = torch.full((B,), 1e-3, dtype=torch.float32, device=dev)
    inlier = torch.ones((B, N), dtype=torch.bool, device=dev)
    for rnd in range(rounds):
        robust = rnd < 2
        for _ in range(iters_per_round):
            e, Jp = _components(cam, R, t, Xw, obs_uvr, srow)
            chi2_i = (e * e).sum(-1) * inv_sigma2
            w_rob = huber_weight(chi2_i, delta) if robust else 1.0
            use = valid & inlier
            w = torch.where(use, inv_sigma2 * w_rob, 0.0)
            wJp = Jp * w[..., None, None]
            H = torch.einsum("bnri,bnrj->bij", wJp, Jp)
            b = torch.einsum("bnri,bnr->bi", wJp, e)
            D = torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)
                                 .clamp(min=1e-6))
            sol, _ = torch.linalg.solve_ex(H + lam[:, None, None] * D,
                                           b[..., None])
            delta_xi = -sol[..., 0]
            R_new, t_new = se3.retract(R, t, delta_xi)
            chi2_old = torch.where(use, chi2_i * w_rob, 0.0).sum(-1)
            chi2_new_i = _per_obs_chi2(cam, R_new, t_new, Xw, obs_uvr,
                                       inv_sigma2)
            w_rob_new = huber_weight(chi2_new_i, delta) if robust else 1.0
            chi2_new = torch.where(use, chi2_new_i * w_rob_new, 0.0).sum(-1)
            ok = (chi2_new < chi2_old) & torch.isfinite(delta_xi).all(-1)
            R = torch.where(ok[:, None, None], R_new, R)
            t = torch.where(ok[:, None], t_new, t)
            lam = torch.where(ok, lam * 0.5, lam * 4.0).clamp(1e-9, 1e6)
        inlier = _per_obs_chi2(cam, R, t, Xw, obs_uvr, inv_sigma2) <= chi2_th
    inlier = inlier & valid
    chi2_i = _per_obs_chi2(cam, R, t, Xw, obs_uvr, inv_sigma2)
    total = torch.where(inlier, chi2_i, 0.0).sum(-1)
    return PoseOptResult(se3.orthonormalize(R), t, inlier,
                         inlier.sum(-1, dtype=torch.int32), total)
