"""Plain pose-only Levenberg-Marquardt: the reference a frame's pose is
compared with.

A frozen copy of the port's ``optimize_pose_plain`` (``optim/pose_opt.py``)
with the helpers it uses from ``geometry/se3.py`` and
``optim/residuals.py``, at commit 41c5463: one SE3 pose per row against
fixed landmarks, 4 rounds of 10 LM iterations, the Huber kernel in the
first two rounds, the chi2 inlier test between rounds, one
orthonormalization at the end. It imports nothing of the port.

``dt`` is the precision of the residuals, Jacobians, normal equations and
the pose: float32 for the reference, bfloat16 for the control. The 6x6
solve runs in float32 either way (no bfloat16 solver exists).
"""
from __future__ import annotations

import numpy as np
import torch

CHI2_MONO, CHI2_STEREO = 5.991, 7.815
HUBER_MONO, HUBER_STEREO = CHI2_MONO ** 0.5, CHI2_STEREO ** 0.5
_EPS = 1e-8
INV_SIGMA2 = (1.0 / (1.2 ** np.arange(8)) ** 2).astype(np.float32)


def f32(x: float) -> float:
    return float(np.float32(x))


def hat(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp_se3(xi: torch.Tensor):
    rho, w = xi[..., :3], xi[..., 3:]
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2.clamp(min=1e-16))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta))
                    / (theta2 * theta).clamp(min=1e-16))
    W = hat(w)
    WW = W @ W
    R = _eye_like(W) + a[..., None, None] * W + b[..., None, None] * WW
    J = _eye_like(W) + b[..., None, None] * W + c[..., None, None] * WW
    return R, (J @ rho[..., None])[..., 0]


def transform(R, t, X):
    return (R @ X[..., None])[..., 0] + t


def _huber(chi2: torch.Tensor, delta) -> torch.Tensor:
    abs_e = torch.sqrt(chi2.clamp(min=1e-12))
    return torch.where(abs_e <= delta, 1.0, delta / abs_e).to(chi2.dtype)


def _residual(cam, R, t, Xw, obs_uvr):
    fx, fy, cx, cy, bf = cam
    Xc = transform(R, t, Xw)
    z = Xc[..., 2]
    iz = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
    u = fx * Xc[..., 0] * iz + cx
    v = fy * Xc[..., 1] * iz + cy
    proj = torch.stack([u, v, u - bf * iz], -1)
    ones = torch.ones_like(obs_uvr[..., 0])
    rows = torch.stack([ones, ones, (obs_uvr[..., 2] >= 0).to(obs_uvr.dtype)],
                       -1)
    return (obs_uvr - proj) * rows


def _chi2(cam, R, t, Xw, obs_uvr, inv_sigma2):
    e = _residual(cam, R[:, None], t[:, None], Xw, obs_uvr)
    return (e * e).sum(-1) * inv_sigma2


def _components(cam, R, t, Xw, obs_uvr, srow):
    fx, fy, cx, cy, bf = cam
    Xc = transform(R[:, None], t[:, None], Xw)
    x, y = Xc[..., 0], Xc[..., 1]
    z = Xc[..., 2]
    z = torch.where(z.abs() < 1e-9, 1e-9, z)
    iz = 1.0 / z
    iz2 = iz * iz
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    ur = u - bf * iz
    e = torch.stack([obs_uvr[..., 0] - u, obs_uvr[..., 1] - v,
                     (obs_uvr[..., 2] - ur) * srow], -1)
    zero = torch.zeros_like(x)
    Jproj = torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz2], -1),
        torch.stack([zero, fy * iz, -fy * y * iz2], -1),
        torch.stack([(fx * iz) * srow, zero,
                     (-fx * x * iz2 + bf * iz2) * srow], -1)], -2)
    Xc = torch.stack([x, y, z], -1)
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(Jproj.shape)
    return e, -(Jproj @ torch.cat([eye, -hat(Xc)], -1))


def optimize_pose(cam, R0, t0, Xw, obs_uvr, inv_sigma2, valid,
                  dt=torch.float32, rounds: int = 4, iters: int = 10):
    """(R [B, 3, 3], t [B, 3], inliers [B, N]) of the pose-only LM from
    R0 [B, 3, 3], t0 [B, 3] against Xw [B, N, 3] observed at obs_uvr [N, 3]
    (u_r < 0: a mono observation) with weights inv_sigma2 [N]; valid
    [B, N]. ``cam`` is (fx, fy, cx, cy, bf)."""
    cam = tuple(f32(v) for v in cam)
    R, t = R0.to(dt), t0.to(dt)
    Xw, obs_uvr, inv_sigma2 = Xw.to(dt), obs_uvr.to(dt), inv_sigma2.to(dt)
    is_stereo = obs_uvr[..., 2] >= 0
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    delta = torch.where(is_stereo, HUBER_STEREO, HUBER_MONO)
    srow = is_stereo.to(dt)
    B, N = valid.shape
    dev = R0.device
    lam = torch.full((B,), 1e-3, dtype=torch.float32, device=dev)
    inlier = torch.ones((B, N), dtype=torch.bool, device=dev)
    for rnd in range(rounds):
        robust = rnd < 2
        for _ in range(iters):
            e, Jp = _components(cam, R, t, Xw, obs_uvr, srow)
            chi2_i = (e * e).sum(-1) * inv_sigma2
            w_rob = _huber(chi2_i, delta) if robust else 1.0
            use = valid & inlier
            w = torch.where(use, inv_sigma2 * w_rob, 0.0).to(dt)
            wJp = Jp * w[..., None, None]
            H = torch.einsum("bnri,bnrj->bij", wJp, Jp).to(torch.float32)
            b = torch.einsum("bnri,bnr->bi", wJp, e).to(torch.float32)
            D = torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)
                                 .clamp(min=1e-6))
            sol, _ = torch.linalg.solve_ex(H + lam[:, None, None] * D,
                                           b[..., None])
            dxi = (-sol[..., 0]).to(dt)
            dR, dtt = exp_se3(dxi)
            R_new = dR @ R
            t_new = (dR @ t[..., None])[..., 0] + dtt
            chi2_old = torch.where(use, chi2_i * w_rob, 0.0).to(
                torch.float32).sum(-1)
            chi2_new_i = _chi2(cam, R_new, t_new, Xw, obs_uvr, inv_sigma2)
            w_new = _huber(chi2_new_i, delta) if robust else 1.0
            chi2_new = torch.where(use, chi2_new_i * w_new, 0.0).to(
                torch.float32).sum(-1)
            ok = (chi2_new < chi2_old) & torch.isfinite(dxi).all(-1)
            R = torch.where(ok[:, None, None], R_new, R)
            t = torch.where(ok[:, None], t_new, t)
            lam = torch.where(ok, lam * 0.5, lam * 4.0).clamp(1e-9, 1e6)
        inlier = _chi2(cam, R, t, Xw, obs_uvr, inv_sigma2) <= chi2_th
    inlier = inlier & valid
    rtr = R.transpose(-1, -2) @ R
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    R = R @ (1.5 * eye - 0.5 * rtr)
    return R.to(torch.float32), t.to(torch.float32), inlier
