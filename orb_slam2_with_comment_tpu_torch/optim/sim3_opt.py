"""Sim(3) relative-pose refinement with two-way projection edges (port of
optim/sim3_opt.py; reference: Optimizer::OptimizeSim3, Optimizer.cc:1145-
1347).

e1_i = obs1_i - proj1(S12 X2_i) and e2_i = obs2_i - proj2(S12^-1 X1_i),
Huber kernel with delta = sqrt(th2), two halves of LM iterations with an
inlier reclassification between them, ``fix_scale`` for stereo/RGB-D.
The Jacobians are forward-mode derivatives of the residual at a zero
update, one tangent per coordinate, as jax.jacfwd takes them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp

from ..geometry import sim3
from .residuals import huber_weight


class Sim3OptResult(NamedTuple):
    R: torch.Tensor  # [3, 3] refined R12
    t: torch.Tensor  # [3]
    s: torch.Tensor  # []
    inliers: torch.Tensor  # [N] bool (both directions pass)
    n_inliers: torch.Tensor  # [] int32


def _project(K, Xc):
    fx, fy, cx, cy = K
    z = Xc[..., 2]
    iz = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
    return torch.stack([fx * Xc[..., 0] * iz + cx, fy * Xc[..., 1] * iz + cy],
                       -1)


def optimize_sim3(K1, K2, R0, t0, s0, X1, X2, obs1, obs2, inv_sigma2_1,
                  inv_sigma2_2, valid, iters: int = 10, th2: float = 10.0,
                  fix_scale: bool = False) -> Sim3OptResult:
    """X1/X2 [N, 3] the matched points in the camera-1/camera-2 frames;
    obs1 [N, 2] pixels in image 1 (of the X2 points), obs2 in image 2."""
    delta = float(torch.tensor(th2, dtype=torch.float32).sqrt())
    dev, dt = X1.device, X1.dtype

    def residuals(xi, R, t, s):
        """xi [B, 7] -> (e1, e2) [B, N, 2]."""
        R_, t_, s_ = sim3.retract(R, t, s, xi)
        e1 = obs1 - _project(K1, sim3.transform(
            R_[:, None], t_[:, None], s_[:, None], X2))
        Ri, ti, si = sim3.inverse(R_, t_, s_)
        e2 = obs2 - _project(K2, sim3.transform(
            Ri[:, None], ti[:, None], si[:, None], X1))
        return e1, e2

    def chi2_pair(R, t, s):
        e1, e2 = residuals(torch.zeros((1, 7), dtype=dt, device=dev), R, t, s)
        return ((e1[0] * e1[0]).sum(-1) * inv_sigma2_1,
                (e2[0] * e2[0]).sum(-1) * inv_sigma2_2)

    eye7 = torch.eye(7, dtype=dt, device=dev)
    zeros7 = torch.zeros((7, 7), dtype=dt, device=dev)

    def iteration(R, t, s, lam, inlier):
        (e1, e2), (J1, J2) = jvp(lambda xi: residuals(xi, R, t, s),
                                 (zeros7,), (eye7,))
        e1, e2 = e1[0], e2[0]
        J1 = J1.permute(1, 2, 0)  # [N, 2, 7]
        J2 = J2.permute(1, 2, 0)
        c1 = (e1 * e1).sum(-1) * inv_sigma2_1
        c2 = (e2 * e2).sum(-1) * inv_sigma2_2
        use = valid & inlier
        w1 = torch.where(use, inv_sigma2_1 * huber_weight(c1, delta), 0.0)
        w2 = torch.where(use, inv_sigma2_2 * huber_weight(c2, delta), 0.0)
        if fix_scale:
            J1 = torch.cat([J1[..., :6], torch.zeros_like(J1[..., 6:])], -1)
            J2 = torch.cat([J2[..., :6], torch.zeros_like(J2[..., 6:])], -1)
        H = (torch.einsum("nri,n,nrj->ij", J1, w1, J1)
             + torch.einsum("nri,n,nrj->ij", J2, w2, J2))
        b = (torch.einsum("nri,n,nr->i", J1, w1, e1)
             + torch.einsum("nri,n,nr->i", J2, w2, e2))
        D = torch.diag(torch.diagonal(H).clamp(min=1e-6))
        dxi = -torch.linalg.solve_ex(H + lam * D, b[:, None])[0][:, 0]
        if fix_scale:
            dxi = torch.cat([dxi[:6], torch.zeros_like(dxi[6:])])
        R_new, t_new, s_new = sim3.retract(R, t, s, dxi)
        c1n, c2n = chi2_pair(R_new, t_new, s_new)
        mask = use.to(dt)
        ok = (((c1n + c2n) * mask).sum() < ((c1 + c2) * mask).sum()) \
            & torch.isfinite(dxi).all()
        R = torch.where(ok, R_new, R)
        t = torch.where(ok, t_new, t)
        s = torch.where(ok, s_new, s)
        lam = torch.where(ok, lam * 0.5, lam * 4.0).clamp(1e-12, 1e8)
        return R, t, s, lam

    R, t = R0, t0
    s = torch.as_tensor(s0, dtype=dt, device=dev).reshape(())
    lam = torch.tensor(1e-3, dtype=dt, device=dev)
    inlier = torch.ones(X1.shape[0], dtype=torch.bool, device=dev)
    # two halves with a chi2 > th2 reclassification between them
    # (Optimizer.cc:1287-1340)
    for _ in range(max(1, iters // 2)):
        R, t, s, lam = iteration(R, t, s, lam, inlier)
    c1, c2 = chi2_pair(R, t, s)
    inlier = (c1 <= th2) & (c2 <= th2) & valid
    for _ in range(max(1, iters - iters // 2)):
        R, t, s, lam = iteration(R, t, s, lam, inlier)
    c1, c2 = chi2_pair(R, t, s)
    inlier = (c1 <= th2) & (c2 <= th2) & valid
    return Sim3OptResult(R, t, s, inlier, inlier.sum(dtype=torch.int32))
