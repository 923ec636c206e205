"""Closed-form absolute orientation, batched (port of solvers/horn.py).

Sim3Solver::ComputeSim3's core (reference: Sim3Solver.cc:239-351) as a
Kabsch/Umeyama SVD over a batch of paired point sets. Samples whose
cross-covariance is not finite (NaN or inf points) are solved on the
identity instead, so the batched SVD never sees a NaN, and come back as
NaN poses, which every caller scores as a failed hypothesis.
"""
from __future__ import annotations

import torch


def _det3(M: torch.Tensor) -> torch.Tensor:
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def solve(P1: torch.Tensor, P2: torch.Tensor, with_scale: bool = True,
          w: torch.Tensor | None = None):
    """(R, t, s) minimizing || sqrt(w) (P1 - (s R P2 + t)) ||.

    P1, P2 [..., N, 3] paired points; w optional [..., N] weights.
    Returns R [..., 3, 3], t [..., 3], s [...]."""
    if w is None:
        c1 = P1.mean(-2, keepdim=True)
        c2 = P2.mean(-2, keepdim=True)
    else:
        wn = w[..., None]
        wsum = wn.sum(-2, keepdim=True).clamp(min=1e-9)
        c1 = (P1 * wn).sum(-2, keepdim=True) / wsum
        c2 = (P2 * wn).sum(-2, keepdim=True) / wsum
    q1 = P1 - c1
    q2 = P2 - c2
    wq1 = q1 if w is None else q1 * w[..., None]
    H = q2.transpose(-1, -2) @ wq1
    bad = ~torch.isfinite(H).all(-1).all(-1)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    U, _, Vt = torch.linalg.svd(torch.where(bad[..., None, None], eye, H))
    V = Vt.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    d = _det3(V @ Ut)
    ones = torch.ones_like(d)
    R = (V * torch.stack([ones, ones, d], -1)[..., None, :]) @ Ut
    R = torch.where(bad[..., None, None], float("nan"), R)
    if with_scale:
        Rq2 = q2 @ R.transpose(-1, -2)
        num = (wq1 * Rq2).sum((-1, -2))
        wq2 = q2 if w is None else q2 * w[..., None]
        s = num / (wq2 * q2).sum((-1, -2)).clamp(min=1e-12)
    else:
        s = torch.ones(R.shape[:-2], dtype=R.dtype, device=R.device)
    t = c1[..., 0, :] - s[..., None] * (R @ c2[..., 0, :, None])[..., 0]
    return R, t, s
