"""Block-Jacobi preconditioned conjugate gradients, the inner solver of
ba_solve_cg and optimize_pose_graph_cg."""
from __future__ import annotations

import torch


def block_pcg(matvec, Minv: torch.Tensor, rhs: torch.Tensor,
              iters: int) -> torch.Tensor:
    """``iters`` iterations of conjugate gradients on A x = rhs from x = 0,
    for x, rhs [B, n], A given as ``matvec`` and the preconditioner as the
    inverse diagonal blocks ``Minv`` [B, n, n]. The count is fixed: no
    early exit, so the work does not depend on the data."""
    x = torch.zeros_like(rhs)
    r = rhs
    z = p = (Minv @ r[..., None])[..., 0]
    rz = (r * z).sum()
    for _ in range(iters):
        Ap = matvec(p)
        pAp = (p * Ap).sum()
        alpha = rz / torch.where(pAp.abs() < 1e-20, 1e-20, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = (Minv @ r[..., None])[..., 0]
        rz_new = (r * z).sum()
        p = z + rz_new / torch.where(rz.abs() < 1e-20, 1e-20, rz) * p
        rz = rz_new
    return x
