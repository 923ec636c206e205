"""Two-view triangulation, batched (port of geometry/triangulate.py).

DLT triangulation as in LocalMapping::CreateNewMapPoints (reference:
LocalMapping.cc:442-457) and Initializer::Triangulate (Initializer.cc:
752-765), over a batch of candidate pairs.
"""
from __future__ import annotations

import torch


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor,
                    x2: torch.Tensor) -> torch.Tensor:
    """P1, P2 [..., 3, 4] projection matrices K [R|t], x1, x2 [..., 2]
    pixels -> world points [..., 3]: the eigenvector of A^T A with the
    least eigenvalue, divided by its last coordinate (which divides the
    eigenvector's arbitrary sign out)."""
    A = torch.stack([
        x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :]], -2)
    AtA = A.transpose(-1, -2) @ A
    bad = ~torch.isfinite(AtA).all(-1).all(-1)
    eye = torch.eye(4, dtype=AtA.dtype, device=AtA.device)
    _, V = torch.linalg.eigh(torch.where(bad[..., None, None], eye, AtA))
    X = torch.where(bad[..., None], float("nan"), V[..., :, 0])
    w = X[..., 3]
    w = torch.where(w.abs() < 1e-12, 1e-12, w)
    return X[..., :3] / w[..., None]


def rays_parallax_cos(C1: torch.Tensor, C2: torch.Tensor,
                      X: torch.Tensor) -> torch.Tensor:
    """Cosine of the angle between the rays C1->X and C2->X (reference:
    LocalMapping.cc:401-440, Initializer.cc:865-875)."""
    r1 = X - C1
    r2 = X - C2
    n1 = torch.linalg.norm(r1, dim=-1).clamp(min=1e-12)
    n2 = torch.linalg.norm(r2, dim=-1).clamp(min=1e-12)
    return (r1 * r2).sum(-1) / (n1 * n2)
