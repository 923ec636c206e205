"""Sim3 RANSAC for the loop closer's relative pose (port of
solvers/sim3solver.py).

Sim3Solver (reference: Sim3Solver.cc:37-220) as one batch: every 3-point
hypothesis is Horn-solved and scored with the two-sided reprojection chi2
gate (9.210 sigma^2 per image, :51-52, 87-88) at once. Sampling is split
from solving: ``sample_triplets`` draws from a ``torch.Generator``, and
``solve_from_samples`` takes any [T, 3] index set.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import horn

CHI2_SIM3 = 9.210


class Sim3RansacResult(NamedTuple):
    R: torch.Tensor  # [3, 3] R12 (camera-2 points into camera 1)
    t: torch.Tensor  # [3]
    s: torch.Tensor  # []
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor  # [] int32


def gumbel(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)) drawn from ``gen``."""
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))


def sample_triplets(gen: torch.Generator, valid: torch.Tensor,
                    max_iters: int) -> torch.Tensor:
    """[max_iters, 3] indices drawn uniformly from the valid slots, with
    replacement (Gumbel-max over log-probabilities, as
    jax.random.categorical draws); with no valid slot, uniform over all."""
    probs = valid.float() / valid.sum().clamp(min=1)
    logits = torch.log(probs.clamp(min=1e-12))
    g = gumbel(gen, (max_iters * 3, valid.shape[0]), valid.device)
    return torch.argmax(logits + g, -1).reshape(max_iters, 3)


def _project(K, Xc):
    fx, fy, cx, cy = K
    z = Xc[..., 2].clamp(min=1e-6)
    return torch.stack([fx * Xc[..., 0] / z + cx, fy * Xc[..., 1] / z + cy],
                       -1)


def solve_from_samples(idx, K1, K2, X1, X2, uv1, uv2, sigma2_1, sigma2_2,
                       valid, min_inliers: int = 20,
                       fix_scale: bool = False) -> Sim3RansacResult:
    """Horn-solve every hypothesis idx [T, 3], score all of them against
    every correspondence, return the first best model and its inliers."""
    T = idx.shape[0]
    R, t, s = horn.solve(X1[idx], X2[idx], with_scale=not fix_scale)
    if fix_scale:
        s = torch.ones(T, dtype=X1.dtype, device=X1.device)
    X2in1 = s[:, None, None] * torch.einsum("tij,nj->tni", R, X2) + t[:, None]
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s.clamp(min=1e-9)
    t_inv = -s_inv[:, None] * (Rt @ t[..., None])[..., 0]
    X1in2 = (s_inv[:, None, None] * torch.einsum("tij,nj->tni", Rt, X1)
             + t_inv[:, None])
    e1 = _project(K1, X2in1) - uv1[None]
    e2 = _project(K2, X1in2) - uv2[None]
    c1 = (e1 * e1).sum(-1) / sigma2_1.clamp(min=1e-9)[None]
    c2 = (e2 * e2).sum(-1) / sigma2_2.clamp(min=1e-9)[None]
    inlier = (c1 < CHI2_SIM3) & (c2 < CHI2_SIM3) & valid[None]
    counts = inlier.sum(1, dtype=torch.int32)
    best = torch.argmax(counts)
    ok = counts[best] >= min_inliers
    return Sim3RansacResult(R[best], t[best], s[best], inlier[best] & ok,
                            torch.where(ok, counts[best], 0))


def solve_ransac(gen: torch.Generator, K1, K2, X1, X2, uv1, uv2, sigma2_1,
                 sigma2_2, valid, max_iters: int = 300, min_inliers: int = 20,
                 fix_scale: bool = False) -> Sim3RansacResult:
    """Sample ``max_iters`` triplets from ``gen``, then solve_from_samples.
    X1/X2 [N, 3] matched points in the camera-1/camera-2 frames, uv1/uv2
    [N, 2] their pixels, sigma2_* [N] level variances, valid [N]."""
    idx = sample_triplets(gen, valid, max_iters)
    return solve_from_samples(idx, K1, K2, X1, X2, uv1, uv2, sigma2_1,
                              sigma2_2, valid, min_inliers, fix_scale)
