"""Matching primitives shared by every search mode (port of matching/core.py).

Every mode is a masked dense [queries x targets] Hamming problem: a
candidate mask from vectorized window / level / chi2 gates, then the fused
masked best-two of ops/hamming.py, the ratio test, the rotation-histogram
consistency check and many-to-one collision resolution. Constants follow
the reference (ORBmatcher.cc:37-39, 1854-1895).
"""
from __future__ import annotations

import math

import torch

from ..ops import hamming
from ..ops.fast import sort_top_k

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
BIG = hamming.BIG


def masked_best_two(dist: torch.Tensor, mask: torch.Tensor):
    """Row-wise best and second-best of a distance matrix already computed,
    dist [Q, N] int32, over the candidates of mask [Q, N] bool: (best, idx,
    second), masked entries counted as BIG (the searches themselves call
    the fused hamming.masked_best_two)."""
    d = torch.where(mask, dist, BIG)
    best, idx = d.min(1)
    cols = torch.arange(d.shape[1], device=d.device)
    second = torch.where(cols == idx[:, None], BIG, d).amin(1)
    return best, idx.to(torch.int32), second


def ratio_ok(best: torch.Tensor, second: torch.Tensor, ratio: float):
    """Lowe-style test as the reference uses it: best < ratio * second."""
    return best.float() < ratio * second.float()


def rotation_bins(angle_q: torch.Tensor, angle_t: torch.Tensor):
    """30-bin histogram index of the angle difference (radians in)."""
    rot = (angle_q - angle_t) * (180.0 / math.pi)
    rot = torch.where(rot < 0, rot + 360.0, rot)
    b = torch.round(rot * (HISTO_LENGTH / 360.0)).to(torch.int32)
    return torch.where(b == HISTO_LENGTH, 0, b)


def rotation_consistency(bins: torch.Tensor, matched: torch.Tensor):
    """Keep matches whose rotation bin is among the top-3 bins; bins 2 and 3
    only when they hold at least 0.1x bin 1's count."""
    hist = torch.arange(HISTO_LENGTH, device=bins.device)
    counts = ((bins[:, None] == hist) & matched[:, None]).sum(0)
    top_v, top_i = sort_top_k(counts, 3)
    keep1 = bins == top_i[0]
    keep2 = (bins == top_i[1]) & (top_v[1] >= 0.1 * top_v[0])
    keep3 = (bins == top_i[2]) & (top_v[2] >= 0.1 * top_v[0])
    return matched & (keep1 | keep2 | keep3)


def dedupe_matches(idx: torch.Tensor, dist: torch.Tensor,
                   matched: torch.Tensor, n_targets: int):
    """Many-to-one collisions: keep the lowest-distance query per target,
    exact ties to the lowest query index."""
    d = torch.where(matched, dist, BIG)
    tgt = torch.where(matched, idx, n_targets).long()
    int_max = torch.iinfo(torch.int32).max
    best_per_tgt = torch.full((n_targets + 1,), int_max, dtype=d.dtype,
                              device=d.device).scatter_reduce(
        0, tgt, d, "amin")
    is_best = matched & (d == best_per_tgt[tgt])
    q_ids = torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device)
    first_q = torch.full((n_targets + 1,), int_max, dtype=torch.int32,
                         device=idx.device).scatter_reduce(
        0, tgt, torch.where(is_best, q_ids, 2 ** 30), "amin")
    return is_best & (q_ids == first_q[tgt])


def windowed_match(desc_q, desc_t, cand_mask, max_dist: int,
                   ratio: float | None = None, angle_q=None, angle_t=None,
                   dedupe: bool = True):
    """One-direction matcher: (idx [Q] target per query, dist [Q],
    matched [Q] bool)."""
    best, idx, second, _ = hamming.masked_best_two(desc_q, desc_t, cand_mask)
    matched = best <= max_dist
    if ratio is not None:
        matched &= ratio_ok(best, second, ratio)
    if angle_q is not None:
        matched = rotation_consistency(
            rotation_bins(angle_q, angle_t[idx]), matched)
    if dedupe:
        matched = dedupe_matches(idx, best, matched, desc_t.shape[0])
    return idx, best, matched
