"""FAST-9/16 corner scores, 3x3 NMS and keypoint selection (port of
ops/fast.py).

The score is OpenCV's: the largest threshold t at which a 9-contiguous
arc of the radius-3 ring is all brighter (or all darker) than the center
by t. Selection keeps the per-cell 20 -> 7 threshold fallback, the top
``per_cell`` corners per 32 px cell, and a spatial round-robin global top-k
(every cell's best before any cell's second-best). Ties break by the lower
index, as the JAX package's stable sort does.
"""
from __future__ import annotations

import torch

from .image import shifted

CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def sort_top_k(v: torch.Tensor, k: int):
    """Descending top-k along the last axis; ties keep the lower index."""
    idx = torch.argsort(-v, dim=-1, stable=True)[..., :k]
    return torch.gather(v, -1, idx), idx


def _min_window9(d: torch.Tensor) -> torch.Tensor:
    """out[i] = min(d[i], ..., d[i+8 mod 16]) along axis 0 of [16, H, W]."""
    m2 = torch.minimum(d, torch.roll(d, -1, 0))
    m4 = torch.minimum(m2, torch.roll(m2, -2, 0))
    m8 = torch.minimum(m4, torch.roll(m4, -4, 0))
    return torch.minimum(m8, torch.roll(d, -8, 0))


def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    """[H, W] float -> FAST score map, zero in the 3 px frame."""
    ring = torch.stack([shifted(img, dy, dx, 3) for dy, dx in CIRCLE])
    d = ring - img[None]
    bright = _min_window9(d).amax(0)
    dark = _min_window9(-d).amax(0)
    score = torch.maximum(bright, dark).clamp(min=0.0)
    h, w = img.shape
    out = torch.zeros_like(score)
    out[3:h - 3, 3:w - 3] = score[3:h - 3, 3:w - 3]
    return out


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep strict 3x3 local maxima; zero elsewhere."""
    neigh = torch.stack([shifted(score, dy, dx, 1)
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                         if dy or dx])
    return torch.where(score > neigh.amax(0), score, 0.0)


def cell_candidates(score: torch.Tensor, cell: int = 32, per_cell: int = 4,
                    th_high: float = 20.0, th_low: float = 7.0):
    """Each cell's best ``per_cell`` corners of the 3x3-NMS'd score map,
    kept above th_high, or th_low where the cell's maximum is not above
    th_high; cells tile the map zero-padded to a multiple of ``cell``.
    Returns (values [cy, cx, per_cell] descending, zero where fewer are
    kept; their row-major in-cell indices [cy, cx, per_cell] int64, ties
    to the lower index)."""
    h, w = score.shape
    s = nms3x3(score)
    ph, pw = (-h) % cell, (-w) % cell
    s = torch.nn.functional.pad(s, (0, pw, 0, ph))
    cy, cx = (h + ph) // cell, (w + pw) // cell
    cells = s.reshape(cy, cell, cx, cell).permute(0, 2, 1, 3).reshape(
        cy, cx, cell * cell)
    cell_max = cells.amax(-1, keepdim=True)
    th = torch.where(cell_max > th_high, th_high, th_low)
    keep = torch.where(cells > th, cells, 0.0)
    return sort_top_k(keep, per_cell)


def select_from_candidates(top_v: torch.Tensor, top_i: torch.Tensor,
                           n_max: int, cell: int = 32):
    """Spatial round-robin global top-n_max of cell_candidates' output:
    every cell's best before any cell's second-best. Returns (yx [n_max,
    2] int32, resp [n_max], valid [n_max] bool)."""
    cy, cx, per_cell = top_v.shape
    dev = top_v.device
    cyi = torch.arange(cy, device=dev)[:, None, None]
    cxi = torch.arange(cx, device=dev)[None, :, None]
    flat_v = top_v.reshape(-1)
    flat_y = (cyi * cell + top_i // cell).reshape(-1)
    flat_x = (cxi * cell + top_i % cell).reshape(-1)
    rank = torch.arange(per_cell, device=dev).expand(cy, cx, per_cell)
    sel_key = flat_v - rank.reshape(-1).to(flat_v.dtype) * 1e7
    k = min(n_max, flat_v.shape[0])
    _, gi = sort_top_k(sel_key, k)
    gv = flat_v[gi]
    yx = torch.stack([flat_y[gi], flat_x[gi]], -1).to(torch.int32)
    valid = gv > 0.0
    if k < n_max:
        pad = n_max - k
        gv = torch.cat([gv, gv.new_zeros(pad)])
        yx = torch.cat([yx, yx.new_zeros(pad, 2)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return yx, gv, valid


def select_keypoints(score: torch.Tensor, n_max: int, cell: int = 32,
                     per_cell: int = 4, th_high: float = 20.0,
                     th_low: float = 7.0):
    """Returns (yx [n_max, 2] int32, resp [n_max], valid [n_max] bool)."""
    top_v, top_i = cell_candidates(score, cell, per_cell, th_high, th_low)
    return select_from_candidates(top_v, top_i, n_max, cell)


def subpixel_refine(score: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Sub-pixel corner offsets [N, 2] (dy, dx) in [-0.5, 0.5] from a 1D
    parabola per axis through the score map at keypoints yx [N, 2] (row,
    col), the neighbours clamped to the map's edge."""
    h, w = score.shape
    y = yx[:, 0].long()
    x = yx[:, 1].long()

    def at(dy, dx):
        return score[(y + dy).clamp(0, h - 1), (x + dx).clamp(0, w - 1)]

    c = at(0, 0)
    up, dn, lf, rt = at(-1, 0), at(1, 0), at(0, -1), at(0, 1)
    den_y = up - 2 * c + dn
    den_x = lf - 2 * c + rt
    dy = 0.5 * (up - dn) / torch.where(den_y.abs() < 1e-6, 1e-6, den_y)
    dx = 0.5 * (lf - rt) / torch.where(den_x.abs() < 1e-6, 1e-6, den_x)
    return torch.stack([dy.clamp(-0.5, 0.5), dx.clamp(-0.5, 0.5)], -1)
