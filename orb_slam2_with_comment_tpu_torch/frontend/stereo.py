"""Stereo feature depth: rectified row-band descriptor match + SAD refine
(port of frontend/stereo.py).

Frame::ComputeStereoMatches (reference: src/Frame.cc:501-675) over fixed
shapes. The association of every left keypoint with its best right
keypoint inside the row band, the octave band and the disparity range is
one call of ``ops.hamming.masked_best_two``: on the card the fused kernel
reduces each row of the N_left x N_right problem without writing the
distance matrix. Then an 11x11 SAD sweep over +-5 shifts with a parabola
(Frame.cc:586-643), per pyramid level over the extractor's
level-contiguous keypoint blocks, and the median-SAD outlier sweep
(Frame.cc:661-674).

The JAX package read its patches as one-hot matrix products; here they are
plain indexed reads of the same pixels.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import hamming, image

W = 5            # SAD half-window (reference: const int w = 5, Frame.cc:593)
L = 5            # shift search range (reference: const int L = 5, Frame.cc:600)
TH_ORB = 75      # (TH_HIGH + TH_LOW) / 2 (reference: Frame.cc:540)


class StereoDepth(NamedTuple):
    u_right: torch.Tensor  # [N] float32 refined right u, -1 if no match
    depth: torch.Tensor    # [N] float32 depth from disparity, -1 if no match


def _f32(x: float) -> float:
    """A Python scalar rounded to float32, as JAX weakly types it."""
    return float(np.float32(x))


def _sad_refine_block(pyr_l: torch.Tensor, pyr_r: torch.Tensor,
                      inv_scale: float, xy_l: torch.Tensor,
                      u_r0: torch.Tensor):
    """Subpixel correlation for one pyramid level's keypoint block.

    Returns (refined right u in level pixels, best SAD, ok): the strip lies
    inside the image, the best shift is not at the search edge and the
    parabola's vertex within one pixel (reference Frame.cc:611-636).
    """
    h, w = pyr_l.shape
    inv = _f32(inv_scale)
    ur0 = torch.round(u_r0 * inv)
    yi = torch.round(xy_l[:, 1] * inv).to(torch.int64)
    xi = torch.round(xy_l[:, 0] * inv).to(torch.int64)
    uri = ur0.to(torch.int64)
    # a window that would leave the image is shifted back inside
    yc = (yi - W).clamp(0, h - (2 * W + 1)) + W
    xc = (xi - W).clamp(0, w - (2 * W + 1)) + W
    off = torch.arange(-W, W + 1, device=pyr_l.device)
    rows = (yc[:, None] + off[None, :])[:, :, None]
    p_l = pyr_l[rows, (xc[:, None] + off[None, :])[:, None, :]]  # [N,11,11]
    p_l = p_l - p_l[:, W:W + 1, W:W + 1]
    x0 = uri - W - L
    span = 2 * W + 2 * L + 1
    inb = (x0 >= 0) & (x0 + span <= w)
    x0c = x0.clamp(0, w - span)
    cols = x0c[:, None] + torch.arange(span, device=pyr_l.device)[None, :]
    strip = pyr_r[rows, cols[:, None, :]]  # [N, 11, 21]
    win = strip.unfold(2, 2 * W + 1, 1)  # [N, 11 rows, 11 shifts, 11 cols]
    win = win - win[:, W:W + 1, :, W:W + 1]
    sad = (p_l[:, :, None, :] - win).abs().sum((1, 3))  # [N, 2L+1]
    best = torch.argmin(sad, dim=1)
    edge = (best == 0) | (best == 2 * L)
    b = best.clamp(1, 2 * L - 1)

    def take(i):
        return sad.gather(1, i[:, None])[:, 0]

    d1, d2, d3 = take(b - 1), take(b), take(b + 1)
    denom = d1 + d3 - 2.0 * d2
    delta = torch.where(denom > 0,
                        (d1 - d3) / (2.0 * denom.clamp(min=1e-9)), 2.0)
    ok = inb & ~edge & (delta.abs() <= 1.0)
    inc = (b.to(torch.float32) - L) + delta
    return ur0 + inc, take(best), ok


def association_mask(feats_l, feats_r, scales, fx: float) -> torch.Tensor:
    """[N_left, N_right] bool: both valid, the right keypoint within the
    row band 2 * scale[right octave] (reference Frame.cc:519), octaves
    within one level, disparity in [0, fx] (bf / b = fx, Frame.cc:530-533).
    """
    ul = feats_l.xy[:, 0][:, None]
    vl = feats_l.xy[:, 1][:, None]
    ur = feats_r.xy[None, :, 0]
    vr = feats_r.xy[None, :, 1]
    oct_l = feats_l.octave[:, None]
    oct_r = feats_r.octave[None, :]
    sc = torch.tensor(scales, dtype=torch.float32, device=ul.device)
    r_band = 2.0 * sc[feats_r.octave.long()][None, :]
    return (feats_l.valid[:, None] & feats_r.valid[None, :]
            & ((vr - vl).abs() <= r_band)
            & (oct_r >= oct_l - 1) & (oct_r <= oct_l + 1)
            & (ur >= ul - fx) & (ur <= ul))


def _sad_refine(feats_l, u_r0, pyr_l, pyr_r, budgets, scales):
    """Per-level refinement over the level-contiguous keypoint blocks:
    (right u in level-0 pixels, best SAD, ok), each [N]."""
    u_right, sad_best, ok_all = [], [], []
    off = 0
    for lvl, budget in enumerate(budgets):
        if budget <= 0:
            continue
        sl = slice(off, off + budget)
        ur_lvl, sad, ok = _sad_refine_block(
            pyr_l[lvl], pyr_r[lvl], 1.0 / scales[lvl], feats_l.xy[sl],
            u_r0[sl])
        u_right.append(ur_lvl * _f32(scales[lvl]))
        sad_best.append(sad)
        ok_all.append(ok)
        off += budget
    return torch.cat(u_right), torch.cat(sad_best), torch.cat(ok_all)


def match_stereo(feats_l, feats_r, pyr_l, pyr_r, budgets, bf: float,
                 fx: float) -> StereoDepth:
    """Row-band Hamming association + subpixel refinement + outlier sweep.

    feats_l / feats_r: FrameFeatures in the extractor's level-contiguous
    layout (``budgets`` slots per level); pyr_l / pyr_r: the pyramids they
    were extracted from. Returns each left feature's refined right
    coordinate and depth, -1 where it has none.
    """
    scales = image.level_scales(len(pyr_l))
    bf, fx = _f32(bf), _f32(fx)
    mask = association_mask(feats_l, feats_r, scales, fx)
    # a row without a candidate gives (BIG, column 0) and fails the
    # threshold, as the reference's 1e9 fill does
    best_d, best_j, _, _ = hamming.masked_best_two(feats_l.desc, feats_r.desc,
                                                   mask)
    matched = best_d < TH_ORB
    u_r0 = feats_r.xy[best_j.long(), 0]
    u_right, sad_best, ok_all = _sad_refine(feats_l, u_r0, pyr_l, pyr_r,
                                            budgets, scales)
    n = u_right.shape[0]
    good = matched & ok_all
    disparity = feats_l.xy[:, 0] - u_right
    # disparity <= 0 is clamped to a tiny positive value (reference :650-653)
    tiny = disparity <= 0
    disparity = torch.where(tiny, 0.01, disparity)
    u_right = torch.where(tiny, feats_l.xy[:, 0] - 0.01, u_right)
    good = good & (disparity < fx)
    # thDist = 1.5 * 1.4 * median(best SAD) (reference Frame.cc:661-674);
    # with no good match the median is inf and nothing more is rejected
    inf = float("inf")
    sad_sorted = torch.sort(torch.where(good, sad_best, inf)).values
    med = sad_sorted[(good.sum() // 2).clamp(0, n - 1)]
    good = good & (sad_best <= 1.5 * 1.4 * med)
    return StereoDepth(torch.where(good, u_right, -1.0),
                       torch.where(good, bf / disparity, -1.0))
