"""Stereo feature depth: rectified row-band descriptor match + SAD refine
(port of frontend/stereo.py).

Frame::ComputeStereoMatches (reference: src/Frame.cc:501-675) over fixed
shapes. The association of every left keypoint with its best right
keypoint inside the row band, the octave band and the disparity range is
one call of ``ops.hamming.masked_best_two``: on the card the fused kernel
reduces each row of the N_left x N_right problem without writing the
distance matrix. Then one call of ``ops.sad.stereo_depth`` (one kernel
launch a pair on the card): an 11x11 SAD sweep over +-5 shifts with a
parabola (Frame.cc:586-643) over every level's keypoints at once, the
depth, and the median-SAD outlier sweep (Frame.cc:661-674).

The JAX package read its patches as one-hot matrix products; here they are
plain indexed reads of the same pixels.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import spans
from ..ops import hamming, image, orb, sad

W = sad.W  # SAD half-window (reference: const int w = 5, Frame.cc:593)
L = sad.L  # shift search range (reference: const int L = 5, Frame.cc:600)
TH_ORB = sad.TH_ORB  # (TH_HIGH + TH_LOW) / 2 (reference: Frame.cc:540)


class StereoDepth(NamedTuple):
    u_right: torch.Tensor  # [N] float32 refined right u, -1 if no match
    depth: torch.Tensor    # [N] float32 depth from disparity, -1 if no match


# the per-level block under the name the JAX package gives it
_sad_refine_block = sad.sad_refine_block


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
    sc = spans.to_device("association_mask.scales", scales, torch.float32,
                         ul.device)
    r_band = 2.0 * sc[feats_r.octave.long()][None, :]
    return (feats_l.valid[:, None] & feats_r.valid[None, :]
            & ((vr - vl).abs() <= r_band)
            & (oct_r >= oct_l - 1) & (oct_r <= oct_l + 1)
            & (ur >= ul - fx) & (ur <= ul))


def _stereo_depth(feats_l, feats_r, best_d, best_j, pyr_l, pyr_r, budgets,
                  scales, bf: float, fx: float, packed=None):
    """Everything after the association in one call of ops/sad.stereo_depth
    (one kernel launch on the card): (right u, depth), each [N], -1 where a
    left keypoint has none. ``packed``: the two pyramids already
    concatenated as ops/orb.pack gives them."""
    levels = orb.level_table(tuple(tuple(p.shape) for p in pyr_l),
                             tuple(budgets), tuple(scales))
    flat_l, flat_r = packed or (orb.pack(pyr_l), orb.pack(pyr_r))
    return sad.stereo_depth(flat_l, flat_r, levels, feats_l.xy, feats_r.xy,
                            best_d, best_j, bf, fx)


@spans.span("stereo.match")
def match_stereo(feats_l, feats_r, pyr_l, pyr_r, budgets, bf: float,
                 fx: float, packed=None) -> StereoDepth:
    """Row-band Hamming association + subpixel refinement + outlier sweep.

    feats_l / feats_r: FrameFeatures in the extractor's level-contiguous
    layout (``budgets`` slots per level); pyr_l / pyr_r: the pyramids they
    were extracted from, and ``packed`` optionally the same concatenated
    (ops/orb.pack). Returns each left feature's refined right coordinate
    and depth, -1 where it has none.
    """
    scales = image.level_scales(len(pyr_l))
    bf, fx = sad._f32(bf), sad._f32(fx)
    mask = association_mask(feats_l, feats_r, scales, fx)
    # a row without a candidate gives (BIG, column 0) and fails the
    # threshold, as the reference's 1e9 fill does
    best_d, best_j, _, _ = hamming.masked_best_two(feats_l.desc, feats_r.desc,
                                                   mask)
    return StereoDepth(*_stereo_depth(feats_l, feats_r, best_d, best_j,
                                      pyr_l, pyr_r, budgets, scales, bf, fx,
                                      packed))
