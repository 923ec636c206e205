"""Rotated-BRIEF descriptors at the exact keypoint angle (port of
ops/brief.py: ``descriptors``, here also ``descriptors_exact``, and
``descriptors_from_patches_exact``).

256 comparisons I(p_a) < I(p_b) on the blurred level image; each pattern
point is rotated by the keypoint's angle and rounded half-to-even,
row = round(px sin + py cos), col = round(px cos - py sin), and read with
a gather clamped to the image edge (the JAX package clamps its patch
reads the same way). Bit k of word w is comparison 32 w + k; words are
int32 holding the JAX package's uint32 patterns.

The sampling pattern, ``frontend/data/brief_pattern.npy`` of this package,
is a byte-for-byte copy of the JAX package's data file.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import consts

PATTERN_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "frontend", "data", "brief_pattern.npy")
PATTERN = np.load(PATTERN_PATH).astype(np.float32)  # [256, 4] (ax, ay, bx, by)
BRIEF_RADIUS = 19


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[N, 256] bool -> [N, 8] int32 words (bit k of word w = bit 32 w + k)."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.reshape(-1, 8, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def _rotated_offsets(angle: torch.Tensor, px: torch.Tensor,
                     py: torch.Tensor):
    """[N, 256] (row, col) offsets of pattern points (px, py) rotated by
    each keypoint's angle and rounded half-to-even, within +-BRIEF_RADIUS."""
    ca = torch.cos(angle)[:, None]
    sa = torch.sin(angle)[:, None]
    r = torch.round(px[None, :] * sa + py[None, :] * ca).long()
    c = torch.round(px[None, :] * ca - py[None, :] * sa).long()
    return (r.clamp(-BRIEF_RADIUS, BRIEF_RADIUS),
            c.clamp(-BRIEF_RADIUS, BRIEF_RADIUS))


def descriptors_exact(blurred: torch.Tensor, yx: torch.Tensor,
                      angle: torch.Tensor) -> torch.Tensor:
    """blurred [H, W], yx [N, 2] int (row, col), angle [N] -> [N, 8] int32."""
    h, w = blurred.shape
    pat = consts.on_device("brief.PATTERN", PATTERN, blurred.device)
    y0 = yx[:, 0:1].long()
    x0 = yx[:, 1:2].long()

    def sample(px, py):
        r, c = _rotated_offsets(angle, px, py)
        return blurred[(y0 + r).clamp(0, h - 1), (x0 + c).clamp(0, w - 1)]

    va = sample(pat[:, 0], pat[:, 1])
    vb = sample(pat[:, 2], pat[:, 3])
    return pack_bits(va < vb)


def descriptors(blurred: torch.Tensor, yx: torch.Tensor,
                angle: torch.Tensor) -> torch.Tensor:
    """The JAX package's name for descriptors_exact: ORB descriptors of
    keypoints yx [N, 2] (row, col) at angle [N] on the blurred level."""
    return descriptors_exact(blurred, yx, angle)


def descriptors_from_patches_exact(patches: torch.Tensor,
                                   angle: torch.Tensor) -> torch.Tensor:
    """ORB descriptors from each keypoint's own blurred window: patches
    [N, P*P] float32 (P = 2 * BRIEF_RADIUS + 1, centered on the keypoint),
    angle [N] radians -> [N, 8] int32, sampled at the same rotated
    offsets as descriptors_exact."""
    p = 2 * BRIEF_RADIUS + 1
    pat = consts.on_device("brief.PATTERN", PATTERN, patches.device)

    def sample(px, py):
        r, c = _rotated_offsets(angle, px, py)
        idx = (r + BRIEF_RADIUS) * p + (c + BRIEF_RADIUS)
        return torch.take_along_dim(patches, idx, dim=1)

    va = sample(pat[:, 0], pat[:, 1])
    vb = sample(pat[:, 2], pat[:, 3])
    return pack_bits(va < vb)
