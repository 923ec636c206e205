"""Rotated-BRIEF descriptors at the exact keypoint angle (port of
ops/brief.py: descriptors_from_patches_exact).

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


def descriptors_exact(blurred: torch.Tensor, yx: torch.Tensor,
                      angle: torch.Tensor) -> torch.Tensor:
    """blurred [H, W], yx [N, 2] int (row, col), angle [N] -> [N, 8] int32."""
    h, w = blurred.shape
    pat = torch.as_tensor(PATTERN, device=blurred.device)
    ca = torch.cos(angle)[:, None]
    sa = torch.sin(angle)[:, None]
    y0 = yx[:, 0:1].long()
    x0 = yx[:, 1:2].long()

    def sample(px, py):
        r = torch.round(px[None, :] * sa + py[None, :] * ca).long()
        c = torch.round(px[None, :] * ca - py[None, :] * sa).long()
        r = r.clamp(-BRIEF_RADIUS, BRIEF_RADIUS)
        c = c.clamp(-BRIEF_RADIUS, BRIEF_RADIUS)
        return blurred[(y0 + r).clamp(0, h - 1), (x0 + c).clamp(0, w - 1)]

    va = sample(pat[:, 0], pat[:, 1])
    vb = sample(pat[:, 2], pat[:, 3])
    return pack_bits(va < vb)
