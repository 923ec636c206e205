"""ORB extraction: pyramid -> FAST -> orientation -> BRIEF (port of
frontend/extractor.py).

8-level 1.2x pyramid, per-level FAST with the 20 -> 7 per-cell fallback and
spatial round-robin selection, IC angle, 7x7 sigma=2 blur rounded to
integers, exact-angle rotated BRIEF, and a subpixel parabola on the score
map. Each level contributes a fixed budget of keypoint slots; unused slots
are marked invalid.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import brief, fast, image, orientation


class FrameFeatures(NamedTuple):
    """Fixed-size feature bundle for one image."""
    xy: torch.Tensor  # [N, 2] float32 (x=col, y=row) in level-0 pixels
    response: torch.Tensor  # [N] float32 FAST score
    octave: torch.Tensor  # [N] int32 pyramid level
    angle: torch.Tensor  # [N] float32 radians
    desc: torch.Tensor  # [N, 8] int32 packed 256-bit
    valid: torch.Tensor  # [N] bool


def level_budgets(n_features: int, n_levels: int = image.N_LEVELS,
                  scale_factor: float = image.SCALE_FACTOR) -> list[int]:
    """Geometric per-level budgets summing to n_features (reference:
    ORBextractor.cc:437-446)."""
    factor = 1.0 / scale_factor
    first = n_features * (1 - factor) / (1 - factor ** n_levels)
    out = [int(round(first * factor ** i)) for i in range(n_levels - 1)]
    out.append(max(n_features - sum(out), 0))
    return out


class OrbExtractor:
    def __init__(self, n_features: int = 1000, n_levels: int = image.N_LEVELS,
                 scale_factor: float = image.SCALE_FACTOR,
                 th_high: float = 20.0, th_low: float = 7.0,
                 cell: int = 32, per_cell: int = 8, margin: int = 16):
        self.n_features = n_features
        self.n_levels = n_levels
        self.scale_factor = scale_factor
        self.th_high = th_high
        self.th_low = th_low
        self.cell = cell
        self.per_cell = per_cell
        self.margin = margin
        self.budgets = level_budgets(n_features, n_levels, scale_factor)
        self.scales = image.level_scales(n_levels, scale_factor)

    def __call__(self, img: torch.Tensor) -> FrameFeatures:
        return self._extract(img)

    def stereo(self, img_l: torch.Tensor, img_r: torch.Tensor, bf: float,
               fx: float):
        """Extract the left and right features of a rectified pair and
        associate them along the rows (frontend/stereo.py). Returns (left
        FrameFeatures, StereoDepth)."""
        from . import stereo as _stereo
        # one pyramid per view, shared by the extraction and the SAD
        # refinement; left then right
        pyr_l = self._pyramid(img_l)
        pyr_r = self._pyramid(img_r)
        feats_l = self._extract_from_pyramid(pyr_l)
        feats_r = self._extract_from_pyramid(pyr_r)
        sd = _stereo.match_stereo(feats_l, feats_r, pyr_l, pyr_r,
                                  self.budgets, bf, fx)
        return feats_l, sd

    def _pyramid(self, img: torch.Tensor) -> list[torch.Tensor]:
        return image.build_pyramid(img.to(torch.float32), self.n_levels,
                                   self.scale_factor)

    def _extract(self, img: torch.Tensor) -> FrameFeatures:
        return self._extract_from_pyramid(self._pyramid(img))

    def _extract_from_pyramid(self, pyr) -> FrameFeatures:
        parts = [self._level_features(lvl_img, lvl, budget)
                 for lvl, (lvl_img, budget) in enumerate(zip(pyr, self.budgets))
                 if budget > 0]
        return FrameFeatures(*(torch.cat(p) for p in zip(*parts)))

    def _level_features(self, lvl_img: torch.Tensor, lvl: int, budget: int):
        h, w = lvl_img.shape
        m = self.margin
        score = fast.fast_score_map(lvl_img)
        inner = torch.zeros_like(score)
        inner[m:h - m, m:w - m] = score[m:h - m, m:w - m]
        score = inner
        yx, resp, valid = fast.select_keypoints(
            score, budget, self.cell, self.per_cell, self.th_high,
            self.th_low)
        blurred = torch.round(image.gaussian_blur(lvl_img))
        ang = orientation.ic_angles(lvl_img, yx)
        desc = brief.descriptors_exact(blurred, yx, ang)
        sp = orientation.gather_patches(score, yx, 1)
        c = sp[:, 1, 1]
        up, dn = sp[:, 0, 1], sp[:, 2, 1]
        lf, rt = sp[:, 1, 0], sp[:, 1, 2]
        den_y = up - 2 * c + dn
        den_x = lf - 2 * c + rt
        sub_dy = (0.5 * (up - dn) / torch.where(
            den_y.abs() < 1e-6, 1e-6, den_y)).clamp(-0.5, 0.5)
        sub_dx = (0.5 * (lf - rt) / torch.where(
            den_x.abs() < 1e-6, 1e-6, den_x)).clamp(-0.5, 0.5)
        scale = self.scales[lvl]
        xy0 = torch.stack([(yx[:, 1].float() + sub_dx) * scale,
                           (yx[:, 0].float() + sub_dy) * scale], -1)
        octv = torch.full((budget,), lvl, dtype=torch.int32,
                          device=lvl_img.device)
        return xy0, resp, octv, ang, desc, valid
