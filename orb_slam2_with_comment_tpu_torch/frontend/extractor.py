"""ORB extraction: pyramid -> FAST -> orientation -> BRIEF (port of
frontend/extractor.py).

8-level 1.2x pyramid, per-level FAST with the 20 -> 7 per-cell fallback and
spatial round-robin selection, IC angle, 7x7 sigma=2 blur rounded to
integers, exact-angle rotated BRIEF, and a subpixel parabola on the score
map. Each level contributes a fixed budget of keypoint slots; unused slots
are marked invalid. The pyramid is plain PyTorch (two matrix products a
level); everything after it runs in ops/orb.py, three kernel launches a
view on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import spans
from ..ops import brief, fast, image, orb, orientation


class FrameFeatures(NamedTuple):
    """Fixed-size feature bundle for one image."""
    xy: torch.Tensor  # [N, 2] float32 (x=col, y=row) in level-0 pixels
    response: torch.Tensor  # [N] float32 FAST score
    octave: torch.Tensor  # [N] int32 pyramid level
    angle: torch.Tensor  # [N] float32 radians
    desc: torch.Tensor  # [N, 8] int32 packed 256-bit
    valid: torch.Tensor  # [N] bool

    @property
    def n(self) -> int:
        return self.xy.shape[0]


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
    """Configured extractor. sigma2 and inv_sigma2 are the reference's
    mvLevelSigma2 and mvInvLevelSigma2 (sigma2 = 1.2^(2 level))."""

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
        self.sigma2 = [s * s for s in self.scales]
        self.inv_sigma2 = [1.0 / s for s in self.sigma2]

    def __call__(self, img: torch.Tensor) -> FrameFeatures:
        return self._extract(img)

    @spans.span("frontend")
    def stereo(self, img_l: torch.Tensor, img_r: torch.Tensor, bf: float,
               fx: float):
        """Extract the left and right features of a rectified pair and
        associate them along the rows (frontend/stereo.py). Returns (left
        FrameFeatures, StereoDepth)."""
        from . import stereo as _stereo
        # one pyramid per view, shared by the extraction and the SAD
        # refinement; left then right. Each is packed once, for the ORB
        # kernels and the SAD kernel both
        pyr_l = self._pyramid(img_l)
        pyr_r = self._pyramid(img_r)
        flat_l, flat_r = orb.pack(pyr_l), orb.pack(pyr_r)
        feats_l = self._extract_from_pyramid(pyr_l, flat_l)
        feats_r = self._extract_from_pyramid(pyr_r, flat_r)
        sd = _stereo.match_stereo(feats_l, feats_r, pyr_l, pyr_r,
                                  self.budgets, bf, fx, (flat_l, flat_r))
        return feats_l, sd

    @spans.span("frontend.pyramid")
    def _pyramid(self, img: torch.Tensor) -> list[torch.Tensor]:
        return image.build_pyramid(img.to(torch.float32), self.n_levels,
                                   self.scale_factor)

    def _extract(self, img: torch.Tensor) -> FrameFeatures:
        return self._extract_from_pyramid(self._pyramid(img))

    @spans.span("frontend.extract")
    def _extract_from_pyramid(self, pyr, flat=None) -> FrameFeatures:
        """Every level with a budget above 0 in one call of the ORB
        kernels (ops/orb.py: three launches on the card), concatenated in
        level order: what _level_features gives level by level. ``flat``:
        the pyramid already packed (orb.pack)."""
        return FrameFeatures(*orb.extract_levels(
            pyr, self.budgets, self.scales, self.margin, self.th_high,
            self.th_low, flat, self.cell, self.per_cell))

    def _level_features(self, lvl_img: torch.Tensor, lvl: int, budget: int):
        """One level's features with the per-level functions: the
        reference ops/orb.py's plain chain is held to."""
        score = orb.masked_score(lvl_img, self.margin)
        yx, resp, valid = fast.select_keypoints(
            score, budget, self.cell, self.per_cell, self.th_high,
            self.th_low)
        blurred = torch.round(image.gaussian_blur(lvl_img))
        ang = orientation.ic_angles(lvl_img, yx)
        desc = brief.descriptors_exact(blurred, yx, ang)
        sub = fast.subpixel_refine(score, yx)
        scale = self.scales[lvl]
        xy0 = torch.stack([(yx[:, 1].float() + sub[:, 1]) * scale,
                           (yx[:, 0].float() + sub[:, 0]) * scale], -1)
        octv = torch.full((budget,), lvl, dtype=torch.int32,
                          device=lvl_img.device)
        return xy0, resp, octv, ang, desc, valid
