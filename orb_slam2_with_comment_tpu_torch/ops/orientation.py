"""IC-angle keypoint orientation (port of ops/orientation.py).

The intensity-centroid angle over the radius-15 circular patch whose row
extents come from the reference's symmetric umax table; the 31x31 patch is
read with native gathers, clamped to the image edge.
"""
from __future__ import annotations

import numpy as np
import torch

HALF_PATCH = 15


def _umax_table() -> np.ndarray:
    """Circle row half-widths, replicating the reference's symmetric table."""
    umax = np.zeros(HALF_PATCH + 1, np.int32)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    hp2 = HALF_PATCH * HALF_PATCH
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


UMAX = _umax_table()


def moment_kernel_matrix() -> np.ndarray:
    """[31*31, 2] flat (m10, m01) weights: x and y inside the circle."""
    size = 2 * HALF_PATCH + 1
    k10 = np.zeros((size, size), np.float32)
    k01 = np.zeros((size, size), np.float32)
    for v in range(-HALF_PATCH, HALF_PATCH + 1):
        half = UMAX[abs(v)]
        for u in range(-half, half + 1):
            k10[v + HALF_PATCH, u + HALF_PATCH] = u
            k01[v + HALF_PATCH, u + HALF_PATCH] = v
    return np.stack([k10.reshape(-1), k01.reshape(-1)], 1)


_KMAT = moment_kernel_matrix()


def gather_patches(img: torch.Tensor, yx: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """[N, P, P] windows of img around yx (row, col), clamped to the edge."""
    h, w = img.shape
    d = torch.arange(-radius, radius + 1, device=img.device)
    rows = (yx[:, 0:1].long() + d).clamp(0, h - 1)
    cols = (yx[:, 1:2].long() + d).clamp(0, w - 1)
    return img[rows[:, :, None], cols[:, None, :]]


def ic_angles(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Orientation (radians) of keypoints yx [N, 2] on a level image."""
    n = yx.shape[0]
    kmat = torch.as_tensor(_KMAT, device=img.device)
    mom = gather_patches(img, yx, HALF_PATCH).reshape(n, -1) @ kmat
    return torch.atan2(mom[:, 1], mom[:, 0])
