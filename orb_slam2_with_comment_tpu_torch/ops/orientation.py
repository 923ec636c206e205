"""IC-angle keypoint orientation (port of ops/orientation.py).

The intensity-centroid angle over the radius-15 circular patch whose row
extents come from the reference's symmetric umax table; the 31x31 patch is
read with native gathers, clamped to the image edge (``ic_angles``, what
the extractor calls) or zero outside the image (the JAX package's public
helpers ``angles_at``, ``angles_at_patches`` and the whole-image moment maps
``orientation_maps``). The two agree for keypoints at least 15 px inside
the image, as the extractor's are.
"""
from __future__ import annotations

import numpy as np
import torch

from . import consts
from .image import conv2d_same

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


def moment_kernels() -> tuple[np.ndarray, np.ndarray]:
    """31x31 kernels K10[v, u] = u and K01[v, u] = v inside the circle."""
    size = 2 * HALF_PATCH + 1
    k10 = np.zeros((size, size), np.float32)
    k01 = np.zeros((size, size), np.float32)
    for v in range(-HALF_PATCH, HALF_PATCH + 1):
        half = UMAX[abs(v)]
        for u in range(-half, half + 1):
            k10[v + HALF_PATCH, u + HALF_PATCH] = u
            k01[v + HALF_PATCH, u + HALF_PATCH] = v
    return k10, k01


_K10, _K01 = moment_kernels()


def moment_kernel_matrix() -> np.ndarray:
    """[31*31, 2] flat (m10, m01) weights: x and y inside the circle."""
    return np.stack([_K10.reshape(-1), _K01.reshape(-1)], 1)


_KMAT = moment_kernel_matrix()


def gather_patches(img: torch.Tensor, yx: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """[N, P, P] windows of img around yx (row, col), clamped to the edge."""
    h, w = img.shape
    d = torch.arange(-radius, radius + 1, device=img.device)
    rows = (yx[:, 0:1].long() + d).clamp(0, h - 1)
    cols = (yx[:, 1:2].long() + d).clamp(0, w - 1)
    return img[rows[:, :, None], cols[:, None, :]]


def _patch_angles(patches: torch.Tensor) -> torch.Tensor:
    """atan2(m01, m10) of [N, 31, 31] patches."""
    kmat = consts.on_device("orientation.KMAT", _KMAT, patches.device)
    mom = patches.reshape(patches.shape[0], -1) @ kmat
    return torch.atan2(mom[:, 1], mom[:, 0])


def ic_angles(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Orientation (radians) of keypoints yx [N, 2] on a level image."""
    return _patch_angles(gather_patches(img, yx, HALF_PATCH))


def angles_at_patches(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Orientation (radians) of keypoints yx [N, 2] (row, col), the image
    read as zero outside its edge."""
    pad = torch.nn.functional.pad(img, (HALF_PATCH,) * 4)
    return ic_angles(pad, yx.long() + HALF_PATCH)


def angles_at(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Orientation (radians) of keypoints yx [N, 2] (row, col); the JAX
    package gathers it from the moment maps, the same sums."""
    return angles_at_patches(img, yx)


def orientation_maps(img: torch.Tensor):
    """Whole-image m10 and m01 moment maps ([H, W] each, zero padding)."""
    return (conv2d_same(img, consts.on_device("orientation.K10", _K10,
                                              img.device)),
            conv2d_same(img, consts.on_device("orientation.K01", _K01,
                                              img.device)))
