"""Image pyramid and Gaussian blur (port of ops/image.py).

The pyramid reproduces ``jax.image.resize(..., "bilinear")``, which
antialiases when it downsamples: a triangle filter stretched by the scale
factor, normalized per output sample, applied as two matrix products
(rows first, then columns). ``F.interpolate`` computes something else.
Images are [H, W] float32 in [0, 255].
"""
from __future__ import annotations

import numpy as np
import torch

SCALE_FACTOR = 1.2
N_LEVELS = 8


def level_scales(n_levels: int = N_LEVELS,
                 scale_factor: float = SCALE_FACTOR) -> list[float]:
    """Per-level scale 1.2^l as Python floats."""
    return [scale_factor ** i for i in range(n_levels)]


def level_sizes(h: int, w: int, n_levels: int = N_LEVELS,
                scale_factor: float = SCALE_FACTOR) -> list[tuple[int, int]]:
    """(h, w) per level, rounded like the reference's cvRound."""
    return [(int(round(h / s)), int(round(w / s)))
            for s in level_scales(n_levels, scale_factor)]


def resize_weights(in_size: int, out_size: int,
                   device: torch.device) -> torch.Tensor:
    """[in_size, out_size] antialiased triangle-filter weights (float32).

    Follows the arithmetic XLA's CPU compiler emits for jax.image.resize:
    the sample position as one fused multiply-add and the division by the
    kernel scale as a multiplication by its float32 reciprocal. The weights
    then agree with the JAX package's to about one float32 ulp.
    """
    inv_scale = float(np.float32(1.0 / (out_size / in_size)))
    inv_kernel_scale = float(np.float32(1.0) / np.float32(max(inv_scale, 1.0)))
    f32 = torch.float32
    half = torch.arange(out_size, dtype=f32, device=device) + 0.5
    sample_f = (half.double() * inv_scale - 0.5).to(f32)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32, device=device)
         [:, None]).abs() * inv_kernel_scale
    weights = (1.0 - x.abs()).clamp(min=0.0)
    total = weights.sum(0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize of [H, W] to ``size``."""
    h, w = img.shape
    wy = resize_weights(h, size[0], img.device)
    wx = resize_weights(w, size[1], img.device)
    return (wy.T @ img) @ wx


def build_pyramid(img: torch.Tensor, n_levels: int = N_LEVELS,
                  scale_factor: float = SCALE_FACTOR) -> list[torch.Tensor]:
    """Level l is resized from level l-1 (the reference's cv::resize chain)."""
    sizes = level_sizes(*img.shape, n_levels, scale_factor)
    pyr = [img]
    for lvl in range(1, n_levels):
        pyr.append(resize(pyr[-1], sizes[lvl]))
    return pyr


def gaussian_kernel1d(ksize: int = 7, sigma: float = 2.0,
                      device=None) -> torch.Tensor:
    r = ksize // 2
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, ksize: int = 7,
                  sigma: float = 2.0) -> torch.Tensor:
    """Separable blur with edge padding, as explicit shifted sums (no
    convolution library, so no TF32 path)."""
    k = gaussian_kernel1d(ksize, sigma).tolist()
    r = ksize // 2
    h, w = img.shape
    x = torch.cat([img[:1].expand(r, w), img, img[-1:].expand(r, w)], 0)
    acc = 0.0
    for i in range(ksize):
        acc = acc + k[i] * x[i:i + h]
    x = torch.cat([acc[:, :1].expand(h, r), acc, acc[:, -1:].expand(h, r)], 1)
    acc = 0.0
    for i in range(ksize):
        acc = acc + k[i] * x[:, i:i + w]
    return acc


def shifted(img: torch.Tensor, dy: int, dx: int, pad: int) -> torch.Tensor:
    """out[y, x] = img[y + dy, x + dx], zero outside the image."""
    h, w = img.shape
    p = torch.nn.functional.pad(img, (pad, pad, pad, pad))
    return p[pad + dy:pad + dy + h, pad + dx:pad + dx + w]
