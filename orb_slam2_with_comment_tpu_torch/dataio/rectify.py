"""Stereo rectification: undistort-rectify map construction + bilinear remap
(port of dataio/rectify.py).

The reference's EuRoC online rectification (reference:
Examples/Stereo/stereo_euroc.cc:97-137: cv::initUndistortRectifyMap from
the YAML LEFT.K/D/R/P blocks, then cv::remap per frame). The maps are
built once with numpy on the host; the per-frame remap is a bilinear
gather on the tracker's device.
"""
from __future__ import annotations

import numpy as np
import torch


def build_rectify_map(K: np.ndarray, D: np.ndarray, R: np.ndarray,
                      P: np.ndarray, width: int, height: int) -> np.ndarray:
    """Equivalent of cv::initUndistortRectifyMap for the radtan model.

    For each destination (rectified) pixel: back-project through P, rotate
    by R^-1 into the original camera, apply radial-tangential distortion,
    project through K. Returns float32 [H, W, 2] (src_x, src_y).
    """
    K = np.asarray(K, np.float64)
    D = np.asarray(D, np.float64).ravel()
    R = np.asarray(R, np.float64)
    P = np.asarray(P, np.float64)
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if D.size > 4 else 0.0
    fxp, fyp = P[0, 0], P[1, 1]
    cxp, cyp = P[0, 2], P[1, 2]
    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    x = (u - cxp) / fxp
    y = (v - cyp) / fyp
    ones = np.ones_like(x)
    pts = np.stack([x, y, ones], axis=-1) @ np.linalg.inv(R).T
    x = pts[..., 0] / pts[..., 2]
    y = pts[..., 1] / pts[..., 2]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    src_x = K[0, 0] * xd + K[0, 2]
    src_y = K[1, 1] * yd + K[1, 2]
    return np.stack([src_x, src_y], axis=-1).astype(np.float32)


def remap_bilinear(img: torch.Tensor, mapping: torch.Tensor) -> torch.Tensor:
    """cv::remap(INTER_LINEAR) equivalent: sample the float32 [H, W] image
    at mapping[..., 0] = x, mapping[..., 1] = y; 0 outside the image
    (BORDER_CONSTANT)."""
    h, w = img.shape
    x = mapping[..., 0]
    y = mapping[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64).clamp(0, w - 2)
    y0i = y0.to(torch.int64).clamp(0, h - 2)
    v00 = img[y0i, x0i]
    v01 = img[y0i, x0i + 1]
    v10 = img[y0i + 1, x0i]
    v11 = img[y0i + 1, x0i + 1]
    val = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    inb = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    return torch.where(inb, val, 0.0)


class StereoRectifier:
    """Holds the two maps on ``device``; __call__ rectifies a stereo pair."""

    def __init__(self, left: dict, right: dict, width: int, height: int,
                 device="cuda"):
        """left/right: dicts with K, D, R, P (the YAML LEFT./RIGHT. blocks
        of a stereo settings file)."""
        self.device = torch.device(device)
        self.map_l = torch.as_tensor(build_rectify_map(
            left["K"], left["D"], left["R"], left["P"], width, height),
            device=self.device)
        self.map_r = torch.as_tensor(build_rectify_map(
            right["K"], right["D"], right["R"], right["P"], width, height),
            device=self.device)

    def __call__(self, img_l, img_r):
        def f32(img):
            return torch.as_tensor(img).to(self.device, torch.float32)

        return (remap_bilinear(f32(img_l), self.map_l),
                remap_bilinear(f32(img_r), self.map_r))
