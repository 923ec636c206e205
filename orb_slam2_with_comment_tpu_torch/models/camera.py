"""Camera projection models: pinhole with radial-tangential distortion,
and stereo with a baseline (port of models/camera.py).

The intrinsics and distortion coefficients are float32-exact Python
floats, so one model serves tensors on any device. Stereo observations are
(uL, vL, uR) with uR = uL - bf / depth (reference: Frame.cc:655).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _f32(v) -> float:
    return float(np.float32(v))


class PinholeCamera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    dist: tuple  # (k1, k2, p1, p2, k3); zeros = none
    width: int
    height: int

    @staticmethod
    def create(fx, fy, cx, cy, dist=None, width=640, height=480):
        d = [] if dist is None else [_f32(v) for v in np.asarray(dist).ravel()]
        d = tuple(d + [0.0] * (5 - len(d)))
        return PinholeCamera(_f32(fx), _f32(fy), _f32(cx), _f32(cy), d,
                             int(width), int(height))

    @property
    def K(self) -> torch.Tensor:
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32)

    def project(self, Xc: torch.Tensor) -> torch.Tensor:
        """Camera-frame points [..., 3] -> pixels [..., 2], undistorted
        (keypoints are undistorted once per frame instead,
        Frame::UndistortKeyPoints)."""
        z = Xc[..., 2]
        inv_z = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
        return torch.stack([self.fx * Xc[..., 0] * inv_z + self.cx,
                            self.fy * Xc[..., 1] * inv_z + self.cy], -1)

    def backproject(self, uv: torch.Tensor, depth: torch.Tensor
                    ) -> torch.Tensor:
        """Pixels [..., 2] and depth [...] -> camera-frame points [..., 3]."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return torch.stack([x * depth, y * depth, depth], -1)

    def distort_normalized(self, xy: torch.Tensor) -> torch.Tensor:
        """Radial-tangential distortion of normalized coordinates [..., 2]."""
        k1, k2, p1, p2, k3 = self.dist
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return torch.stack([xd, yd], -1)

    def undistort_points(self, uv: torch.Tensor, iters: int = 8
                         ) -> torch.Tensor:
        """Undistort pixel coordinates by ``iters`` fixed-point iterations
        (as cv::undistortPoints; reference: Frame.cc:434-469), under the
        same K."""
        xy0 = torch.stack([(uv[..., 0] - self.cx) / self.fx,
                           (uv[..., 1] - self.cy) / self.fy], -1)
        xy = xy0
        for _ in range(iters):
            xy = xy0 - (self.distort_normalized(xy) - xy)
        return torch.stack([xy[..., 0] * self.fx + self.cx,
                            xy[..., 1] * self.fy + self.cy], -1)


class StereoCamera(NamedTuple):
    cam: PinholeCamera
    bf: float  # baseline * fx, as the reference's Camera.bf

    @staticmethod
    def create(cam: PinholeCamera, bf) -> "StereoCamera":
        return StereoCamera(cam, _f32(bf))

    @property
    def baseline(self) -> float:
        return self.bf / self.cam.fx

    def project_stereo(self, Xc: torch.Tensor) -> torch.Tensor:
        """Camera-frame points [..., 3] -> (uL, vL, uR) [..., 3]."""
        uv = self.cam.project(Xc)
        z = Xc[..., 2]
        inv_z = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
        return torch.cat([uv, (uv[..., 0] - self.bf * inv_z)[..., None]], -1)

    def depth_from_disparity(self, disparity: torch.Tensor) -> torch.Tensor:
        return self.bf / torch.where(disparity.abs() < 1e-9, 1e-9, disparity)
