"""Reprojection residuals and analytic Jacobians (port of optim/residuals.py).

Observations are (u, v, u_r) triplets; u_r < 0 marks a mono observation
whose third residual row is masked. e = observation - projection.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
HUBER_MONO = CHI2_MONO ** 0.5
HUBER_STEREO = CHI2_STEREO ** 0.5


class CamParams(NamedTuple):
    """Pinhole intrinsics + stereo baseline*fx, as float32-exact floats."""
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float

    @classmethod
    def of(cls, fx, fy, cx, cy, bf) -> "CamParams":
        return cls(*(float(np.float32(v)) for v in (fx, fy, cx, cy, bf)))


def project_uvr(cam: CamParams, Xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame point [..., 3] -> (u, v, u_r) [..., 3]."""
    z = Xc[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
    u = cam.fx * Xc[..., 0] * inv_z + cam.cx
    v = cam.fy * Xc[..., 1] * inv_z + cam.cy
    return torch.stack([u, v, u - cam.bf * inv_z], -1)


def residual_weight_rows(obs_uvr: torch.Tensor) -> torch.Tensor:
    """[..., 3] row mask: (1, 1, 1) stereo, (1, 1, 0) mono."""
    ones = torch.ones_like(obs_uvr[..., 0])
    return torch.stack([ones, ones, (obs_uvr[..., 2] >= 0).to(obs_uvr.dtype)],
                       -1)


def reproj_residual(cam: CamParams, R, t, Xw, obs_uvr):
    """Returns (residual [..., 3], Xc [..., 3], row mask [..., 3])."""
    Xc = se3.transform(R, t, Xw)
    rows = residual_weight_rows(obs_uvr)
    return (obs_uvr - project_uvr(cam, Xc)) * rows, Xc, rows


def dproj_dXc(cam: CamParams, Xc: torch.Tensor) -> torch.Tensor:
    """Jacobian of (u, v, u_r) wrt the camera-frame point [..., 3, 3]."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    iz = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1),
        torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1),
        torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2 + cam.bf * iz2], -1),
    ], -2)


def reproj_jacobians(cam: CamParams, R, t, Xw, obs_uvr):
    """(e [..., 3], J_pose [..., 3, 6], J_point [..., 3, 3]); mono rows zero."""
    e, Xc, rows = reproj_residual(cam, R, t, Xw, obs_uvr)
    Jproj = dproj_dXc(cam, Xc)
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Jproj.shape)
    dXc_dxi = torch.cat([eye, -se3.hat(Xc)], -1)
    J_pose = -(Jproj @ dXc_dxi) * rows[..., None]
    J_point = -(Jproj @ R) * rows[..., None]
    return e, J_pose, J_point


def huber_weight(chi2: torch.Tensor, delta) -> torch.Tensor:
    """IRLS weight of the Huber kernel: 1 inside delta, delta/|e| outside."""
    abs_e = torch.sqrt(chi2.clamp(min=1e-12))
    return torch.where(abs_e <= delta, 1.0, delta / abs_e)
