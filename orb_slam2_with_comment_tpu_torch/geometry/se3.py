"""SO(3)/SE(3) operations on batched tensors (port of geometry/se3.py).

Poses are (R, t): rotations [..., 3, 3] and translations [..., 3], updated
by left multiplication T <- exp(xi) T with xi = [rho, phi].
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> skew-symmetric [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues with a series guard near theta = 0."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2.clamp(min=1e-16))
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> axis-angle [..., 3], robust at 0 and pi."""
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1)
    cos_t = ((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5
             ).clamp(-1.0, 1.0)
    sin_t = 0.5 * torch.sqrt((vee * vee).sum(-1) + _EPS * _EPS)
    theta = torch.atan2(sin_t, cos_t)
    small = sin_t < 1e-5
    sin_safe = torch.where(small, torch.ones_like(sin_t), sin_t)
    k = torch.where(small, 0.5 + theta * theta / 12.0,
                    theta / (2.0 * sin_safe))
    w_generic = k[..., None] * vee
    B = (R + torch.eye(3, dtype=R.dtype, device=R.device)) * 0.5
    diag = torch.diagonal(B, dim1=-2, dim2=-1)
    kidx = torch.argmax(diag, -1)
    col = torch.take_along_dim(B, kidx[..., None, None].expand(
        *B.shape[:-1], 1), -1)[..., 0]
    axis = col / torch.sqrt((col * col).sum(-1, keepdim=True) + _EPS * _EPS)
    sign = torch.where((axis * vee).sum(-1) < 0, -1.0, 1.0)
    w_pi = axis * (sign * theta)[..., None]
    near_pi = cos_t < -0.999999
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _left_jacobian(w: torch.Tensor) -> torch.Tensor:
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2.clamp(min=1e-16))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta))
                    / (theta2 * theta).clamp(min=1e-16))
    W = hat(w)
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def exp_se3(xi: torch.Tensor):
    """[..., 6] = [rho, phi] -> (R [..., 3, 3], t [..., 3])."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return exp_so3(phi), (_left_jacobian(phi) @ rho[..., None])[..., 0]


def log_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Inverse of exp_se3: -> [..., 6] = [rho, phi]."""
    phi = log_so3(R)
    rho = torch.linalg.solve(_left_jacobian(phi), t[..., None])[..., 0]
    return torch.cat([rho, phi], -1)


def compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): applies b first, then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def transform(R, t, X):
    """Apply pose to points: R [..., 3, 3], t [..., 3], X [..., 3]."""
    return (R @ X[..., None])[..., 0] + t


def retract(R, t, xi):
    """Left-multiplicative update exp(xi) * (R, t)."""
    dR, dt = exp_se3(xi)
    return compose(dR, dt, R, t)


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """One Newton step of the polar projection onto SO(3)."""
    rtr = R.transpose(-1, -2) @ R
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    return R @ (1.5 * eye - 0.5 * rtr)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w, x, y, z) -> rotation [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> unit quaternion [..., 4] (w, x, y, z), w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    qw = torch.sqrt(qw.clamp(min=1e-12)) * 0.5
    w0, x1, y2, z3 = qw[..., 0], qw[..., 1], qw[..., 2], qw[..., 3]
    cands = torch.stack([
        torch.stack([w0, (m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0),
                     (m10 - m01) / (4 * w0)], -1),
        torch.stack([(m21 - m12) / (4 * x1), x1, (m01 + m10) / (4 * x1),
                     (m02 + m20) / (4 * x1)], -1),
        torch.stack([(m02 - m20) / (4 * y2), (m01 + m10) / (4 * y2), y2,
                     (m12 + m21) / (4 * y2)], -1),
        torch.stack([(m10 - m01) / (4 * z3), (m02 + m20) / (4 * z3),
                     (m12 + m21) / (4 * z3), z3], -1)], -2)
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], -1), -1)
    q = torch.take_along_dim(
        cands, idx[..., None, None].expand(*cands.shape[:-2], 1, 4), -2)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-12)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)
