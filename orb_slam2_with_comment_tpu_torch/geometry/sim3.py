"""Sim(3) operations on batched tensors (port of geometry/sim3.py).

An element is (R [..., 3, 3], t [..., 3], s [...]): x -> s R x + t, updated
by left multiplication like the SE3 poses (g2o's VertexSim3Expmap, used by
the loop closer's optimizers). Singular solves do not raise: they give
inf/NaN, which the callers' accept tests reject.
"""
from __future__ import annotations

import torch

from . import se3


def identity(batch_shape=(), dtype=torch.float32, device=None):
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
    return (R, torch.zeros((*batch_shape, 3), dtype=dtype, device=device),
            torch.ones(batch_shape, dtype=dtype, device=device))


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def transform(R, t, s, X):
    return s[..., None] * _mv(R, X) + t


def compose(Ra, ta, sa, Rb, tb, sb):
    """(a * b): apply b first, then a."""
    return Ra @ Rb, sa[..., None] * _mv(Ra, tb) + ta, sa * sb


def inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * _mv(Rt, t), s_inv


def _sim3_W(phi, sigma, s, theta):
    """W with t = W rho (the sim(3) exp's translation block), with the
    small-angle and small-scale limits."""
    Phi = se3.hat(phi)
    Phi2 = Phi @ Phi
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(Phi.shape)
    sigma2 = sigma * sigma
    theta2 = theta * theta
    small_sigma = sigma.abs() < 1e-5
    small_theta = theta < 1e-5
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    sigma_safe = torch.where(small_sigma, 1.0, sigma)
    C = torch.where(small_sigma, 1.0 + sigma / 2.0, (s - 1.0) / sigma_safe)
    denom = sigma2 + theta2
    denom = torch.where(denom < 1e-12, 1.0, denom)
    A_gen = ((s * sin_t * sigma + (1.0 - s * cos_t) * theta)
             / (denom * theta.clamp(min=1e-12)))
    B_gen = ((C - ((s * cos_t - 1.0) * sigma + s * sin_t * theta) / denom)
             / theta2.clamp(min=1e-12))
    A_s0 = (1.0 - cos_t) / theta2.clamp(min=1e-12)
    B_s0 = (theta - sin_t) / (theta2 * theta).clamp(min=1e-12)
    A_t0 = torch.where(small_sigma, 0.5, ((sigma - 1.0) * s + 1.0)
                       / torch.where(small_sigma, 1.0, sigma2))
    B_t0 = torch.where(small_sigma, 1.0 / 6.0,
                       (s * (0.5 * sigma2 - sigma + 1.0) - 1.0)
                       / torch.where(small_sigma, 1.0, sigma2 * sigma))
    A = torch.where(small_theta, A_t0, torch.where(small_sigma, A_s0, A_gen))
    B = torch.where(small_theta, B_t0, torch.where(small_sigma, B_s0, B_gen))
    return (C[..., None, None] * eye + A[..., None, None] * Phi
            + B[..., None, None] * Phi2)


def exp(xi: torch.Tensor):
    """sim(3) exp: xi = [rho(3), phi(3), sigma(1)] [..., 7] -> (R, t, s)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    theta = torch.sqrt((phi * phi).sum(-1) + 1e-16)
    return se3.exp_so3(phi), _mv(_sim3_W(phi, sigma, s, theta), rho), s


def log(R, t, s):
    """Inverse of exp: (R, t, s) -> [..., 7]."""
    phi = se3.log_so3(R)
    sigma = torch.log(s)
    theta = torch.linalg.norm(phi, dim=-1)
    W = _sim3_W(phi, sigma, s, theta)
    rho = torch.linalg.solve_ex(W, t[..., None])[0][..., 0]
    return torch.cat([rho, phi, sigma[..., None]], -1)


def retract(R, t, s, xi):
    """Left-multiplicative update exp(xi) * (R, t, s)."""
    return compose(*exp(xi), R, t, s)
