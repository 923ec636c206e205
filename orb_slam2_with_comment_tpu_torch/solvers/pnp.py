"""EPnP + RANSAC pose solver for relocalization (port of solvers/pnp.py).

PnPsolver (reference: PnPsolver.cc:67-352) as one batch: every 4-point
hypothesis runs the full EPnP (control points, barycentric coordinates,
the 2S x 12 M matrix, its 4-dimensional null basis, beta cases 1-3 from
the L_6x10 distance system, 5 Gauss-Newton steps, alignment by Horn) and
keeps the case with the least reprojection error. All hypotheses are
scored at once, and the winner is re-estimated from all of its inliers
(Refine, :273-318).

Degenerate samples must not raise: the small solves run without error
checks, and a sample whose covariance or M^T M is not finite is
eigen-decomposed on the identity instead and scored +inf, with a zero
pose, as the JAX package's NaN propagation scores it. Sampling is split
from solving (``sample_quads`` / ``solve_from_samples``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.fast import sort_top_k
from . import horn
from .sim3solver import gumbel

CHI2_PNP = 5.991

# the 10 monomials beta_i beta_j (i <= j) in the L_6x10 column order
# (reference compute_L_6x10, PnPsolver.cc:770-805)
_B10_I = [0, 0, 1, 0, 1, 2, 0, 1, 2, 3]
_B10_J = [0, 1, 1, 2, 2, 2, 3, 3, 3, 3]
# the 6 control-point pairs (reference compute_rho :807-815)
_PAIR_I = [0, 0, 0, 1, 1, 2]
_PAIR_J = [1, 2, 3, 2, 3, 3]
_PERM = [0, 4, 8, 1, 5, 9, 2, 6, 10, 3, 7, 11]


class PnPResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor  # [N]
    n_inliers: torch.Tensor


def _mT(a):
    return a.transpose(-1, -2)


def _finite(a, dims: int):
    ok = torch.isfinite(a)
    for _ in range(dims):
        ok = ok.all(-1)
    return ok


def _safe_eigh(M: torch.Tensor):
    """eigh with non-finite matrices swapped for the identity; returns
    (eigenvalues, eigenvectors, bad [...])."""
    bad = ~_finite(M, 2)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    evals, evecs = torch.linalg.eigh(torch.where(bad[..., None, None], eye, M))
    return evals, evecs, bad


def _lstsq_nm(A, b, m: int):
    """Ridge-damped normal equations of A [..., 6, m] x = b [..., 6]."""
    AtA = _mT(A) @ A
    trace = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)
    ridge = 1e-7 * trace / m + 1e-12
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    return torch.linalg.solve_ex(AtA + ridge[..., None, None] * eye,
                                 (_mT(A) @ b[..., None]))[0][..., 0]


def _b10(beta):
    return beta[..., _B10_I] * beta[..., _B10_J]


def _gauss_newton(L, rho, beta, iters: int = 5):
    """Refine betas on the 6 distance constraints (PnPsolver.cc:853-871).
    L [..., 6, 10], rho [..., 6], beta [..., 4]."""
    eye = torch.eye(4, dtype=beta.dtype, device=beta.device)
    for _ in range(iters):
        r = (L @ _b10(beta)[..., None])[..., 0] - rho
        dB = (beta[..., _B10_J, None] * eye[_B10_I]
              + beta[..., _B10_I, None] * eye[_B10_J])  # [..., 10, 4]
        beta = beta + _lstsq_nm(L @ dB, -r, 4)
    return beta


def epnp(Xw, uv, w, K):
    """EPnP on a batch: Xw [B, S, 3], uv [B, S, 2], weights w [B, S].
    Returns (R [B, 3, 3], t [B, 3], err [B]), err the weighted mean
    squared reprojection error of the winning beta case (+inf when the
    sample is degenerate)."""
    fx, fy, cx, cy = K
    B, S = w.shape
    dev, dt = Xw.device, Xw.dtype
    wsum = w.sum(-1).clamp(min=1e-6)
    c0 = (Xw * w[..., None]).sum(1) / wsum[:, None]
    Xc0 = (Xw - c0[:, None]) * torch.sqrt(w)[..., None]
    cov = _mT(Xc0) @ Xc0 / wsum[:, None, None]
    evals, evecs, bad = _safe_eigh(cov)
    axes = _mT(evecs) * torch.sqrt(evals.clamp(min=1e-9))[..., None]
    ctrl_w = torch.cat([c0[:, None], c0[:, None] + axes], 1)  # [B, 4, 3]
    ones4 = torch.ones((B, 1, 4), dtype=dt, device=dev)
    Cmat = torch.cat([_mT(ctrl_w), ones4], 1)  # [B, 4, 4]
    Xh = torch.cat([_mT(Xw), torch.ones((B, 1, S), dtype=dt, device=dev)], 1)
    alpha = _mT(torch.linalg.solve_ex(Cmat, Xh)[0])  # [B, S, 4]
    u, v = uv[..., 0], uv[..., 1]
    zeros = torch.zeros_like(alpha)
    row_u = torch.cat([alpha * fx, zeros, alpha * (cx - u)[..., None]], -1)
    row_v = torch.cat([zeros, alpha * fy, alpha * (cy - v)[..., None]], -1)
    Mm = torch.cat([row_u * w[..., None], row_v * w[..., None]], 1)
    Mm = Mm[..., _PERM]
    _, V, bad_m = _safe_eigh(_mT(Mm) @ Mm)
    bad = bad | bad_m
    vbasis = _mT(V[..., :4]).reshape(B, 4, 4, 3)
    dv = vbasis[:, :, _PAIR_I, :] - vbasis[:, :, _PAIR_J, :]  # [B, 4, 6, 3]
    dots = torch.einsum("bipc,bjpc->bpij", dv, dv)  # [B, 6, 4, 4]
    coef = torch.tensor([1.0 if i == j else 2.0 for i, j in
                         zip(_B10_I, _B10_J)], dtype=dt, device=dev)
    L6 = dots[:, :, _B10_I, _B10_J] * coef
    dw = ctrl_w[:, _PAIR_I] - ctrl_w[:, _PAIR_J]
    rho = (dw * dw).sum(-1)  # [B, 6]
    # beta seeds, cases 1-3 (find_betas_approx_*, :562-652); cases 2 and
    # 3 keep the b22 seed only when sign(b22) agrees with sign(b11)
    x1 = _lstsq_nm(L6[..., [0, 1, 3, 6]], rho, 4)
    b0 = torch.sqrt(x1[:, 0].abs())
    beta1 = torch.cat([b0[:, None], x1[:, 1:] * torch.sign(x1[:, :1])
                       / b0.clamp(min=1e-9)[:, None]], -1)
    x2 = _lstsq_nm(L6[..., [0, 1, 2]], rho, 3)
    b0 = torch.sqrt(x2[:, 0].abs())
    b1 = torch.where(x2[:, 0] * x2[:, 2] > 0, torch.sqrt(x2[:, 2].abs()), 0.0)
    zero = torch.zeros_like(b0)
    beta2 = torch.stack([b0, b1 * torch.sign(x2[:, 1]) * torch.sign(x2[:, 0]),
                         zero, zero], -1)
    x3 = _lstsq_nm(L6[..., [0, 1, 2, 3, 4]], rho, 5)
    b0 = torch.sqrt(x3[:, 0].abs())
    b1 = torch.where(x3[:, 0] * x3[:, 2] > 0, torch.sqrt(x3[:, 2].abs()), 0.0)
    beta3 = torch.stack([b0, b1 * torch.sign(x3[:, 1]) * torch.sign(x3[:, 0]),
                         x3[:, 3] * torch.sign(x3[:, 0]) / b0.clamp(min=1e-9),
                         zero], -1)
    betas = torch.stack([beta1, beta2, beta3], 1)  # [B, 3, 4]
    betas = _gauss_newton(L6[:, None], rho[:, None], betas)
    # the pose of each case (estimate_R_and_t, :900-960)
    ctrl_c = torch.einsum("bqk,bkcd->bqcd", betas, vbasis)  # [B, 3, 4, 3]
    Xc_est = alpha[:, None] @ ctrl_c  # [B, 3, S, 3]
    w3 = w[:, None].expand(B, 3, S)
    flip = (Xc_est[..., 2] * w3).sum(-1) < 0
    Xc_est = torch.where(flip[..., None, None], -Xc_est, Xc_est)
    Xw3 = Xw[:, None].expand(B, 3, S, 3)
    R, t, _ = horn.solve(Xc_est, Xw3, with_scale=False, w=w3)
    Xc = Xw3 @ _mT(R) + t[..., None, :]
    z = Xc[..., 2].clamp(min=1e-6)
    e2 = ((fx * Xc[..., 0] / z + cx - u[:, None]) ** 2
          + (fy * Xc[..., 1] / z + cy - v[:, None]) ** 2)
    bad_depth = ((Xc[..., 2] <= 0).to(dt) * w3).sum(-1) > 0
    err = (e2 * w3).sum(-1) / wsum[:, None]
    err = torch.where(torch.isfinite(err) & ~bad_depth & ~bad[:, None], err,
                      float("inf"))
    best = torch.argmin(err, 1)
    ar = torch.arange(B, device=dev)
    R_b = torch.where(bad[:, None, None], float("nan"), R[ar, best])
    t_b = torch.where(bad[:, None], float("nan"), t[ar, best])
    return torch.nan_to_num(R_b), torch.nan_to_num(t_b), err[ar, best]


def sample_quads(gen: torch.Generator, valid: torch.Tensor, max_iters: int,
                 sample_size: int = 4) -> torch.Tensor:
    """[max_iters, sample_size] indices, distinct within a row, drawn
    uniformly from the valid slots (Gumbel top-k). With fewer valid slots
    than sample_size, a row also takes invalid slots, lowest first, as the
    JAX package's top_k does."""
    g = gumbel(gen, (max_iters, valid.shape[0]), valid.device)
    g = torch.where(valid[None], g, float("-inf"))
    return sort_top_k(g, sample_size)[1]


def _classify(K, R, t, Xw, uv, sigma2, valid):
    fx, fy, cx, cy = K
    Xc = torch.einsum("tij,nj->tni", R, Xw) + t[:, None]
    z = Xc[..., 2].clamp(min=1e-6)
    e2 = ((fx * Xc[..., 0] / z + cx - uv[None, :, 0]) ** 2
          + (fy * Xc[..., 1] / z + cy - uv[None, :, 1]) ** 2)
    chi2 = e2 / sigma2.clamp(min=1e-9)[None]
    inlier = (chi2 < CHI2_PNP) & (Xc[..., 2] > 0) & valid[None]
    return inlier, inlier.sum(1, dtype=torch.int32)


def solve_from_samples(idx, K, Xw, uv, sigma2, valid,
                       min_inliers: int = 10) -> PnPResult:
    """EPnP on every minimal set idx [T, S], the first hypothesis with
    the most inliers, then the all-inlier Refine."""
    ones = torch.ones(idx.shape, dtype=Xw.dtype, device=Xw.device)
    R, t, _ = epnp(Xw[idx], uv[idx], ones, K)
    inlier, counts = _classify(K, R, t, Xw, uv, sigma2, valid)
    best = torch.argmax(counts)
    R_b, t_b, in_b, n_b = R[best], t[best], inlier[best], counts[best]
    R_r, t_r, err_r = epnp(Xw[None], uv[None], in_b.to(Xw.dtype)[None], K)
    in_r, n_r = _classify(K, R_r, t_r, Xw, uv, sigma2, valid)
    take = torch.isfinite(err_r[0]) & (n_r[0] >= n_b)
    R_b = torch.where(take, R_r[0], R_b)
    t_b = torch.where(take, t_r[0], t_b)
    in_b = torch.where(take, in_r[0], in_b)
    n_b = torch.where(take, n_r[0], n_b)
    ok = n_b >= min_inliers
    return PnPResult(R_b, t_b, in_b & ok, torch.where(ok, n_b, 0))


def solve_ransac(gen: torch.Generator, K, Xw, uv, sigma2, valid,
                 max_iters: int = 300, sample_size: int = 4,
                 min_inliers: int = 10) -> PnPResult:
    """Batched EPnP RANSAC (reference defaults: P=0.99, minInliers=10,
    maxIts=300, minSet=4; PnPsolver.cc:121-157). Xw [N, 3] world points,
    uv [N, 2] pixels, sigma2 [N] level variances, valid [N]."""
    idx = sample_quads(gen, valid, max_iters, sample_size)
    return solve_from_samples(idx, K, Xw, uv, sigma2, valid, min_inliers)
