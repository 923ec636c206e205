"""Monocular two-view initialization: batched H/F RANSAC and reconstruction
(port of solvers/initializer.py; reference: Initializer.cc:53-948).

Every 8-point set is solved for both a homography (DLT) and a fundamental
matrix (8-point) and scored by symmetric transfer chi2; the model is chosen
by SH / (SH + SF) > 0.40; then the reconstruction, F through the essential
matrix's 4 (R, t) hypotheses, H through the Faugeras 8-motion
decomposition, with the cheirality / parallax / reprojection vote of
CheckRT (:816-925).

Sampling is split from solving: ``sample_octets`` draws from the tracker's
generator, ``initialize_from_samples`` is everything after the draw.
Eigenvector and singular-vector signs are the LAPACK build's (or
cuSOLVER's): the scores do not depend on them, but the order of the 4 and
8 motion hypotheses does, so two builds may name the winner by another
index while agreeing on its pose.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import triangulate
from .sim3solver import gumbel

TH_H = 5.991
TH_F = 3.841
SCORE_CAP = 5.991


def _mT(a):
    return a.transpose(-1, -2)


def _normalize(pts: torch.Tensor, valid: torch.Tensor):
    """Mean / mean-absolute-deviation normalization (Initializer::
    Normalize) over the valid points: (normalized [N, 2], T [3, 3])."""
    w = valid.to(pts.dtype)
    n = w.sum().clamp(min=1.0)
    mean = (pts * w[:, None]).sum(0) / n
    dev = ((pts - mean).abs() * w[:, None]).sum(0) / n
    s = 1.0 / dev.clamp(min=1e-9)
    T = torch.zeros((3, 3), dtype=pts.dtype, device=pts.device)
    T[0, 0], T[1, 1], T[2, 2] = s[0], s[1], 1.0
    T[0, 2], T[1, 2] = -mean[0] * s[0], -mean[1] * s[1]
    return (pts - mean) * s, T


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] from the eigenvector of A^T A [..., 9, 9] with the
    least eigenvalue."""
    _, V = torch.linalg.eigh(_mT(A) @ A)
    return V[..., :, 0].reshape(*A.shape[:-2], 3, 3)


def _solve_h(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """DLT homographies from [T, 8, 2] correspondences -> [T, 3, 3]."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(x1), torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    return _null_vector(torch.cat([r1, r2], -2))


def _solve_f(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """8-point fundamental matrices from [T, 8, 2] -> rank-2 [T, 3, 3]."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o],
                    -1)
    U, S, Vh = torch.linalg.svd(_null_vector(A))
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., :1])], -1)
    return U @ torch.diag_embed(S) @ Vh


def _homog(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[:, :1])], -1)


def _score_h(H, p1, p2, valid, sigma2: float):
    """Symmetric transfer score of H [T, 3, 3] (CheckHomography,
    :323-406): (score [T], inliers [T, N])."""
    Hi = torch.linalg.inv_ex(H)[0]

    def transfer(M, a):
        b = _homog(a) @ _mT(M)
        return b[..., :2] / b[..., 2:3].clamp(min=1e-9)

    e12 = ((transfer(H, p1) - p2) ** 2).sum(-1) / sigma2
    e21 = ((transfer(Hi, p2) - p1) ** 2).sum(-1) / sigma2
    ok = (e12 < TH_H) & (e21 < TH_H) & valid
    score = torch.where(ok, (SCORE_CAP - e12) + (SCORE_CAP - e21), 0.0).sum(-1)
    return score, ok


def _score_f(F, p1, p2, valid, sigma2: float):
    """Epipolar-distance score of F [T, 3, 3] (CheckFundamental,
    :408-486)."""
    p1h, p2h = _homog(p1), _homog(p2)
    l2 = p1h @ _mT(F)  # lines in image 2
    l1 = p2h @ F  # lines in image 1
    d2 = (l2 * p2h).sum(-1) ** 2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2).clamp(
        min=1e-12)
    d1 = (l1 * p1h).sum(-1) ** 2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2).clamp(
        min=1e-12)
    c2, c1 = d2 / sigma2, d1 / sigma2
    ok = (c1 < TH_F) & (c2 < TH_F) & valid
    v = valid.to(p1.dtype)
    score = (torch.where(c2 < TH_F, SCORE_CAP - c2, 0.0) * v
             + torch.where(c1 < TH_F, SCORE_CAP - c1, 0.0) * v).sum(-1)
    return score, ok


def _k_matrix(K, like: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = K
    return like.new_tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


def _check_rt(R, t, K, p1, p2, valid, sigma2: float):
    """Cheirality, parallax and reprojection vote (CheckRT, :816-925) for
    hypotheses R [B, 3, 3], t [B, 3]: (n_good [B], the parallax cosine at
    the 50th smallest among the good points [B], X [B, N, 3], good
    [B, N])."""
    fx, fy, cx, cy = K
    Km = _k_matrix(K, p1)
    B, N = R.shape[0], p1.shape[0]
    P1 = Km @ torch.cat([torch.eye(3, dtype=p1.dtype, device=p1.device),
                         p1.new_zeros((3, 1))], 1)
    P2 = Km @ torch.cat([R, t[..., None]], -1)
    X = triangulate.triangulate_dlt(
        P1.expand(B, N, 3, 4), P2[:, None].expand(B, N, 3, 4),
        p1.expand(B, N, 2), p2.expand(B, N, 2))
    C2 = -(_mT(R) @ t[..., None])[..., 0]
    cos_par = triangulate.rays_parallax_cos(p1.new_zeros(3), C2[:, None], X)
    z1 = X[..., 2]
    Xc2 = X @ _mT(R) + t[:, None]
    z2 = Xc2[..., 2]
    finite = torch.isfinite(X).all(-1)
    # cheirality is enforced only at sufficient parallax (:875-919)
    chei = ((z1 > 0) & (z2 > 0)) | (cos_par >= 0.99998)
    sz1 = torch.where(z1 == 0, 1e-9, z1)
    sz2 = torch.where(z2 == 0, 1e-9, z2)
    e1 = ((fx * X[..., 0] / sz1 + cx - p1[:, 0]) ** 2
          + (fy * X[..., 1] / sz1 + cy - p1[:, 1]) ** 2)
    e2 = ((fx * Xc2[..., 0] / sz2 + cx - p2[:, 0]) ** 2
          + (fy * Xc2[..., 1] / sz2 + cy - p2[:, 1]) ** 2)
    reproj_ok = (e1 < 4.0 * sigma2) & (e2 < 4.0 * sigma2)
    good = valid & finite & chei & reproj_ok & (cos_par < 0.99998)
    n_good = good.sum(-1, dtype=torch.int32)
    cos_sorted = torch.sort(torch.where(good, cos_par, 1.0), -1).values
    k50 = (n_good - 1).clamp(min=0).clamp(max=49).long()
    return n_good, cos_sorted.gather(1, k50[:, None])[:, 0], X, good


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp(min=1e-12)


def _proper(R: torch.Tensor) -> torch.Tensor:
    return R * torch.sign(torch.linalg.det(R))[..., None, None]


def _motions_from_f(F, Km):
    """The 4 (R, t) hypotheses of E = K^T F K (:489-510)."""
    U, _, Vh = torch.linalg.svd(_mT(Km) @ F @ Km)
    W = F.new_tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    R1 = _proper(U @ W @ Vh)
    R2 = _proper(U @ W.T @ Vh)
    tv = _unit(U[:, 2])
    return torch.stack([R1, R1, R2, R2]), torch.stack([tv, -tv, tv, -tv])


def _motions_from_h(H, Km):
    """The 8 (R, t) hypotheses of the Faugeras decomposition of
    A = K^-1 H K (:537-700)."""
    U, D, Vh = torch.linalg.svd(torch.linalg.inv_ex(Km)[0] @ H @ Km)
    d1, d2, d3 = D[0], D[1], D[2]
    s_det = torch.linalg.det(U) * torch.linalg.det(Vh)
    d13 = (d1 * d1 - d3 * d3).clamp(min=1e-12)
    aux1 = torch.sqrt(((d1 * d1 - d2 * d2) / d13).clamp(min=0))
    aux3 = torch.sqrt(((d2 * d2 - d3 * d3) / d13).clamp(min=0))
    x1s = H.new_tensor([1.0, 1.0, -1.0, -1.0]) * aux1
    x3s = H.new_tensor([1.0, -1.0, 1.0, -1.0]) * aux3
    signs = H.new_tensor([1.0, -1.0, -1.0, 1.0])
    root = torch.sqrt(((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)).clamp(min=0))
    sts = signs * (root / ((d1 + d3) * d2).clamp(min=1e-12))
    sps = signs * (root / ((d1 - d3) * d2).clamp(min=1e-12))
    ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2).clamp(min=1e-12)
    cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2).clamp(min=1e-12)
    zero, one = torch.zeros_like(sts), torch.ones_like(sts)
    ct4, cp4 = ct.expand(4), cp.expand(4)

    def rows(*r):
        return torch.stack([torch.stack(row, -1) for row in r], -2)

    Rp_pos = rows((ct4, zero, -sts), (zero, one, zero), (sts, zero, ct4))
    Rp_neg = rows((cp4, zero, sps), (zero, -one, zero), (sps, zero, -cp4))
    tp_pos = (d1 - d3) * torch.stack([x1s, zero, -x3s], -1)
    tp_neg = (d1 + d3) * torch.stack([x1s, zero, x3s], -1)
    Rp = torch.cat([Rp_pos, Rp_neg])
    tp = torch.cat([tp_pos, tp_neg])
    return _proper(s_det * U @ Rp @ Vh), _unit(tp @ U.T)


class InitResult(NamedTuple):
    success: torch.Tensor  # [] bool
    R: torch.Tensor  # [3, 3] pose of frame 2 (world = frame 1)
    t: torch.Tensor  # [3]
    X: torch.Tensor  # [N, 3] triangulated points
    good: torch.Tensor  # [N] bool triangulated-point mask
    used_h: torch.Tensor  # [] bool


def sample_octets(gen: torch.Generator, valid: torch.Tensor,
                  iterations: int = 200) -> torch.Tensor:
    """[iterations, 8] indices drawn uniformly from the valid slots, with
    replacement (Gumbel-max over log-probabilities, as
    jax.random.categorical draws)."""
    probs = valid.float() / valid.sum().clamp(min=1)
    logits = torch.log(probs.clamp(min=1e-12))
    g = gumbel(gen, (iterations * 8, valid.shape[0]), valid.device)
    return torch.argmax(logits + g, -1).reshape(iterations, 8)


def initialize_from_samples(idx: torch.Tensor, K, p1: torch.Tensor,
                            p2: torch.Tensor, valid: torch.Tensor,
                            sigma: float = 1.0) -> InitResult:
    """The two-view bootstrap from the minimal sets idx [T, 8]: p1, p2
    [N, 2] matched keypoints of frames 1 and 2, valid [N]."""
    sigma2 = sigma * sigma
    n1, T1 = _normalize(p1, valid)
    n2, T2 = _normalize(p2, valid)
    H_img = torch.linalg.inv_ex(T2)[0] @ _solve_h(n1[idx], n2[idx]) @ T1
    F_img = T2.T @ _solve_f(n1[idx], n2[idx]) @ T1
    h_scores, h_inl = _score_h(H_img, p1, p2, valid, sigma2)
    f_scores, f_inl = _score_f(F_img, p1, p2, valid, sigma2)
    bh, bf = torch.argmax(h_scores), torch.argmax(f_scores)
    SH, SF = h_scores[bh], f_scores[bf]
    use_h = SH / (SH + SF).clamp(min=1e-9) > 0.40
    Km = _k_matrix(K, p1)
    f_Rs, f_ts = _motions_from_f(F_img[bf], Km)
    h_Rs, h_ts = _motions_from_h(H_img[bh], Km)
    # the F hypotheses are padded to 8 so both paths share one CheckRT
    Rs = torch.where(use_h, h_Rs, torch.cat([f_Rs, f_Rs]))
    ts = torch.where(use_h, h_ts, torch.cat([f_ts, f_ts]))
    model_inl = torch.where(use_h, h_inl[bh], f_inl[bf])
    n_good, par_cos, Xs, goods = _check_rt(Rs, ts, K, p1, p2, model_inl,
                                           sigma2)
    second_copy = torch.arange(8, device=p1.device) >= 4
    n_good = torch.where(second_copy & ~use_h, -1, n_good)
    best = torch.argmax(n_good)
    n_best = n_good[best]
    n_second = torch.sort(n_good).values[-2]
    n_inl = model_inl.sum(dtype=torch.int32)
    # acceptance (:134-136, 522-535): a clear winner, enough points,
    # parallax above 1 degree
    success = ((n_best >= (0.9 * n_inl.float()).to(torch.int32).clamp(min=50))
               & (n_second.float() < 0.75 * n_best.float())
               & (par_cos[best] < 0.9998477))
    return InitResult(success, Rs[best], ts[best], Xs[best],
                      goods[best] & success, use_h)


def initialize(gen: torch.Generator, K, p1, p2, valid, iterations: int = 200,
               sigma: float = 1.0) -> InitResult:
    return initialize_from_samples(sample_octets(gen, valid, iterations), K,
                                   p1, p2, valid, sigma)
