"""Levenberg-Marquardt bundle adjustment on the Schur complement (port of
optim/ba.py: ba_solve and ba_solve_cg).

Fixed-shape landmark-major problem: P poses, L landmarks, D observation
slots per landmark. Each iteration builds residuals and Jacobians over the
[L, D] table and inverts the [L] 3x3 landmark blocks; ``ba_solve`` then
assembles the reduced camera system [6P, 6P] and solves it densely (fixed
poses get identity rows), ``ba_solve_cg`` solves it by preconditioned
conjugate gradients without assembling it. Steps are accepted only when
the robust-weighted chi2 decreases.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from .pcg import block_pcg
from .residuals import HUBER_MONO, HUBER_STEREO, CamParams, huber_weight


class BAProblem(NamedTuple):
    R: torch.Tensor  # [P, 3, 3]
    t: torch.Tensor  # [P, 3]
    X: torch.Tensor  # [L, 3]
    obs_pose: torch.Tensor  # [L, D] long pose index (0 where invalid)
    obs_uvr: torch.Tensor  # [L, D, 3]; u_r < 0 => mono
    obs_w: torch.Tensor  # [L, D] invSigma2; 0 => absent
    pose_fixed: torch.Tensor  # [P] bool
    point_valid: torch.Tensor  # [L] bool


class BAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    chi2: torch.Tensor  # total weighted chi2 at the result
    obs_chi2: torch.Tensor  # [L, D] per-observation chi2
    final_lambda: torch.Tensor  # LM damping to resume the next chunk with


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A, B, C = e * i - f * h, c * h - b * i, b * f - c * e
    Dd, E, F = f * g - d * i, a * i - c * g, c * d - a * f
    G, H, Ii = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A + b * Dd + c * G
    inv_det = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)
    adj = torch.stack([torch.stack([A, B, C], -1), torch.stack([Dd, E, F], -1),
                       torch.stack([G, H, Ii], -1)], -2)
    return adj * inv_det[..., None, None]


def _project(cam, Robs, tobs, X):
    """Camera-frame points [L, D, 3] of X [L, 3] under per-slot poses."""
    Xc = (Robs @ X[:, None, :, None])[..., 0] + tobs
    z = Xc[..., 2]
    return Xc[..., 0], Xc[..., 1], torch.where(z.abs() < 1e-9, 1e-9, z)


def _components(cam, prob: BAProblem, R, t, X):
    """e [L,D,3], J_pose [L,D,3,6], J_point [L,D,3,3]."""
    Robs, tobs = R[prob.obs_pose], t[prob.obs_pose]
    x, y, z = _project(cam, Robs, tobs, X)
    iz = 1.0 / z
    iz2 = iz * iz
    srow = (prob.obs_uvr[..., 2] >= 0).to(x.dtype)
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    obs = prob.obs_uvr
    e = torch.stack([obs[..., 0] - u, obs[..., 1] - v,
                     (obs[..., 2] - ur) * srow], -1)
    zero = torch.zeros_like(x)
    Jproj = torch.stack([
        torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1),
        torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1),
        torch.stack([(cam.fx * iz) * srow, zero,
                     (-cam.fx * x * iz2 + cam.bf * iz2) * srow], -1)], -2)
    Xc = torch.stack([x, y, z], -1)
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(Jproj.shape)
    Jp = -(Jproj @ torch.cat([eye, -se3.hat(Xc)], -1))
    Jl = -(Jproj @ Robs)
    return e, Jp, Jl


def _eval_chi2(cam, prob: BAProblem, w_active, R, t, X):
    """Per-observation weighted chi2 [L, D] (zero where inactive)."""
    x, y, z = _project(cam, R[prob.obs_pose], t[prob.obs_pose], X)
    iz = 1.0 / z
    obs = prob.obs_uvr
    srow = (obs[..., 2] >= 0).to(x.dtype)
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    e2 = ((obs[..., 0] - u) ** 2 + (obs[..., 1] - v) ** 2
          + ((obs[..., 2] - ur) * srow) ** 2)
    return e2 * w_active


def _lm_iterations(cam: CamParams, prob: BAProblem, iters: int, robust: bool,
                   init_lambda, reduced_step) -> BAResult:
    """The LM loop both solvers share: residuals and Jacobians over the
    [L, D] table, the landmark blocks and their inverses, then
    ``reduced_step(wJp, Jp, e, Y, Hll_inv, bl, lam) -> dxi [P, 6]`` (the
    reduced camera system, dense or iterative), back-substitution of the
    landmarks and the accept/reject on the robust-weighted chi2."""
    dev, f32 = prob.X.device, prob.X.dtype
    delta_h = torch.where(prob.obs_uvr[..., 2] >= 0, HUBER_STEREO, HUBER_MONO)
    active = (prob.obs_w > 0) & prob.point_valid[:, None]
    w_active = torch.where(active, prob.obs_w, 0.0)
    free_obs = (~prob.pose_fixed)[prob.obs_pose].to(f32)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    R, t, X = prob.R, prob.t, prob.X
    lam = torch.as_tensor(init_lambda, dtype=f32, device=dev).reshape(())
    for _ in range(iters):
        e, Jp, Jl = _components(cam, prob, R, t, X)
        chi2_i = (e * e).sum(-1) * prob.obs_w
        w_rob = huber_weight(chi2_i, delta_h) if robust else 1.0
        w = w_active * w_rob
        Jp = Jp * free_obs[..., None, None]
        wJp = Jp * w[..., None, None]
        wJl = Jl * w[..., None, None]
        Hll = torch.einsum("ldri,ldrj->lij", wJl, Jl)
        bl = torch.einsum("ldri,ldr->li", wJl, e)
        Y = torch.einsum("ldri,ldrj->ldij", wJp, Jl)  # [L, D, 6, 3]
        diag_ll = torch.diagonal(Hll, dim1=-2, dim2=-1).clamp(min=1e-6)
        Hll_d = Hll + lam * torch.diag_embed(diag_ll)
        Hll_d = torch.where(prob.point_valid[:, None, None], Hll_d, eye3)
        Hll_inv = _inv3x3(Hll_d)
        dxi = reduced_step(wJp, Jp, e, Y, Hll_inv, bl, lam)
        # back-substitution: Hll dX = -(bl + sum_d Y^T dxi_pose)
        rhs_l = bl + torch.einsum("ldij,ldi->lj", Y, dxi[prob.obs_pose])
        dX = -(Hll_inv @ rhs_l[..., None])[..., 0]
        dX = torch.where(prob.point_valid[:, None], dX, 0.0)
        R_new, t_new = se3.retract(R, t, dxi)
        X_new = X + dX
        chi2_old = torch.where(active, chi2_i, 0.0).sum()
        chi2_new = _eval_chi2(cam, prob, w_active, R_new, t_new, X_new).sum()
        ok = ((chi2_new < chi2_old) & torch.isfinite(dxi).all()
              & torch.isfinite(dX).all())
        R = torch.where(ok, R_new, R)
        t = torch.where(ok, t_new, t)
        X = torch.where(ok, X_new, X)
        lam = torch.where(ok, lam * 0.5, lam * 5.0).clamp(1e-9, 1e8)
    R = se3.orthonormalize(R)
    obs_chi2 = _eval_chi2(cam, prob, w_active, R, t, X)
    return BAResult(R, t, X, obs_chi2.sum(), obs_chi2, lam)


def ba_solve(cam: CamParams, prob: BAProblem, iters: int = 10,
             robust: bool = True, init_lambda=1e-4) -> BAResult:
    """Run ``iters`` LM iterations with the dense Schur complement: the
    right trade at local-BA window sizes (P up to a few tens)."""
    P = prob.R.shape[0]
    dev, f32 = prob.X.device, prob.X.dtype
    free_pose = ~prob.pose_fixed
    G = torch.nn.functional.one_hot(prob.obs_pose, P).to(f32)  # [L, D, P]
    ar = torch.arange(P, device=dev)
    keep = (free_pose[:, None] & free_pose[None, :]).to(f32)
    fixed_blk = torch.where(prob.pose_fixed[:, None, None],
                            torch.eye(6, dtype=f32, device=dev), 0.0)

    def reduced_step(wJp, Jp, e, Y, Hll_inv, bl, lam):
        Hpp = torch.einsum("ldri,ldrj,ldp->pij", wJp, Jp, G)
        bp = torch.einsum("ldri,ldr,ldp->pi", wJp, e, G)
        # Schur: S[p,q] -= sum_l (sum_{d->p} Y H^-1)_l (sum_{c->q} Y)_l^T
        A = torch.einsum("ldp,ldik->lpik", G, Y @ Hll_inv[:, None])
        Bm = torch.einsum("ldp,ldjk->lpjk", G, Y)
        S_off = torch.einsum("lpik,lqjk->pqij", A, Bm)
        diag_pp = torch.diagonal(Hpp, dim1=-2, dim2=-1).clamp(min=1e-6)
        Hpp_d = Hpp + lam * torch.diag_embed(diag_pp)
        S = -S_off
        S[ar, ar] += Hpp_d
        b_s = bp - torch.einsum("lpik,lk->pi", A, bl)
        # fixed poses: identity row/column block, zero right-hand side
        S = S * keep[..., None, None]
        S[ar, ar] += fixed_blk
        b_s = torch.where(prob.pose_fixed[:, None], 0.0, b_s)
        S_mat = S.permute(0, 2, 1, 3).reshape(P * 6, P * 6)
        sol, _ = torch.linalg.solve_ex(S_mat, b_s.reshape(P * 6, 1))
        return -sol.reshape(P, 6)

    return _lm_iterations(cam, prob, iters, robust, init_lambda, reduced_step)


def ba_solve_cg(cam: CamParams, prob: BAProblem, iters: int = 10,
                cg_iters: int = 40, robust: bool = True,
                init_lambda=1e-4) -> BAResult:
    """LM bundle adjustment for maps of many keyframes: the reduced camera
    system is never assembled. Per LM step the Schur product
    S v = Hpp v - Hpl Hll^-1 Hlp v goes through the landmark-major
    observation table (only the pose side needs segment sums), inside
    ``cg_iters`` iterations of conjugate gradients preconditioned by the
    inverse 6x6 pose blocks. Memory is O(L D) (reference:
    GlobalBundleAdjustemnt Optimizer.cc:41-255). The segment sums are
    float32 index_add: on a CUDA device their order, and so the last bits
    of the result, vary from run to run."""
    P = prob.R.shape[0]
    dev, f32 = prob.X.device, prob.X.dtype
    flat_pose = prob.obs_pose.reshape(-1)
    free = (~prob.pose_fixed)[:, None]
    eye6 = torch.eye(6, dtype=f32, device=dev)

    def to_poses(per_obs):  # [L, D, ...] -> [P, ...] summed by pose
        out = torch.zeros((P, *per_obs.shape[2:]), dtype=f32, device=dev)
        return out.index_add(0, flat_pose, per_obs.flatten(0, 1))

    def reduced_step(wJp, Jp, e, Y, Hll_inv, bl, lam):
        Hpp = to_poses(torch.einsum("ldri,ldrj->ldij", wJp, Jp))
        bp = to_poses(torch.einsum("ldri,ldr->ldi", wJp, e))
        diag_pp = torch.diagonal(Hpp, dim1=-2, dim2=-1).clamp(min=1e-6)
        Hpp_d = Hpp + lam * torch.diag_embed(diag_pp)
        Hpp_d = torch.where(free[..., None], Hpp_d, eye6)
        Minv = torch.linalg.inv(Hpp_d)  # block-Jacobi preconditioner

        def hpl_hll_inv(a):  # Hpl Hll^-1 a for a [L, 3]
            y = (Hll_inv @ a[..., None])[..., 0]
            return to_poses(torch.einsum("ldij,lj->ldi", Y, y))

        def S_mv(v):
            a = torch.einsum("ldij,ldi->lj", Y, v[prob.obs_pose])
            out = (Hpp_d @ v[..., None])[..., 0] - hpl_hll_inv(a)
            return torch.where(free, out, v)

        rhs = -torch.where(free, bp - hpl_hll_inv(bl), 0.0)
        x = block_pcg(S_mv, Minv, rhs, cg_iters)
        return torch.where(free, x, 0.0)

    return _lm_iterations(cam, prob, iters, robust, init_lambda, reduced_step)
