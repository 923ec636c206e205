"""Landmark-sharded bundle adjustment over a process group (port of
parallel/dist_ba.py).

Each rank holds L / world landmark rows and their observation rows; the
poses are replicated. Every rank builds the partial pose-side normal
equations of its shard (Hpp, bp, the Schur off-diagonal S_off, b_corr and
chi2), the partials are summed with one all-reduce (the JAX package's
psum over its mesh axis), the damped reduced camera system is solved on
every rank, and the landmark back-substitution stays on its own shard.

``group`` is a torch.distributed process group, None for the default
one; without an initialized default group the routines run as a world of
one. The segment sums are ``index_add_``: on a CUDA device their order is
not fixed, so two runs may differ in the last bits.
"""
from __future__ import annotations

import torch

from ..geometry import se3
from ..optim.ba import BAProblem, _inv3x3
from ..optim.residuals import (HUBER_MONO, HUBER_STEREO, huber_weight,
                               reproj_jacobians)
from ._group import gather_rows, psum_all, rank_and_size, shard_rows


def _damp(H: torch.Tensor, lam, eps: float) -> torch.Tensor:
    diag = torch.diagonal(H, dim1=-2, dim2=-1).clamp(min=eps)
    return H + lam * torch.diag_embed(diag)


def world_size(group=None) -> int:
    """The number of ranks the problem is sharded over."""
    return rank_and_size(group)[1]


def shard_problem(prob: BAProblem, group=None) -> BAProblem:
    """This rank's shard of a whole problem: its block of landmark rows and
    their observation rows, the poses replicated. L must divide by the
    world size."""
    rows = shard_rows(prob.X.shape[0], group)
    return prob._replace(X=prob.X[rows], obs_pose=prob.obs_pose[rows],
                         obs_uvr=prob.obs_uvr[rows], obs_w=prob.obs_w[rows],
                         point_valid=prob.point_valid[rows])


def gather_points(X: torch.Tensor, group=None) -> torch.Tensor:
    """The whole [L, 3] landmark table from every rank's shard."""
    return gather_rows(X, group)


def ba_step_sharded(cam, prob: BAProblem, group=None, lam=1e-4,
                    robust: bool = True):
    """One Gauss-Newton/LM step with the landmark-sharded Schur reduction.
    ``prob`` is this rank's shard (shard_problem). Returns (R, t, this
    rank's X, the whole problem's chi2 before the step)."""
    P = prob.R.shape[0]
    dev, f32 = prob.X.device, prob.X.dtype
    free_pose = ~prob.pose_fixed
    delta_h = torch.where(prob.obs_uvr[..., 2] >= 0, HUBER_STEREO, HUBER_MONO)
    active = (prob.obs_w > 0) & prob.point_valid[:, None]
    obs_pose = prob.obs_pose.long()
    e, Jp, Jl = reproj_jacobians(cam, prob.R[obs_pose], prob.t[obs_pose],
                                 prob.X[:, None, :], prob.obs_uvr)
    chi2_i = (e * e).sum(-1) * prob.obs_w
    w_rob = (huber_weight(chi2_i, delta_h) if robust
             else torch.ones_like(chi2_i))
    w = torch.where(active, prob.obs_w * w_rob, 0.0)
    Jp = Jp * free_pose[obs_pose].to(f32)[..., None, None]
    wJp = w[..., None, None] * Jp
    wJl = w[..., None, None] * Jl
    Hll = torch.einsum("ldri,ldrj->lij", wJl, Jl)
    bl = torch.einsum("ldri,ldr->li", wJl, e)
    Y = torch.einsum("ldri,ldrj->ldij", wJp, Jl)
    flat_pose = obs_pose.reshape(-1)

    def seg(vals, idx, n):
        return torch.zeros((n, *vals.shape[1:]), dtype=f32,
                           device=dev).index_add_(0, idx, vals)

    Hpp = seg(torch.einsum("ldri,ldrj->ldij", wJp, Jp).reshape(-1, 6, 6),
              flat_pose, P)
    bp = seg(torch.einsum("ldri,ldr->ldi", wJp, e).reshape(-1, 6),
             flat_pose, P)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    Hll_d = torch.where(prob.point_valid[:, None, None],
                        _damp(Hll, lam, 1e-6), eye3)
    Hll_inv = _inv3x3(Hll_d)
    YHinv = torch.einsum("ldij,ljk->ldik", Y, Hll_inv)
    pair = torch.einsum("ldik,lcjk->ldcij", YHinv, Y)
    pair_idx = (obs_pose[:, :, None] * P + obs_pose[:, None, :]).reshape(-1)
    S_off = seg(pair.reshape(-1, 6, 6), pair_idx, P * P).reshape(P, P, 6, 6)
    b_corr = seg(torch.einsum("ldik,lk->ldi", YHinv, bl).reshape(-1, 6),
                 flat_pose, P)
    chi2 = torch.where(active, chi2_i, 0.0).sum()

    # the partial pose-side systems of every shard, summed
    Hpp, bp, S_off, b_corr, chi2 = psum_all([Hpp, bp, S_off, b_corr, chi2],
                                            group)

    ar = torch.arange(P, device=dev)
    S = -S_off
    S[ar, ar] += _damp(Hpp, lam, 1e-6)
    b_s = bp - b_corr
    keep = (free_pose[:, None] & free_pose[None, :]).to(f32)
    S = S * keep[..., None, None]
    eye6 = torch.eye(6, dtype=f32, device=dev)
    S[ar, ar] = torch.where(prob.pose_fixed[:, None, None], eye6, S[ar, ar])
    b_s = torch.where(prob.pose_fixed[:, None], 0.0, b_s)
    S_mat = S.permute(0, 2, 1, 3).reshape(P * 6, P * 6)
    dxi = -torch.linalg.solve_ex(S_mat, b_s.reshape(P * 6, 1))[0].reshape(
        P, 6)

    # the landmark back-substitution, on this rank's shard
    Yt_dxi = torch.einsum("ldij,ldi->lj", Y, dxi[obs_pose])
    dX = -(Hll_inv @ (bl + Yt_dxi)[..., None])[..., 0]
    dX = torch.where(prob.point_valid[:, None], dX, 0.0)
    R_new, t_new = se3.retract(prob.R, prob.t, dxi)
    return R_new, t_new, prob.X + dX, chi2


def ba_solve_sharded(cam, prob: BAProblem, group=None, iters: int = 5,
                     lam=1e-4, robust: bool = True):
    """Fixed-iteration sharded BA that takes every step at the damping
    ``lam`` (a fixed schedule needs no host decision per iteration; the
    single-device optim.ba.ba_solve keeps its adaptive accept/reject, and
    runs this schedule with ``accept_all=True``). ``prob`` is this rank's
    shard. Returns (R, t, this rank's X, chi2 before the last step)."""
    R, t, X = prob.R, prob.t, prob.X
    chi2 = None
    for _ in range(iters):
        R, t, X, chi2 = ba_step_sharded(
            cam, prob._replace(R=R, t=t, X=X), group, lam, robust)
    return R, t, X, chi2
