"""Edge-sharded Sim(3) pose-graph optimization over a process group (port
of parallel/dist_pose_graph.py; reference: Optimizer::
OptimizeEssentialGraph, Optimizer.cc:829-1118).

Each rank holds E / world edges and evaluates their residuals and
Jacobians (optim.pose_graph.edge_jacobians, the forward-mode derivatives
the single-device optimize_pose_graph takes) into a partial dense normal
system [N, 7, N, 7]; the partial H, b and chi2 are summed with one
all-reduce; the small dense solve and the Sim3 retraction run identically
on every rank, where the vertices are replicated.
"""
from __future__ import annotations

import torch

from ..geometry import sim3
from ..optim.pose_graph import (PoseGraphProblem, PoseGraphResult,
                                edge_jacobians)
from ._group import psum_all, shard_rows


def shard_edges(prob: PoseGraphProblem, group=None) -> PoseGraphProblem:
    """This rank's block of edges; E must divide by the world size."""
    rows = shard_rows(prob.e_i.shape[0], group)
    return prob._replace(e_i=prob.e_i[rows], e_j=prob.e_j[rows],
                         m_R=prob.m_R[rows], m_t=prob.m_t[rows],
                         m_s=prob.m_s[rows], e_valid=prob.e_valid[rows])


def pose_graph_step_sharded(prob: PoseGraphProblem, group=None,
                            lam: float = 1e-16, fix_scale: bool = False):
    """One edge-sharded Gauss-Newton step; ``prob`` holds this rank's
    edges (shard_edges). Returns (R, t, s, chi2 before the step)."""
    N = prob.R.shape[0]
    Rv, tv, sv = prob.R, prob.t, prob.s
    dev, dt = Rv.device, Rv.dtype
    ei, ej = prob.e_i.long(), prob.e_j.long()
    free = (~prob.v_fixed).to(dt)
    e, Ji, Jj = edge_jacobians(Rv[ei], tv[ei], sv[ei], Rv[ej], tv[ej],
                               sv[ej], prob.m_R, prob.m_t, prob.m_s)
    Ji = Ji * free[ei][:, None, None]
    Jj = Jj * free[ej][:, None, None]
    if fix_scale:
        Ji = torch.cat([Ji[..., :6], torch.zeros_like(Ji[..., 6:])], -1)
        Jj = torch.cat([Jj[..., :6], torch.zeros_like(Jj[..., 6:])], -1)
    w_edge = prob.e_valid.to(dt)
    wJi = Ji * w_edge[:, None, None]
    wJj = Jj * w_edge[:, None, None]
    Hij = torch.einsum("eri,erj->eij", wJi, Jj)
    blocks = torch.cat([torch.einsum("eri,erj->eij", wJi, Ji),
                        torch.einsum("eri,erj->eij", wJj, Jj),
                        Hij, Hij.transpose(-1, -2)])
    seg = torch.cat([ei * N + ei, ej * N + ej, ei * N + ej, ej * N + ei])
    H = torch.zeros((N * N, 7, 7), dtype=dt, device=dev).index_add_(
        0, seg, blocks).reshape(N, N, 7, 7)
    b = torch.zeros((N, 7), dtype=dt, device=dev).index_add_(
        0, torch.cat([ei, ej]),
        torch.cat([torch.einsum("eri,er->ei", wJi, e),
                   torch.einsum("eri,er->ei", wJj, e)]))
    chi2 = (e * e * w_edge[:, None]).sum()

    # the partial systems of every edge shard, summed
    H, b, chi2 = psum_all([H, b, chi2], group)

    ar = torch.arange(N, device=dev)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    diag = (lam + 1e-8) * eye7 + prob.v_fixed.to(dt)[:, None, None] * eye7
    if fix_scale:
        diag = diag + torch.diag_embed(
            (torch.arange(7, device=dev) == 6).to(dt))
    H[ar, ar] += diag
    b = b * free[:, None]
    H_mat = H.permute(0, 2, 1, 3).reshape(N * 7, N * 7)
    dxi = -torch.linalg.solve_ex(H_mat, b.reshape(N * 7, 1))[0].reshape(N, 7)
    if fix_scale:
        dxi = torch.cat([dxi[:, :6], torch.zeros_like(dxi[:, 6:])], -1)
    dxi = dxi * free[:, None]
    R_new, t_new, s_new = sim3.retract(Rv, tv, sv, dxi)
    ok = torch.isfinite(dxi).all()
    return (torch.where(ok, R_new, Rv), torch.where(ok, t_new, tv),
            torch.where(ok, s_new, sv), chi2)


def optimize_pose_graph_sharded(prob: PoseGraphProblem, group=None,
                                iters: int = 20,
                                fix_scale: bool = False) -> PoseGraphResult:
    """Fixed-iteration edge-sharded pose-graph optimization (the
    reference's 20 Gauss-Newton iterations, Optimizer.cc:1057), every
    finite step taken. ``prob`` holds this rank's edges; chi2 is the whole
    graph's before the last step."""
    R, t, s = prob.R, prob.t, prob.s
    chi2 = torch.zeros((), dtype=R.dtype, device=R.device)
    for _ in range(iters):
        R, t, s, chi2 = pose_graph_step_sharded(
            prob._replace(R=R, t=t, s=s), group, fix_scale=fix_scale)
    return PoseGraphResult(R, t, s, chi2)
