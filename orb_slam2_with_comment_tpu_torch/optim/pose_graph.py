"""Sim(3) pose-graph (essential graph) optimization (port of
optim/pose_graph.py; reference: Optimizer::OptimizeEssentialGraph,
Optimizer.cc:829-1118).

Vertices are world->keyframe Sim3 poses, edges relative Sim3 measurements
with error log(S_ji^-1 S_jw S_iw^-1) and identity information. Each
Gauss-Newton/LM iteration takes the edge Jacobians by forward-mode
derivatives at zero updates (one tangent per coordinate of either
endpoint, as jax.jacfwd). ``optimize_pose_graph`` assembles the dense
[7N, 7N] system and solves it; ``optimize_pose_graph_cg`` applies the
Hessian edge by edge inside preconditioned conjugate gradients, for graphs
of hundreds of vertices. ``fix_scale`` freezes the scale coordinate
(stereo/RGB-D).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp

from ..geometry import sim3
from .pcg import block_pcg


class PoseGraphProblem(NamedTuple):
    R: torch.Tensor  # [N, 3, 3] world->keyframe Sim3 vertices
    t: torch.Tensor  # [N, 3]
    s: torch.Tensor  # [N]
    e_i: torch.Tensor  # [E] long from-vertex
    e_j: torch.Tensor  # [E] long to-vertex
    m_R: torch.Tensor  # [E, 3, 3] measurement S_ji
    m_t: torch.Tensor  # [E, 3]
    m_s: torch.Tensor  # [E]
    e_valid: torch.Tensor  # [E] bool
    v_fixed: torch.Tensor  # [N] bool


class PoseGraphResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    chi2: torch.Tensor


def _edge_residual(Ri, ti, si, Rj, tj, sj, mR, mt, ms):
    """e = log(S_ji^meas^-1 * S_jw * S_iw^-1)  [..., 7]."""
    Rji, tji, sji = sim3.compose(Rj, tj, sj, *sim3.inverse(Ri, ti, si))
    return sim3.log(*sim3.compose(*sim3.inverse(mR, mt, ms), Rji, tji, sji))


def edge_jacobians(Ri, ti, si, Rj, tj, sj, mR, mt, ms):
    """(e [E, 7], Ji [E, 7, 7], Jj [E, 7, 7]): residuals and their
    Jacobians wrt left updates of vertex i and vertex j, at zero."""
    E = Ri.shape[0]
    dev, dt = Ri.device, Ri.dtype

    def rep(a):
        return a.expand(14, *a.shape)

    args = [rep(a) for a in (Ri, ti, si, Rj, tj, sj, mR, mt, ms)]

    def f(xi_i, xi_j):
        Ri2, ti2, si2 = sim3.retract(args[0], args[1], args[2], xi_i)
        Rj2, tj2, sj2 = sim3.retract(args[3], args[4], args[5], xi_j)
        return _edge_residual(Ri2, ti2, si2, Rj2, tj2, sj2, *args[6:])

    eye = torch.eye(7, dtype=dt, device=dev)[:, None].expand(7, E, 7)
    zero = torch.zeros((7, E, 7), dtype=dt, device=dev)
    e, J = jvp(f, (torch.zeros((14, E, 7), dtype=dt, device=dev),) * 2,
               (torch.cat([eye, zero]), torch.cat([zero, eye])))
    J = J.permute(1, 2, 0)  # [E, 7 residual, 14 coordinates]
    return e[0], J[..., :7], J[..., 7:]


def optimize_pose_graph(prob: PoseGraphProblem, iters: int = 20,
                        fix_scale: bool = False,
                        accept_all: bool = False) -> PoseGraphResult:
    """Dense Gauss-Newton/LM over the whole graph. ``accept_all``: take
    every finite step at the fixed damping 1e-16 (the schedule of
    parallel.dist_pose_graph)."""
    N = prob.R.shape[0]
    dev, dt = prob.R.device, prob.R.dtype
    ei, ej = prob.e_i.long(), prob.e_j.long()
    meas = (prob.m_R, prob.m_t, prob.m_s)
    free = (~prob.v_fixed).to(dt)
    w_edge = prob.e_valid.to(dt)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    scale_fix = torch.zeros((7, 7), dtype=dt, device=dev)
    scale_fix[6, 6] = 1.0
    keep7 = torch.ones(7, dtype=dt, device=dev)
    if fix_scale:
        keep7[6] = 0.0
    ar = torch.arange(N, device=dev)
    seg = torch.cat([ei * N + ei, ej * N + ej, ei * N + ej, ej * N + ei])

    def residual(Rv, tv, sv):
        return _edge_residual(Rv[ei], tv[ei], sv[ei], Rv[ej], tv[ej], sv[ej],
                              *meas)

    Rv, tv, sv = prob.R, prob.t, prob.s
    lam = torch.tensor(1e-16, dtype=dt, device=dev)
    for _ in range(iters):
        e, Ji, Jj = edge_jacobians(Rv[ei], tv[ei], sv[ei], Rv[ej], tv[ej],
                                   sv[ej], *meas)
        Ji = torch.where(keep7 > 0, Ji * free[ei][:, None, None], 0.0)
        Jj = torch.where(keep7 > 0, Jj * free[ej][:, None, None], 0.0)
        wJi = Ji * w_edge[:, None, None]
        wJj = Jj * w_edge[:, None, None]
        Hij = torch.einsum("eri,erj->eij", wJi, Jj)
        blocks = torch.cat([torch.einsum("eri,erj->eij", wJi, Ji),
                            torch.einsum("eri,erj->eij", wJj, Jj),
                            Hij, Hij.transpose(-1, -2)])
        H = torch.zeros((N * N, 7, 7), dtype=dt, device=dev).index_add(
            0, seg, blocks).reshape(N, N, 7, 7)
        b = torch.zeros((N, 7), dtype=dt, device=dev).index_add(
            0, torch.cat([ei, ej]),
            torch.cat([torch.einsum("eri,er->ei", wJi, e),
                       torch.einsum("eri,er->ei", wJj, e)]))
        # damping and gauge: fixed vertices (and the scale coordinate when
        # fixed) get an identity diagonal so the dense solve stays regular
        diag = (lam + 1e-8) * eye7 + prob.v_fixed.to(dt)[:, None, None] * eye7
        if fix_scale:
            diag = diag + scale_fix
        H[ar, ar] += diag
        b = b * free[:, None]
        H_mat = H.permute(0, 2, 1, 3).reshape(N * 7, N * 7)
        dxi = -torch.linalg.solve_ex(H_mat, b.reshape(N * 7, 1))[0].reshape(
            N, 7)
        dxi = torch.where(keep7 > 0, dxi, 0.0) * free[:, None]
        R_new, t_new, s_new = sim3.retract(Rv, tv, sv, dxi)
        chi2_old = (e * e * w_edge[:, None]).sum()
        e_new = residual(R_new, t_new, s_new)
        chi2_new = (e_new * e_new * w_edge[:, None]).sum()
        ok = torch.isfinite(dxi).all()
        if not accept_all:
            ok = ok & (chi2_new < chi2_old)
        Rv = torch.where(ok, R_new, Rv)
        tv = torch.where(ok, t_new, tv)
        sv = torch.where(ok, s_new, sv)
        if not accept_all:
            lam = torch.where(ok, lam * 0.5, lam * 10.0).clamp(1e-16, 1e8)
    e = residual(Rv, tv, sv)
    return PoseGraphResult(Rv, tv, sv, (e * e * w_edge[:, None]).sum())


def optimize_pose_graph_cg(prob: PoseGraphProblem, iters: int = 20,
                           fix_scale: bool = False,
                           cg_iters: int | None = None) -> PoseGraphResult:
    """The same Gauss-Newton/LM iterations without the dense matrix: each
    step is solved by conjugate gradients preconditioned with the inverse
    7x7 vertex blocks, the Hessian applied as sum_e J_e^T (J_e v), memory
    O(E). ``cg_iters`` defaults to max(60, 2N): block-Jacobi CG carries a
    correction about one vertex per iteration along the temporal chain,
    and a loop correction is a global mode. The segment sums are float32
    index_add: on a CUDA device their order, and so the last bits of the
    result, vary from run to run."""
    N = prob.R.shape[0]
    if cg_iters is None:
        cg_iters = max(60, 2 * N)
    dev, dt = prob.R.device, prob.R.dtype
    ei, ej = prob.e_i.long(), prob.e_j.long()
    ends = torch.cat([ei, ej])  # vertex of each (edge, endpoint) block
    E = ei.shape[0]
    meas = (prob.m_R, prob.m_t, prob.m_s)
    free = (~prob.v_fixed).to(dt)
    w_edge = prob.e_valid.to(dt)
    sw = torch.sqrt(w_edge)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    keep7 = torch.ones(7, dtype=dt, device=dev)
    if fix_scale:
        keep7[6] = 0.0

    def residual(Rv, tv, sv):
        return _edge_residual(Rv[ei], tv[ei], sv[ei], Rv[ej], tv[ej], sv[ej],
                              *meas)

    def to_vertices(per_block):  # [2E, ...] -> [N, ...]
        out = torch.zeros((N, *per_block.shape[1:]), dtype=dt, device=dev)
        return out.index_add(0, ends, per_block)

    Rv, tv, sv = prob.R, prob.t, prob.s
    lam = torch.tensor(1e-16, dtype=dt, device=dev)
    for _ in range(iters):
        e, Ji, Jj = edge_jacobians(Rv[ei], tv[ei], sv[ei], Rv[ej], tv[ej],
                                   sv[ej], *meas)
        # both endpoints' blocks stacked [2E, 7, 7], the edge weights folded
        # in so that H = J^T J
        J = torch.cat([Ji, Jj]) * (free[ends] * sw.repeat(2))[:, None, None]
        J = torch.where(keep7 > 0, J, 0.0)
        ew = (e * sw[:, None]).repeat(2, 1)
        b = to_vertices(torch.einsum("eri,er->ei", J, ew)) * free[:, None]
        reg = (lam + 1e-8) * eye7 + prob.v_fixed.to(dt)[:, None, None] * eye7
        if fix_scale:
            reg = reg + torch.diag(1.0 - keep7)
        Minv = torch.linalg.inv(
            to_vertices(torch.einsum("eri,erj->eij", J, J)) + reg)

        def Hmv(v):
            u = torch.einsum("eij,ej->ei", J, v[ends])
            u = (u[:E] + u[E:]).repeat(2, 1)
            return (to_vertices(torch.einsum("eri,er->ei", J, u))
                    + (reg @ v[..., None])[..., 0])

        x = block_pcg(Hmv, Minv, -b, cg_iters)
        dxi = torch.where(keep7 > 0, x, 0.0) * free[:, None]
        R_new, t_new, s_new = sim3.retract(Rv, tv, sv, dxi)
        chi2_old = (e * e * w_edge[:, None]).sum()
        e_new = residual(R_new, t_new, s_new)
        chi2_new = (e_new * e_new * w_edge[:, None]).sum()
        ok = (chi2_new < chi2_old) & torch.isfinite(dxi).all()
        Rv = torch.where(ok, R_new, Rv)
        tv = torch.where(ok, t_new, tv)
        sv = torch.where(ok, s_new, sv)
        lam = torch.where(ok, lam * 0.5, lam * 10.0).clamp(1e-16, 1e8)
    e = residual(Rv, tv, sv)
    return PoseGraphResult(Rv, tv, sv, (e * e * w_edge[:, None]).sum())
