"""Loop closing for the autonomous tracker (port of pipeline/auto_loop.py).

BoW detection with covisibility consistency, Sim3 RANSAC and refinement,
Sim3 propagation, essential-graph optimization and a bounded global BA,
as functions of tensors. The JAX package runs them as lax.cond branches
of one program; here the host reads the few scalars that decide them
(the detected candidate, the Sim3 gate, the 40-match gate) and runs only
the branch taken. Reference semantics (LoopClosing.cc):

- at least 10 keyframes since the last loop (:116);
- candidate score >= the least BoW score of the current keyframe's
  covisible keyframes (:126-140); group scores over each candidate's
  top-10 covisibility group, kept above 0.75 of the best
  (KeyFrameDatabase.cc:151-176);
- covisibility consistency over 3 consecutive keyframes (:43, 164-244);
- Sim3: >= 20 matches, RANSAC >= 20 inliers, refinement >= 20 (:333,
  342, 408), then >= 40 matches with the loop group's landmarks (:471);
- correction (CorrectLoop :509-719).

Only maps of at most 64 keyframes run here: the top-k essential-graph
edges, the CG pose graph and the CG global BA of larger maps are not
ported (ROADMAP.md, Queue 1 item 2).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3, sim3
from ..mapstate.map import (MapState, covisibility_matrix,
                            covisibility_weights, merge_landmarks,
                            rebuild_observations)
from ..matching import search as msearch
from ..ops.fast import sort_top_k
from ..optim import ba, pose_graph, sim3_opt
from ..place import vocabulary as V
from ..solvers import sim3solver
from . import steps

C_MAX = 4  # candidate groups tracked for consistency
CONSISTENCY_TH = 3  # reference mnCovisibilityConsistencyTh
MIN_GAP = 10  # keyframes between loops (reference LoopClosing.cc:116)
K_DENSE_MAX = 64  # the dense essential graph and global BA; beyond: not ported
SEED = 7  # the JAX package's loop carry starts from PRNGKey(7)
I32 = torch.int32


class LoopCarry(NamedTuple):
    """Loop-closing state of the tracker."""
    bow_idx: torch.Tensor  # [K, T] int32 sparse BoW word ids, -1 padded
    bow_w: torch.Tensor  # [K, T] float32 tf-idf weights
    prev_groups: torch.Tensor  # [C_MAX, K] bool last keyframe's groups
    prev_counts: torch.Tensor  # [C_MAX] int32 consistency chain lengths
    last_loop_kf: int  # keyframe slot of the last closed loop
    n_loops: int
    gen: torch.Generator  # draws of the Sim3 and relocalization RANSAC
    loop_edges: torch.Tensor  # [K, K] bool accepted loop edges (i < j)


def new_generator(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(SEED)


def warm_up_autodiff() -> None:
    """Run forward-mode AD once through a product with a Python scalar:
    the first such product in a process imports torch._dynamo, seconds of
    host time (7.3 s of the first loop closure on an H100 machine's host).
    The Sim3 refinement and the pose graph take their Jacobians that way,
    so a tracker calls this when it is built, not at its first loop
    closure."""
    torch.func.jvp(lambda x: x * 2.0, (torch.zeros(1),), (torch.ones(1),))


def empty_loop_carry(k_max: int, bow_cap: int, device,
                     gen: torch.Generator | None = None) -> LoopCarry:
    """bow_cap: sparse-row capacity, lossless at >= n_feat. ``gen``: the
    generator to carry on with (a fresh one seeded with SEED if None)."""
    return LoopCarry(
        bow_idx=torch.full((k_max, bow_cap), -1, dtype=I32, device=device),
        bow_w=torch.zeros((k_max, bow_cap), device=device),
        prev_groups=torch.zeros((C_MAX, k_max), dtype=torch.bool,
                                device=device),
        prev_counts=torch.zeros(C_MAX, dtype=I32, device=device),
        last_loop_kf=-MIN_GAP, n_loops=0,
        gen=gen if gen is not None else new_generator(device),
        loop_edges=torch.zeros((k_max, k_max), dtype=torch.bool,
                               device=device))


def permute_loop_carry(loop: LoopCarry, order, rank, valid) -> LoopCarry:
    """Mirror compact_keyframes in the loop state: BoW rows, consistency
    groups and loop edges follow the live-first permutation ``order``
    (new->old); ``rank`` maps old slots to new ones, ``valid`` is the
    liveness before compaction. A culled last-loop keyframe drops to the
    no-loop-yet value -MIN_GAP."""
    K = loop.bow_idx.shape[0]
    live_new = valid[order]
    edges = loop.loop_edges[order][:, order]
    last = loop.last_loop_kf
    if 0 <= last < K and bool(valid[last]):
        last = int(rank[last])
    elif last >= 0:
        last = -MIN_GAP
    return loop._replace(
        bow_idx=torch.where(live_new[:, None], loop.bow_idx[order], -1),
        bow_w=torch.where(live_new[:, None], loop.bow_w[order], 0.0),
        prev_groups=loop.prev_groups[:, order] & live_new[None, :],
        loop_edges=edges & live_new[:, None] & live_new[None, :],
        last_loop_kf=last)


def add_keyframe_bow(loop: LoopCarry, voc: V.Vocabulary, kf: int, desc,
                     valid) -> LoopCarry:
    """Store keyframe ``kf``'s sparse BoW row (KeyFrame::ComputeBoW +
    KeyFrameDatabase::add)."""
    idx, w = V.bow_sparse(voc, V.transform(voc, desc, valid), valid,
                          loop.bow_idx.shape[1])
    bow_idx = loop.bow_idx.clone()
    bow_w = loop.bow_w.clone()
    bow_idx[kf] = idx
    bow_w[kf] = w
    return loop._replace(bow_idx=bow_idx, bow_w=bow_w)


def detect(loop: LoopCarry, m: MapState, kf: int,
           n_words: int) -> tuple[int, LoopCarry]:
    """DetectLoop: (candidate slot or -1, carry with the new groups)."""
    K = loop.bow_idx.shape[0]
    dev = loop.bow_idx.device
    ids = torch.arange(K, dtype=I32, device=dev)
    W_cov = covisibility_matrix(m)
    covis_row = W_cov[kf] > 0
    s = V.score_l1_sparse(loop.bow_idx[kf], loop.bow_w[kf], loop.bow_idx,
                          loop.bow_w, n_words)
    live = m.kf_valid & (ids != kf) & (ids < m.n_kf)
    covis_live = covis_row & live
    min_score = torch.where(covis_live.any(),
                            torch.where(covis_live, s, float("inf")).min(),
                            0.5).clamp(min=0.0)
    gated = live & ~covis_row & (s >= min_score)
    s_gated = torch.where(gated, s, -1.0)
    top_w, top_i = sort_top_k(W_cov, 10)  # [K, 10] each candidate's group
    grp = s_gated[top_i]
    acc = torch.where((top_w > 0) & (grp > 0), grp, 0.0).sum(1) \
        + s_gated.clamp(min=0.0)
    acc = torch.where(gated, acc, -1.0)
    keep = gated & (acc > 0.75 * acc.max())
    cand_s, cand_i = sort_top_k(torch.where(keep, s, -1.0), C_MAX)
    cand_ok = cand_s > 0
    groups = (((W_cov[cand_i] > 0) | (cand_i[:, None] == ids[None, :]))
              & cand_ok[:, None])  # [C, K]
    inter = (groups[:, None, :] & loop.prev_groups[None, :, :]).any(2)
    counts = torch.where(inter, loop.prev_counts[None, :] + 1, 0).amax(1)
    accepted = cand_ok & (counts + 1 >= CONSISTENCY_TH)
    gap_ok = kf - loop.last_loop_kf >= MIN_GAP
    if not gap_ok:  # the gap gate also clears the groups
        groups = torch.zeros_like(groups)
        counts = torch.zeros_like(counts)
    first = [i for i, a in enumerate(accepted.tolist()) if a]
    cand = int(cand_i[first[0]]) if gap_ok and first else -1
    return cand, loop._replace(prev_groups=groups,
                               prev_counts=counts.to(I32))


def _kf_landmark_set(m: MapState, kf: int):
    """Keyframe ``kf``'s per-feature landmark bundle and its mask."""
    lm = m.kf_lm[kf]
    safe = lm.clamp(min=0).long()
    has = (lm >= 0) & m.kf_feat_valid[kf] & m.lm_valid[safe]
    return msearch.LandmarkSet(m.lm_pw[safe], m.lm_normal[safe],
                               m.lm_dmin[safe], m.lm_dmax[safe],
                               m.lm_desc[safe], has), has


def sim3_grow_matches(m: MapState, cam, kf: int, cand: int, idx, matched,
                      R12, t12, s12):
    """SearchBySim3 growth (LoopClosing.cc:400): mutual cross-projection
    matches through the RANSAC Sim3 fill the features the BoW matches left
    empty. Returns (grow_idx [N] feature of cand or -1, valid [N])."""
    lmset1, has1 = _kf_landmark_set(m, kf)
    lmset2, has2 = _kf_landmark_set(m, cand)
    idx21, mutual = msearch.search_by_sim3(
        cam, R12, t12, s12, m.kf_R[kf], m.kf_t[kf], m.kf_R[cand],
        m.kf_t[cand], lmset1, lmset2, steps._kf_featureset(m, kf),
        steps._kf_featureset(m, cand))
    grow = mutual & has1 & has2[idx21.clamp(min=0).long()]
    grow_idx = torch.where(matched, idx, torch.where(grow, idx21, -1))
    return grow_idx, grow_idx >= 0


def sim3_accept_gate(m: MapState, cam, kf: int, cand: int, R12, t12, s12,
                     already_feats, width: int, height: int,
                     lm_cap: int = 4096):
    """The final 40-match gate (LoopClosing.cc:440-480): the loop group's
    landmarks projected into keyframe ``kf`` through S12 T_cand_w
    (SearchByProjection th=10), plus the Sim3 matches ``already_feats``
    [N]. Returns the total number of distinct matched features."""
    K = m.kf_R.shape[0]
    w_cand = covisibility_weights(m, cand)
    loop_gm = (w_cand > 0) | (torch.arange(K, device=w_cand.device) == cand)
    obs = m.lm_obs_kf
    in_loop = ((loop_gm[obs.clamp(min=0).long()] & (obs >= 0)).any(1)
               & m.lm_valid)
    sel, g_ok = steps.gather_mask_indices(in_loop, min(lm_cap, in_loop.numel()))
    lmset = msearch.LandmarkSet(m.lm_pw[sel], m.lm_normal[sel],
                                m.lm_dmin[sel], m.lm_dmax[sel],
                                m.lm_desc[sel], g_ok)
    one = torch.ones((), device=R12.device)
    Rcw, tcw, scw = sim3.compose(R12, t12, s12, m.kf_R[cand], m.kf_t[cand],
                                 one)
    idx, ok = msearch.search_by_scw_projection(
        cam, Rcw, tcw, scw, lmset, steps._kf_featureset(m, kf),
        already_feats, width, height, th=10.0)
    N = m.kf_xy.shape[1]
    # distinct features: two landmarks may pick one feature in the sweep
    proj_feat = torch.zeros(N, dtype=I32, device=idx.device).index_add(
        0, idx.clamp(min=0).long(), ok.to(I32)) > 0
    return int(proj_feat.sum()) + int(already_feats.sum())


class Sim3Match(NamedTuple):
    ok: bool
    R: torch.Tensor  # [3, 3] refined R12
    t: torch.Tensor
    s: torch.Tensor
    lm_cur: torch.Tensor  # [N] landmark of the current keyframe or -1
    lm_cand: torch.Tensor  # [N] its matched loop landmark or -1
    pair_ok: torch.Tensor  # [N]
    matched_feats: torch.Tensor  # [N] features matched by the grown set


def sim3_solve(loop: LoopCarry, m: MapState, cam, kf: int, cand: int,
               fix_scale: bool) -> Sim3Match:
    """ComputeSim3 (LoopClosing.cc:291-487): brute Hamming match of the
    two keyframes' landmark features, Horn RANSAC (draws from loop.gen),
    SearchBySim3 growth, Sim3 refinement."""
    lm1, lm2 = m.kf_lm[kf], m.kf_lm[cand]
    l1 = lm1.clamp(min=0).long()
    has1 = (lm1 >= 0) & m.kf_feat_valid[kf] & m.lm_valid[l1]
    has2 = ((lm2 >= 0) & m.kf_feat_valid[cand]
            & m.lm_valid[lm2.clamp(min=0).long()])
    idx, _, matched = msearch.search_brute(
        m.kf_desc[kf], m.kf_desc[cand], has1, has2, ratio=0.75,
        angle_q=m.kf_angle[kf], angle_t=m.kf_angle[cand])
    n_matches = int(matched.sum())
    safe_idx = torch.where(matched, idx, 0).long()
    X1c = se3.transform(m.kf_R[kf], m.kf_t[kf], m.lm_pw[l1])
    X2c = se3.transform(m.kf_R[cand], m.kf_t[cand],
                        m.lm_pw[lm2[safe_idx].clamp(min=0).long()])
    s2_1 = msearch.sigma2_at(m.kf_octave[kf])
    valid = matched & has1
    K_cam = (cam.fx, cam.fy, cam.cx, cam.cy)
    res = sim3solver.solve_ransac(
        loop.gen, K_cam, K_cam, X1c, X2c, m.kf_xy[kf], m.kf_xy[cand][safe_idx],
        s2_1, msearch.sigma2_at(m.kf_octave[cand][safe_idx]), valid,
        max_iters=300, min_inliers=20, fix_scale=fix_scale)
    grow_idx, grown = sim3_grow_matches(m, cam, kf, cand, idx, matched,
                                        res.R, res.t, res.s)
    safe_g = grow_idx.clamp(min=0).long()
    l2g = lm2[safe_g].clamp(min=0).long()
    X2c_g = se3.transform(m.kf_R[cand], m.kf_t[cand], m.lm_pw[l2g])
    s2_2g = msearch.sigma2_at(m.kf_octave[cand][safe_g])
    valid_g = grown & has1
    ref = sim3_opt.optimize_sim3(
        K_cam, K_cam, res.R, res.t, res.s, X1c, X2c_g, m.kf_xy[kf],
        m.kf_xy[cand][safe_g], 1.0 / s2_1, 1.0 / s2_2g, valid_g, iters=10,
        fix_scale=fix_scale)
    ok = (n_matches >= 20 and int(res.n_inliers) >= 20
          and int(ref.n_inliers) >= 20)
    pair_ok = ref.inliers & valid_g & (l1 != l2g)
    return Sim3Match(ok, ref.R, ref.t, ref.s, torch.where(pair_ok, l1, -1),
                     torch.where(pair_ok, l2g, -1), pair_ok, valid_g)


def _essential_edges(m: MapState, kf: int, cand: int, loop_edges):
    """All keyframe pairs i < j with their validity and loop flag: loop
    edges (past and this one), the temporal chain over live slots and
    covisibility >= 100 (Optimizer.cc:908-1053)."""
    K = m.kf_R.shape[0]
    dev = m.kf_R.device
    W_cov = covisibility_matrix(m)
    live = m.kf_valid.to(I32)
    rank = torch.cumsum(live, 0, dtype=I32) - live
    iu, ju = np.triu_indices(K, k=1)
    e_i = torch.as_tensor(iu, dtype=torch.long, device=dev)
    e_j = torch.as_tensor(ju, dtype=torch.long, device=dev)
    is_loop = (((e_i == min(kf, cand)) & (e_j == max(kf, cand)))
               | loop_edges[e_i, e_j] | loop_edges[e_j, e_i])
    both = m.kf_valid[e_i] & m.kf_valid[e_j]
    is_chain = both & (rank[e_j] == rank[e_i] + 1)
    e_valid = ((W_cov[e_i, e_j] >= 100) | is_loop | is_chain) & both
    return e_i, e_j, e_valid, is_loop


def correct_loop(m: MapState, cam, kf: int, cand: int, R12, t12, s12,
                 fix_scale: bool, lm_cur, lm_cand, pair_ok, loop_edges,
                 width: int, height: int) -> MapState:
    """CorrectLoop: Sim3 propagation over the current covisibility group,
    landmark correction, matched-pair Replace, SearchAndFuse, the
    essential graph and a bounded global BA."""
    K = m.kf_R.shape[0]
    if K > K_DENSE_MAX:
        raise NotImplementedError(
            "loop correction of maps with k_max > 64 (top-k essential-graph "
            "edges, optimize_pose_graph_cg, ba_solve_cg) is not ported: "
            "ROADMAP.md Queue 1 item 2")
    dev = m.kf_R.device
    one = torch.ones((), device=dev)
    ids = torch.arange(K, device=dev)
    # corrected current pose S_cur_w = S12 T_cand_w, and the world
    # correction G = S_cur_w_corr^-1 T_cur_w (old world -> new)
    Rc, tc, sc = sim3.compose(R12, t12, s12, m.kf_R[cand], m.kf_t[cand], one)
    Rg, tg, sg = sim3.compose(*sim3.inverse(Rc, tc, sc), m.kf_R[kf],
                              m.kf_t[kf], one)
    Rgi, tgi, sgi = sim3.inverse(Rg, tg, sg)
    w = covisibility_weights(m, kf)
    gm = (w > 0) | (ids == kf)
    # the edge measurements come from the uncorrected poses
    # (NonCorrectedSim3, LoopClosing.cc:546-580)
    R_old, t_old = m.kf_R, m.kf_t
    Ri, ti, si = sim3.compose(m.kf_R, m.kf_t, torch.ones(K, device=dev),
                              Rgi.expand(K, 3, 3), tgi.expand(K, 3),
                              sgi.expand(K))
    kf_R = torch.where(gm[:, None, None], Ri, m.kf_R)
    kf_t = torch.where(gm[:, None], ti / si.clamp(min=1e-9)[:, None], m.kf_t)
    # the full corrected Sim3 of each group vertex (CorrectedSim3,
    # :532-545); with fix_scale s12 is 1 and these equal the SE3 arrays
    t_sim = torch.where(gm[:, None], ti, m.kf_t)
    s_sim = torch.where(gm, si, torch.ones(K, device=dev))
    in_group = gm[m.lm_ref_kf.clamp(0, K - 1).long()] & m.lm_valid
    lm_pw = torch.where(in_group[:, None], sim3.transform(Rg, tg, sg, m.lm_pw),
                        m.lm_pw)
    m = m._replace(kf_R=kf_R, kf_t=kf_t, lm_pw=lm_pw)

    # matched-pair Replace (:638-661): the loop landmark wins
    rep_ok = pair_ok & (lm_cur >= 0) & (lm_cand >= 0) & (lm_cur != lm_cand)
    m = merge_landmarks(m, lm_cand.clamp(min=0).to(I32),
                        lm_cur.clamp(min=0).to(I32), rep_ok)

    # SearchAndFuse (:661-692, :725-754)
    w_cand = covisibility_weights(m, cand)
    loop_gm = (w_cand > 0) | (ids == cand)
    obs = m.lm_obs_kf
    in_loop = (loop_gm[obs.clamp(min=0).long()] & (obs >= 0)).any(1)
    top_w, top_i = sort_top_k(w, 15)
    group_kfs = [kf] + torch.where(top_w > 0, top_i, -1).tolist()
    m = steps.loop_search_and_fuse(m, cam, in_loop, group_kfs, width, height)

    # essential graph: pre-propagation measurements except on loop edges,
    # which carry the corrected full Sim3 (Optimizer.cc:925-931)
    e_i, e_j, e_valid, is_loop = _essential_edges(m, kf, cand, loop_edges)
    use_new = is_loop[:, None, None]
    R_i = torch.where(use_new, m.kf_R[e_i], R_old[e_i])
    t_i = torch.where(use_new[..., 0], t_sim[e_i], t_old[e_i])
    s_i = torch.where(is_loop, s_sim[e_i], 1.0)
    R_j = torch.where(use_new, m.kf_R[e_j], R_old[e_j])
    t_j = torch.where(use_new[..., 0], t_sim[e_j], t_old[e_j])
    s_j = torch.where(is_loop, s_sim[e_j], 1.0)
    mR, mt, ms = sim3.compose(R_j, t_j, s_j, *sim3.inverse(R_i, t_i, s_i))
    fixed = (ids == cand) | ~m.kf_valid
    res = pose_graph.optimize_pose_graph(
        pose_graph.PoseGraphProblem(m.kf_R, t_sim, s_sim, e_i, e_j, mR, mt,
                                    ms, e_valid, fixed),
        iters=20, fix_scale=fix_scale)
    # landmarks re-anchored through their reference keyframe: camera
    # coordinates under its initial Sim3, back to the world through the
    # optimized one (Optimizer.cc:1061-1080)
    ref = m.lm_ref_kf.clamp(0, K - 1).long()
    Xc = sim3.transform(m.kf_R[ref], t_sim[ref], s_sim[ref], m.lm_pw)
    pw = se3.transform(*se3.inverse(res.R[ref], res.t[ref]), Xc) \
        / res.s[ref].clamp(min=1e-9)[:, None]
    m = m._replace(kf_R=res.R,
                   kf_t=res.t / res.s.clamp(min=1e-9)[:, None],
                   lm_pw=torch.where(m.lm_valid[:, None], pw, m.lm_pw))

    # bounded global BA (LoopClosing.cc:795), keyframe 0 fixed
    kf_idx = m.lm_obs_kf.clamp(min=0).long()
    feat = m.lm_obs_feat.long()
    uvr = torch.cat([m.kf_xy[kf_idx, feat], m.kf_ur[kf_idx, feat][..., None]],
                    -1)
    wgt = torch.where((m.lm_obs_kf >= 0) & m.lm_valid[:, None],
                      msearch.inv_sigma2_at(m.kf_octave[kf_idx, feat]), 0.0)
    res_ba = ba.ba_solve(cam, ba.BAProblem(
        m.kf_R, m.kf_t, m.lm_pw, kf_idx, uvr, wgt, (ids == 0) | ~m.kf_valid,
        m.lm_valid), iters=10, robust=True)
    return rebuild_observations(m._replace(kf_R=res_ba.R, kf_t=res_ba.t,
                                           lm_pw=res_ba.X))


def close_loop_step(loop: LoopCarry, m: MapState, cam, kf: int,
                    voc: V.Vocabulary, fix_scale: bool, width: int = 640,
                    height: int = 480, add_bow: bool = True
                    ) -> tuple[MapState, LoopCarry]:
    """The loop-closing pass for keyframe ``kf``: BoW row (unless the
    caller stored it at insertion, add_bow=False), detection and
    consistency, then the Sim3 and the correction where their gates pass."""
    if add_bow:
        loop = add_keyframe_bow(loop, voc, kf, m.kf_desc[kf],
                                m.kf_feat_valid[kf])
    cand, loop = detect(loop, m, kf, voc.n_words)
    if cand < 0:
        return m, loop
    sm = sim3_solve(loop, m, cam, kf, cand, fix_scale)
    if not sm.ok:
        return m, loop
    total = sim3_accept_gate(m, cam, kf, cand, sm.R, sm.t, sm.s,
                             sm.matched_feats, width, height)
    if total < 40:
        return m, loop
    m = correct_loop(m, cam, kf, cand, sm.R, sm.t, sm.s, fix_scale, sm.lm_cur,
                     sm.lm_cand, sm.pair_ok, loop.loop_edges, width, height)
    edges = loop.loop_edges.clone()
    edges[min(kf, cand), max(kf, cand)] = True
    return m, loop._replace(last_loop_kf=kf, n_loops=loop.n_loops + 1,
                            loop_edges=edges)
