"""Loop detection, Sim3 computation and loop correction for the host
tracker (port of pipeline/loop_closing.py).

The reference's LoopClosing thread (LoopClosing.cc) as a host sequencer
over tensor steps: BoW candidates with covisibility consistency over 3
consecutive keyframes (DetectLoop :105-264), Sim3 RANSAC and refinement
with its gates (ComputeSim3 :291-487: >= 20 matches, >= 20 RANSAC and
refined inliers, >= 40 with the loop group's landmarks), and the
correction (CorrectLoop :509-719): Sim3 propagation over the current
covisibility group, matched-point Replace, SearchAndFuse, the essential
graph and a global BA. The global BA runs either at once (``process``) or
in bounded chunks polled once per frame on a snapshot of the map, where a
newer loop aborts a running one through a generation counter (the GBA
thread, :790-901, and its mnFullBAIdx, :518-530).

Random draws (the Sim3 RANSAC) come from the generator the caller passes,
the tracker's one.
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
from ..optim import ba, pose_graph, sim3_opt
from ..optim.residuals import CamParams
from ..parallel import dist_ba
from ..place import vocabulary as V
from ..place.database import KeyFrameDatabase, to_numpy
from ..solvers import sim3solver
from . import auto_loop, steps

I32 = torch.int32
SEED = 7  # the JAX package's loop closer starts from PRNGKey(7)


class Readback:
    """Tensors copied to host memory without blocking: on the card into
    pinned buffers, with an event recorded after the copies; ``result()``
    waits for the event (one sync) and returns numpy arrays."""

    def __init__(self, *tensors: torch.Tensor):
        if tensors[0].is_cuda:
            self._host = [torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True) for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = list(tensors), None

    def done(self) -> bool:
        return self._event is None or self._event.query()

    def result(self) -> list[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


class Sim3Result(NamedTuple):
    """An accepted loop transform and the landmark pairs that support it
    (for the correction's Replace, LoopClosing.cc:638-661)."""
    R: torch.Tensor  # candidate-camera coordinates -> current-camera ones
    t: torch.Tensor
    s: torch.Tensor
    n_inliers: int
    lm_cur: torch.Tensor  # [N] current-keyframe landmark per pair, or -1
    lm_cand: torch.Tensor  # [N] loop-keyframe landmark per pair, or -1
    pair_ok: torch.Tensor  # [N] bool inlier mask


class LoopCloser:
    def __init__(self, cam: CamParams, db: KeyFrameDatabase,
                 fix_scale: bool = True, covis_consistency: int = 3,
                 min_gap: int = 10, width: int = 640, height: int = 480,
                 gen: torch.Generator | None = None):
        self.cam = cam
        self.db = db
        self.width = int(width)
        self.height = int(height)
        self.fix_scale = fix_scale
        self.consistency_th = covis_consistency
        self.min_gap = min_gap  # >= 10 keyframes since the last loop (:116)
        self.last_loop_kf = -self.min_gap
        self.prev_groups: list[tuple[set[int], int]] = []
        self.gen = gen if gen is not None else torch.Generator(
            device=db.bow_idx.device).manual_seed(SEED)
        self.n_loops_closed = 0
        # accepted loop edges, all kept: the essential graph takes every
        # past loop (KeyFrame::GetLoopEdges, Optimizer.cc:908-919)
        self.loop_edges: list[tuple[int, int]] = []
        # the chunked global BA: a snapshot, its iterations left, and the
        # generation counter a newer loop bumps
        self._gba = None
        self.gba_generation = 0
        self.gba_chunk_iters = 2
        self.gba_total_iters = 10
        # multi-device GBA: a torch.distributed process group (e.g.
        # torch.distributed.group.WORLD) sends the global-BA chunks to
        # parallel.dist_ba.ba_solve_sharded; None keeps them on this device
        self.mesh = None

    def remap_slots(self, rank: np.ndarray, valid: np.ndarray):
        """Mirror a keyframe compaction: the last loop keyframe, the
        consistency groups and the loop edges follow the old->new slot
        map, culled members drop out, and a running GBA (its snapshot is
        keyed by the old slots) is aborted."""
        if 0 <= self.last_loop_kf < len(rank):
            self.last_loop_kf = int(rank[self.last_loop_kf])
        self.prev_groups = [
            ({int(rank[j]) for j in group if 0 <= j < len(valid) and valid[j]},
             count)
            for group, count in self.prev_groups]
        self.prev_groups = [(g, c) for g, c in self.prev_groups if g]
        self.loop_edges = [
            (int(rank[i]), int(rank[j])) for i, j in self.loop_edges
            if i < len(valid) and j < len(valid) and valid[i] and valid[j]]
        self._gba = None

    # -- detection --------------------------------------------------------
    def _detect_dev(self, m: MapState, kf: int):
        """The covisibility matrix and keyframe ``kf``'s BoW scores against
        every slot, as tensors."""
        db = self.db
        s = torch.where(m.kf_valid, V.score_l1_sparse(
            db.bow_idx[kf], db.bow_w[kf], db.bow_idx, db.bow_w,
            db.voc.n_words), -1.0)
        return covisibility_matrix(m), s

    def _candidate(self, m: MapState, kf: int, W: np.ndarray,
                   s_all: np.ndarray) -> int | None:
        covis = np.where(W[kf] > 0)[0]
        min_score = max(float(min([s_all[int(j)] for j in covis],
                                  default=0.5)), 0.0)
        candidates = self.db.detect_loop_candidates(m, kf, min_score,
                                                    covis=W, scores=s_all)
        return self._consistency(W, candidates)

    def detect(self, m: MapState, kf: int) -> int | None:
        """A consistent loop candidate for keyframe ``kf``, or None."""
        if kf - self.last_loop_kf < self.min_gap:
            self.prev_groups = []
            return None
        W, s_all = Readback(*self._detect_dev(m, kf)).result()
        return self._candidate(m, kf, W, s_all)

    # -- Sim3 -------------------------------------------------------------
    def compute_sim3(self, m: MapState, kf: int, cand: int):
        """Match the two keyframes' landmarks, RANSAC and refine S12 (maps
        candidate-camera coordinates into current-camera ones). Returns a
        Sim3Result or None."""
        cam = self.cam
        lm1, lm2 = m.kf_lm[kf], m.kf_lm[cand]
        l1 = lm1.clamp(min=0).long()
        has1 = (lm1 >= 0) & m.kf_feat_valid[kf] & m.lm_valid[l1]
        has2 = ((lm2 >= 0) & m.kf_feat_valid[cand]
                & m.lm_valid[lm2.clamp(min=0).long()])
        idx, _, matched = msearch.search_brute(
            m.kf_desc[kf], m.kf_desc[cand], has1, has2, ratio=0.75,
            angle_q=m.kf_angle[kf], angle_t=m.kf_angle[cand])
        if int(matched.sum()) < 20:  # :333
            return None
        safe_idx = torch.where(matched, idx, 0).long()
        X1c = se3.transform(m.kf_R[kf], m.kf_t[kf], m.lm_pw[l1])
        X2c = se3.transform(m.kf_R[cand], m.kf_t[cand],
                            m.lm_pw[lm2[safe_idx].clamp(min=0).long()])
        s2_1 = msearch.sigma2_at(m.kf_octave[kf])
        K = (cam.fx, cam.fy, cam.cx, cam.cy)
        res = sim3solver.solve_ransac(
            self.gen, K, K, X1c, X2c, m.kf_xy[kf], m.kf_xy[cand][safe_idx],
            s2_1, msearch.sigma2_at(m.kf_octave[cand][safe_idx]),
            matched & has1, max_iters=300, min_inliers=20,
            fix_scale=self.fix_scale)
        if int(res.n_inliers) < 20:  # :408
            return None
        # SearchBySim3 growth through the RANSAC model (:400), then the
        # refinement on the grown set
        grow_idx, grown = auto_loop.sim3_grow_matches(
            m, cam, kf, cand, idx, matched, res.R, res.t, res.s)
        safe_g = grow_idx.clamp(min=0).long()
        l2g = lm2[safe_g].clamp(min=0).long()
        X2c_g = se3.transform(m.kf_R[cand], m.kf_t[cand], m.lm_pw[l2g])
        s2_2g = msearch.sigma2_at(m.kf_octave[cand][safe_g])
        valid_g = grown & has1
        ref = sim3_opt.optimize_sim3(
            K, K, res.R, res.t, res.s, X1c, X2c_g, m.kf_xy[kf],
            m.kf_xy[cand][safe_g], 1.0 / s2_1, 1.0 / s2_2g, valid_g,
            iters=10, fix_scale=self.fix_scale)
        if int(ref.n_inliers) < 20:
            return None
        # the loop group's landmarks through Scw, th=10: >= 40 in all
        # (:459-471)
        total = auto_loop.sim3_accept_gate(m, cam, kf, cand, ref.R, ref.t,
                                           ref.s, valid_g, self.width,
                                           self.height)
        if total < 40:
            return None
        # no self-pairs: a landmark matched to itself would Replace itself
        pair_ok = valid_g & (l1 != l2g)
        return Sim3Result(ref.R, ref.t, ref.s, int(ref.n_inliers),
                          torch.where(pair_ok, l1, -1).to(I32),
                          torch.where(pair_ok, l2g, -1).to(I32),
                          ref.inliers & pair_ok)

    # -- correction ---------------------------------------------------------
    def correct(self, m: MapState, kf: int, cand: int, S12: Sim3Result,
                sync_gba: bool = True) -> MapState:
        """CorrectLoop (LoopClosing.cc:509-719): Sim3-consistent update of
        the current covisibility group's poses and landmarks, Replace of
        the matched pairs, SearchAndFuse, the essential graph, then the
        global BA: at once with sync_gba, else started in chunks."""
        K = m.kf_R.shape[0]
        dev = m.kf_R.device
        one = torch.ones((), device=dev)
        # corrected current pose S_cur_w = S12 T_cand_w, and the world
        # correction G = S_cur_w_corr^-1 T_cur_w
        Rc, tc, sc = sim3.compose(S12.R, S12.t, S12.s, m.kf_R[cand],
                                  m.kf_t[cand], one)
        Rg, tg, sg = sim3.compose(*sim3.inverse(Rc, tc, sc), m.kf_R[kf],
                                  m.kf_t[kf], one)
        Rgi, tgi, sgi = sim3.inverse(Rg, tg, sg)
        w = to_numpy(covisibility_weights(m, kf))
        group = [int(j) for j in np.where(w > 0)[0]] + [kf]
        group_mask = np.zeros(K, bool)
        group_mask[group] = True
        gm = torch.as_tensor(group_mask, device=dev)
        # the edge measurements come from the uncorrected poses
        # (NonCorrectedSim3, :546-580)
        R_old, t_old = m.kf_R, m.kf_t
        Ri, ti, si = sim3.compose(m.kf_R, m.kf_t, torch.ones(K, device=dev),
                                  Rgi.expand(K, 3, 3), tgi.expand(K, 3),
                                  sgi.expand(K))
        kf_R = torch.where(gm[:, None, None], Ri, m.kf_R)
        kf_t = torch.where(gm[:, None], ti / si.clamp(min=1e-9)[:, None],
                           m.kf_t)
        in_group = gm[m.lm_ref_kf.clamp(0, K - 1).long()] & m.lm_valid
        lm_pw = torch.where(in_group[:, None],
                            sim3.transform(Rg, tg, sg, m.lm_pw), m.lm_pw)
        m = m._replace(kf_R=kf_R, kf_t=kf_t, lm_pw=lm_pw)

        # matched-point Replace (:638-661): the loop side wins
        pair_ok = (S12.pair_ok & (S12.lm_cur >= 0) & (S12.lm_cand >= 0)
                   & (S12.lm_cur != S12.lm_cand))
        m = merge_landmarks(m, S12.lm_cand.clamp(min=0),
                            S12.lm_cur.clamp(min=0), pair_ok)

        # SearchAndFuse (:661-692, :725-754): the loop group's landmarks
        # into every corrected keyframe (the first 32 of the group)
        w_cand = to_numpy(covisibility_weights(m, cand))
        loop_group = [int(j) for j in np.where(w_cand > 0)[0]] + [cand]
        loop_kf_mask = np.zeros(K, bool)
        loop_kf_mask[loop_group] = True
        lkm = torch.as_tensor(loop_kf_mask, device=dev)
        obs = m.lm_obs_kf
        obs_in_loop = (lkm[obs.clamp(min=0).long()] & (obs >= 0)).any(1)
        m = steps.loop_search_and_fuse(m, self.cam, obs_in_loop, group[:32],
                                       self.width, self.height)

        n_valid = int(m.kf_valid.sum())
        self.loop_edges.append((min(kf, cand), max(kf, cand)))
        if n_valid >= 4:
            m = self._essential_graph(m, kf, cand, R_old, t_old,
                                      group_mask=gm, group_scale=sgi)
        m = rebuild_observations(m)
        if sync_gba:
            m = self._global_ba(m)
        else:
            self._start_gba(m)
        self.last_loop_kf = kf
        self.n_loops_closed += 1
        return m

    def _essential_graph(self, m: MapState, kf: int, cand: int, R_old=None,
                         t_old=None, group_mask=None,
                         group_scale=None) -> MapState:
        """The essential graph (Optimizer.cc:908-1053): every accepted loop
        edge, each live keyframe chained to the previous live slot (the
        spanning tree's counterpart), and covisibility edges of weight
        >= 100. Solved over the live prefix of the slots, rounded up to a
        power of two: the dense pose graph up to 256 vertices, conjugate
        gradients above."""
        K = m.kf_R.shape[0]
        dev = m.kf_R.device
        valid = to_numpy(m.kf_valid)
        W = to_numpy(covisibility_matrix(m))
        W = np.where(valid[:, None] & valid[None, :], W, 0)
        ei, ej = np.nonzero(np.triu(W, 1) >= 100)
        pairs = set(zip(ei.tolist(), ej.tolist()))
        live = np.where(valid)[0]
        for a, b in zip(live[:-1], live[1:]):
            pairs.add((int(a), int(b)))
        for e in self.loop_edges:
            if valid[e[0]] and valid[e[1]]:
                pairs.add(e)
        loop_pair = (min(kf, cand), max(kf, cand))
        pairs.add(loop_pair)
        pairs = sorted(pairs)
        e_i = torch.tensor([p[0] for p in pairs], dtype=torch.long,
                           device=dev)
        e_j = torch.tensor([p[1] for p in pairs], dtype=torch.long,
                           device=dev)
        if R_old is None:
            R_old, t_old = m.kf_R, m.kf_t
        # vertices start at their full Sim3 (vScw): the corrected group
        # carries the propagation scale (Optimizer.cc:860-886, 925-931)
        if group_mask is not None and group_scale is not None:
            s_sim = torch.where(group_mask, group_scale,
                                torch.ones(K, device=dev))
            t_sim = torch.where(group_mask[:, None],
                                m.kf_t * s_sim[:, None], m.kf_t)
        else:
            s_sim = torch.ones(K, device=dev)
            t_sim = m.kf_t
        is_loop = torch.tensor([p == loop_pair or p in self.loop_edges[:-1]
                                for p in pairs], device=dev)
        use_new = is_loop[:, None, None]
        Ri = torch.where(use_new, m.kf_R[e_i], R_old[e_i])
        ti = torch.where(use_new[..., 0], t_sim[e_i], t_old[e_i])
        si = torch.where(is_loop, s_sim[e_i], 1.0)
        Rj = torch.where(use_new, m.kf_R[e_j], R_old[e_j])
        tj = torch.where(use_new[..., 0], t_sim[e_j], t_old[e_j])
        sj = torch.where(is_loop, s_sim[e_j], 1.0)
        mR, mt, ms = sim3.compose(Rj, tj, sj, *sim3.inverse(Ri, ti, si))
        # the live prefix, a power of two: the dense solve must not scale
        # with the map's capacity
        n_kf = int(np.max(np.where(valid)[0])) + 1 if valid.any() else 1
        Np = K if n_kf > K // 2 else max(
            64, 1 << (max(n_kf - 1, 1)).bit_length())
        Np = min(Np, K)
        fixed = np.zeros(Np, bool)
        fixed[cand] = True  # only the loop keyframe is fixed (:891-892)
        fixed[~valid[:Np]] = True
        prob = pose_graph.PoseGraphProblem(
            m.kf_R[:Np], t_sim[:Np], s_sim[:Np], e_i, e_j, mR, mt, ms,
            torch.ones(len(pairs), dtype=torch.bool, device=dev),
            torch.as_tensor(fixed, device=dev))
        solve = (pose_graph.optimize_pose_graph_cg if Np > 256
                 else pose_graph.optimize_pose_graph)
        res = solve(prob, iters=20, fix_scale=self.fix_scale)
        res_R = m.kf_R.clone()
        res_R[:Np] = res.R
        kf_t_new = m.kf_t.clone()
        kf_t_new[:Np] = res.t
        s_new = torch.ones(K, device=dev)
        s_new[:Np] = res.s
        # landmarks through their reference keyframe: forward by the
        # vertex's initial Sim3, back by the optimized one
        # (Optimizer.cc:1061-1080)
        ref = m.lm_ref_kf.clamp(0, Np - 1).long()
        Xc = sim3.transform(m.kf_R[ref], t_sim[ref], s_sim[ref], m.lm_pw)
        pw = (se3.transform(*se3.inverse(res_R[ref], kf_t_new[ref]), Xc)
              / s_new[ref].clamp(min=1e-9)[:, None])
        kf_t_out = m.kf_t.clone()
        kf_t_out[:Np] = res.t / res.s.clamp(min=1e-9)[:, None]
        return m._replace(kf_R=res_R, kf_t=kf_t_out,
                          lm_pw=torch.where(m.lm_valid[:, None], pw, m.lm_pw))

    # -- global BA, in chunks ---------------------------------------------
    def _build_gba_problem(self, m: MapState):
        """The global-BA problem over the live prefix of the slots, padded
        to a power of two. Every array is a copy: the snapshot must not
        move with the live map."""
        K, L = m.kf_R.shape[0], m.lm_pw.shape[0]
        n_kf, n_lm = int(m.n_kf), int(m.n_lm)
        Pp = K if n_kf > K // 2 else max(
            64, 1 << (max(n_kf - 1, 1)).bit_length())
        Lp = L if n_lm > L // 2 else max(
            1024, 1 << (max(n_lm - 1, 1)).bit_length())
        Pp, Lp = min(Pp, K), min(Lp, L)
        obs_kf = m.lm_obs_kf[:Lp]
        obs_valid = (obs_kf >= 0) & (obs_kf < Pp)
        kf_idx = torch.where(obs_valid, obs_kf, 0).long()
        feat_idx = m.lm_obs_feat[:Lp].long()
        uvr = torch.cat([m.kf_xy[kf_idx, feat_idx],
                         m.kf_ur[kf_idx, feat_idx][..., None]], -1)
        wgt = torch.where(obs_valid & m.lm_valid[:Lp, None],
                          msearch.inv_sigma2_at(m.kf_octave[kf_idx, feat_idx]),
                          0.0)
        fixed = ~m.kf_valid[:Pp].clone()
        fixed[0] = True
        prob = ba.BAProblem(m.kf_R[:Pp].clone(), m.kf_t[:Pp].clone(),
                            m.lm_pw[:Lp].clone(), kf_idx, uvr, wgt, fixed,
                            m.lm_valid[:Lp].clone())
        return prob, Pp, Lp

    def _start_gba(self, m: MapState):
        """Snapshot the problem and bump the generation: a still-running
        older GBA is dropped (mbStopGBA + mnFullBAIdx, :518-530)."""
        prob, Pp, Lp = self._build_gba_problem(m)
        self.gba_generation += 1
        self._gba = {
            "prob": prob, "Pp": Pp, "Lp": Lp,
            # slots past these were empty at the snapshot: whatever lives
            # there when the GBA ends was born during it
            "n_kf": int(m.n_kf), "n_lm": int(m.n_lm),
            "left": self.gba_total_iters, "gen": self.gba_generation,
            # LM damping carried across chunks, as one continuous run
            "lam": torch.tensor(1e-4, device=m.kf_R.device),
        }

    def gba_running(self) -> bool:
        return self._gba is not None

    def poll_gba(self, m: MapState) -> MapState | None:
        """Advance the pending global BA by one chunk (called once per
        frame; to interrupt it is not to launch the next chunk). Returns
        the reconciled map when the last chunk completes, else None."""
        g = self._gba
        if g is None:
            return None
        iters = min(self.gba_chunk_iters, g["left"])
        prob = g["prob"]
        if (self.mesh is not None
                and g["Lp"] % dist_ba.world_size(self.mesh) == 0):
            # landmark shards and an all-reduced camera system over the
            # group, every step taken at the chunk's fixed damping
            Rn, tn, Xn, _ = dist_ba.ba_solve_sharded(
                self.cam, dist_ba.shard_problem(prob, self.mesh), self.mesh,
                iters=iters, lam=g["lam"], robust=True)
            g["prob"] = prob._replace(
                R=Rn, t=tn, X=dist_ba.gather_points(Xn, self.mesh))
        else:
            solve = ba.ba_solve if g["Pp"] <= 64 else ba.ba_solve_cg
            res = solve(self.cam, prob, iters=iters, robust=True,
                        init_lambda=g["lam"])
            g["prob"] = prob._replace(R=res.R, t=res.t, X=res.X)
            g["lam"] = res.final_lambda
        g["left"] -= iters
        if g["left"] > 0:
            return None
        self._gba = None
        return self._apply_gba(m, g)

    def _apply_gba(self, m: MapState, g) -> MapState:
        """Reconcile a finished snapshot with the current map (the GBA
        write-back, LoopClosing.cc:823-889): snapshot keyframes take their
        GBA poses; keyframes inserted during the run follow the last
        snapshot keyframe's correction; snapshot landmarks take their GBA
        positions, newer ones ride their reference keyframe's correction."""
        Pp, Lp = g["Pp"], g["Lp"]
        prob = g["prob"]
        K, L = m.kf_R.shape[0], m.lm_pw.shape[0]
        dev = m.kf_R.device
        anchor = max(g["n_kf"] - 1, 0)
        relR, relt = se3.compose(m.kf_R, m.kf_t, *se3.inverse(
            m.kf_R[anchor], m.kf_t[anchor]))
        newR, newt = se3.compose(relR, relt, prob.R[anchor], prob.t[anchor])
        in_snap = torch.arange(K, device=dev) < g["n_kf"]
        snap_R, snap_t = m.kf_R.clone(), m.kf_t.clone()
        snap_R[:Pp], snap_t[:Pp] = prob.R, prob.t
        kf_R = torch.where(in_snap[:, None, None], snap_R, newR)
        kf_t = torch.where(in_snap[:, None], snap_t, newt)
        ref = m.lm_ref_kf.clamp(0, K - 1).long()
        Xc = se3.transform(m.kf_R[ref], m.kf_t[ref], m.lm_pw)
        pw_ride = se3.transform(*se3.inverse(kf_R[ref], kf_t[ref]), Xc)
        snap_X = m.lm_pw.clone()
        snap_X[:Lp] = prob.X
        in_snap_lm = torch.arange(L, device=dev) < g["n_lm"]
        lm_pw = torch.where(in_snap_lm[:, None], snap_X, pw_ride)
        lm_pw = torch.where(m.lm_valid[:, None], lm_pw, m.lm_pw)
        return m._replace(kf_R=kf_R, kf_t=kf_t, lm_pw=lm_pw)

    def _global_ba(self, m: MapState, iters: int = 10) -> MapState:
        """The global BA at once: start, then poll to the end."""
        self.gba_total_iters = iters
        self._start_gba(m)
        out = None
        while out is None:
            out = self.poll_gba(m)
        return out

    # -- entries ------------------------------------------------------------
    def process(self, m: MapState, kf: int) -> MapState:
        """Detection -> Sim3 -> correction for a new keyframe."""
        cand = self.detect(m, kf)
        if cand is None:
            return m
        S12 = self.compute_sim3(m, kf, cand)
        if S12 is None:
            return m
        return self.correct(m, kf, cand, S12)

    def begin(self, m: MapState, kf: int):
        """Queue the detection's device work and its copy to the host;
        returns a handle for finish() (None inside the loop gap)."""
        if kf - self.last_loop_kf < self.min_gap:
            self.prev_groups = []
            return None
        return kf, Readback(*self._detect_dev(m, kf))

    def finish(self, m: MapState, handle) -> MapState | None:
        """Complete a begin(): the host gating and consistency, then on a
        confirmed candidate the Sim3 and the correction with a chunked
        GBA. Returns the corrected map, or None when no loop closed."""
        if handle is None:
            return None
        kf, rb = handle
        W, s_all = rb.result()
        cand = self._candidate(m, kf, W, s_all)
        if cand is None:
            return None
        S12 = self.compute_sim3(m, kf, cand)
        if S12 is None:
            return None
        return self.correct(m, kf, cand, S12, sync_gba=False)

    def _consistency(self, W: np.ndarray, candidates: list[int]) -> int | None:
        """Covisibility consistency over consecutive keyframes
        (LoopClosing.cc:164-244, mnCovisibilityConsistencyTh=3)."""
        if not candidates:
            self.prev_groups = []
            return None
        new_groups: list[tuple[set[int], int]] = []
        enough: list[int] = []
        for c in candidates:
            group = {int(j) for j in np.where(W[c] > 0)[0]} | {c}
            count = 0
            for prev_set, prev_count in self.prev_groups:
                if group & prev_set:
                    count = max(count, prev_count + 1)
            new_groups.append((group, count))
            if count + 1 >= self.consistency_th:
                enough.append(c)
        self.prev_groups = new_groups
        return enough[0] if enough else None
