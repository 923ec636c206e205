"""Autonomous RGB-D, stereo and monocular tracker: per-frame state machine
over device tensors (port of pipeline/auto.py).

The JAX package runs the whole state machine inside one jitted program
with lax.cond branches, because each host readback was costly over its
TPU transport. Here the map, the loop-closing tables, the previous frame
bundle, the poses and the trajectory rings stay on the device, while the
decisions (initialization gate, NeedNewKeyFrame, slot compaction, lost,
relocalization, the amortized maintenance phase and its loop closing) are
taken on the host from a few scalars per frame. The decisions are the JAX
package's, rule for rule (reference: Tracking.cc:287-581, 1140-1244,
1582-1778).

With loop_closing (the default) the tracker keeps a BoW row per keyframe,
relocalizes while lost and runs loop closing as the seventh maintenance
phase; without it, a lost tracker with more than 5 keyframes stays lost.
Random draws (the Sim3 and EPnP RANSAC, the monocular initializer's 8-point
sets) come from one torch.Generator held in the loop carry, seeded with
auto_loop.SEED.

The monocular tracker bootstraps from two views (MonocularInitialization,
Tracking.cc:638-726), triangulates against the two previous keyframes when
it inserts one, runs an eighth maintenance phase (triangulation against
the covisible neighbors), and closes loops first in the cycle and with a
free scale.

In localization mode (``localization_only``, the reference's
ActivateLocalizationMode, Tracking.cc:222-235) the tracker follows a saved
map (checkpoint.load_auto_state) without inserting keyframes, and a lost
frame relocalizes whatever the map's size. ``batch_frames`` > 1 buffers
RGB-D frames on the host and uploads them B at a time; the frames then run
one after the other through the same per-frame step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import spans
from ..frontend.extractor import OrbExtractor
from ..geometry import se3
from ..mapstate.map import (MapState, compact_keyframes, compact_landmarks,
                            covisibility_weights, empty_map,
                            keyframe_compaction, landmark_compaction_order)
from ..matching import search as msearch
from ..matching.search import FeatureSet
from ..ops.fast import sort_top_k
from ..place import vocabulary as V
from ..solvers import initializer, pnp
from . import auto_loop, steps
from .tracking import TrackerConfig, upload_frame

N_NEIGHBORS = 10  # covisibility window kept across maintenance phases
NO_NEIGHBORS = (-1,) * N_NEIGHBORS
_FRONTEND = spans.span("frontend")
_UPLOAD = spans.span("upload")
_DECIDE = spans.span("do_track.decide")


class AutoState(NamedTuple):
    """Tracker state: device tensors, plus the host scalars that drive the
    state machine (Python ints and bools)."""
    map: MapState
    prev: steps.FrameObs  # previous frame bundle
    last_R: torch.Tensor  # [3, 3]
    last_t: torch.Tensor  # [3]
    vel_R: torch.Tensor  # [3, 3]
    vel_t: torch.Tensor  # [3]
    have_vel: bool
    ref_kf: int
    last_kf_frame: int
    frame_idx: int  # frames processed so far
    initialized: bool
    lost: int  # frame index where tracking was lost, -1 while tracking
    loop: auto_loop.LoopCarry  # BoW rows, loop detection state, generator
    # monocular bootstrap: frame index of the stored reference frame, whose
    # bundle is ``prev``; -1 without one
    init_frame_id: int
    # amortized keyframe maintenance (LocalMapping.cc:47-128 as one bounded
    # phase per frame after an insertion; a new keyframe preempts)
    maint_kf: int  # keyframe under maintenance, -1 idle
    maint_phase: int  # next phase index
    maint_neighbors: tuple  # [10] covisibility window, -1 padded
    maint_lambda: torch.Tensor  # [] local-BA damping carried across chunks
    n_compact_lm: int
    n_compact_kf: int
    # trajectory rings [T, ...] (Tracking.cc:562-579)
    traj_R: torch.Tensor
    traj_t: torch.Tensor
    traj_Rcr: torch.Tensor
    traj_tcr: torch.Tensor
    traj_ref: torch.Tensor  # [T] int32
    traj_valid: torch.Tensor  # [T] bool
    traj_stats: torch.Tensor  # [T, 8] int32


def _empty_prev(N: int, device) -> steps.FrameObs:
    f32, i32 = torch.float32, torch.int32
    z = torch.zeros
    return steps.FrameObs(
        FeatureSet(z((N, 2), dtype=f32, device=device),
                   torch.full((N,), -1.0, device=device),
                   z(N, dtype=i32, device=device),
                   z(N, dtype=f32, device=device),
                   z((N, 8), dtype=i32, device=device),
                   z(N, dtype=torch.bool, device=device)),
        torch.full((N,), -1.0, device=device),
        torch.full((N,), -1, dtype=i32, device=device))


def empty_auto_state(cfg: TrackerConfig, traj_capacity: int,
                     device) -> AutoState:
    T = traj_capacity
    f32 = torch.float32
    eye = torch.eye(3, dtype=f32, device=device)
    return AutoState(
        map=empty_map(cfg.map_cfg, device),
        # sparse BoW rows are lossless at n_features words
        loop=auto_loop.empty_loop_carry(cfg.map_cfg.k_max, cfg.n_features,
                                        device),
        prev=_empty_prev(cfg.n_features, device),
        last_R=eye, last_t=torch.zeros(3, device=device),
        vel_R=eye, vel_t=torch.zeros(3, device=device),
        have_vel=False, ref_kf=0, last_kf_frame=-1, frame_idx=0,
        initialized=False, lost=-1, init_frame_id=-1, maint_kf=-1,
        maint_phase=0, maint_neighbors=NO_NEIGHBORS,
        maint_lambda=torch.tensor(1e-4, dtype=f32, device=device),
        n_compact_lm=0, n_compact_kf=0,
        traj_R=eye.repeat(T, 1, 1), traj_t=torch.zeros((T, 3), device=device),
        traj_Rcr=eye.repeat(T, 1, 1),
        traj_tcr=torch.zeros((T, 3), device=device),
        traj_ref=torch.full((T,), -1, dtype=torch.int32, device=device),
        traj_valid=torch.zeros(T, dtype=torch.bool, device=device),
        traj_stats=torch.zeros((T, 8), dtype=torch.int32, device=device))


def _stack(frames):
    """[B, H, W] of B frames: a tensor if any frame is one, else numpy."""
    if any(isinstance(f, torch.Tensor) for f in frames):
        return torch.stack([torch.as_tensor(f) for f in frames])
    return np.stack([np.asarray(f) for f in frames])


def _f32_lt_scaled(a: int, b: int, factor: float) -> bool:
    """a < b * factor in float32, as the JAX package compares them."""
    return bool(np.float32(a) < np.float32(b) * np.float32(factor))


class AutoStep:
    """The per-frame step: AutoState x (img, raw depth) -> AutoState,
    through ``stereo`` AutoState x (left, right) -> AutoState, or through
    ``mono`` AutoState x img -> AutoState, or B RGB-D frames through
    ``rgbd_batch``. ``build_auto_step`` makes one. With a vocabulary ``voc``
    the step keeps BoW rows, relocalizes and closes loops. With
    ``localization_only`` it never inserts a keyframe and never resets the
    map (System::ActivateLocalizationMode, Tracking.cc:222-235)."""

    def __init__(self, extractor: OrbExtractor, cfg: TrackerConfig,
                 traj_capacity: int, voc: V.Vocabulary | None = None,
                 localization_only: bool = False):
        self.extractor = extractor
        self.localization_only = localization_only
        self.cfg = cfg
        self.cam = cfg.cam
        self.T = traj_capacity
        self.k_max = cfg.map_cfg.k_max
        self.th_depth = float(np.float32(cfg.depth_threshold))
        self.depth_factor = float(np.float32(cfg.depth_factor))
        self.voc = voc
        self.is_mono = cfg.sensor == "mono"
        tail = [self.ph_fuse_out, self.ph_merge, self.ph_refresh_cull,
                self.ph_ba1, self.ph_ba2]
        if self.is_mono:
            # loop detection first: a monocular insert may interrupt the
            # cycle (the relaxed c1b of do_track), and a loop phase at the
            # tail would be skipped for most keyframes, breaking the
            # 3-consecutive-keyframe consistency chains (the reference's
            # LoopClosing thread takes every keyframe, LoopClosing.cc:57-78)
            self.maint_phases = [self.ph_fuse_in, self.ph_triangulate] + tail
            if voc is not None:
                self.maint_phases.insert(0, self.ph_loop)
        else:
            self.maint_phases = [self.ph_fuse_in] + tail
            if voc is not None:
                self.maint_phases.append(self.ph_loop)

    def __call__(self, s: AutoState, img: torch.Tensor,
                 depth_raw: torch.Tensor) -> AutoState:
        cfg = self.cfg
        feats, d = steps.extract_rgbd_features(
            self.extractor, self.cam, img, depth_raw, self.depth_factor,
            cfg.width, cfg.height)
        return self.run_frame(s, feats, d)

    def rgbd_batch(self, s: AutoState, imgs, depths) -> AutoState:
        """B RGB-D frames, [B, H, W] stacks (numpy arrays or tensors): each
        stack goes to the device in one pinned copy, then each frame runs
        through the per-frame step in order, so the result equals B calls
        of the step bit for bit."""
        dev = s.last_t.device
        imgs = upload_frame(imgs, dev)
        depths = upload_frame(depths, dev, depth=True)
        for img, depth in zip(imgs, depths):
            s = self(s, img, depth)
        return s

    def stereo(self, s: AutoState, img_l: torch.Tensor,
               img_r: torch.Tensor) -> AutoState:
        """A rectified stereo pair: joint left/right extraction and the
        row-band depth association (Frame.cc:61-117, 501-675) feed the
        same state machine."""
        feats_l, sd = self.extractor.stereo(img_l, img_r, self.cam.bf,
                                            self.cam.fx)
        feats = FeatureSet(feats_l.xy, sd.u_right, feats_l.octave,
                           feats_l.angle, feats_l.desc, feats_l.valid)
        return self.run_frame(s, feats, sd.depth)

    def mono(self, s: AutoState, img: torch.Tensor) -> AutoState:
        """One monocular frame (GrabImageMonocular, Tracking.cc:239): no
        depth and no right coordinate; the map's landmarks come from the
        two-view bootstrap and from keyframe triangulation."""
        with _FRONTEND:
            raw = self.extractor._extract(img)
            none = torch.full_like(raw.angle, -1.0)
            feats = FeatureSet(raw.xy, none, raw.octave, raw.angle, raw.desc,
                               raw.valid)
        return self.run_frame(s, feats, none)

    @spans.span("write_traj")
    def write_traj(self, s: AutoState, R, t, Rcr, tcr, ref: int, valid: bool,
                   stats8: torch.Tensor) -> AutoState:
        i = s.frame_idx % self.T

        def put(a, v):
            a = a.clone()
            a[i] = v
            return a

        def put_host(site, a, v):  # a host value: a blocking copy
            a = a.clone()
            spans.put(site, a, i, v)
            return a

        return s._replace(
            traj_R=put(s.traj_R, R), traj_t=put(s.traj_t, t),
            traj_Rcr=put(s.traj_Rcr, Rcr), traj_tcr=put(s.traj_tcr, tcr),
            traj_ref=put_host("write_traj.ref", s.traj_ref, ref),
            traj_valid=put_host("write_traj.valid", s.traj_valid, valid),
            traj_stats=put(s.traj_stats, stats8))

    def _stats8(self, s: AutoState, c2: int = 0, c3: int = 0, c6: int = 0,
                c7: int = 0) -> torch.Tensor:
        """Per-frame statistics row, zero but for columns 2, 3, 6 and 7."""
        return spans.to_device("_stats8.row", [0, 0, c2, c3, 0, 0, c6, c7],
                               torch.int32, s.last_t.device)

    def _add_bow(self, loop, m: MapState, kf: int):
        if self.voc is None:
            return loop
        return auto_loop.add_keyframe_bow(loop, self.voc, kf, m.kf_desc[kf],
                                          m.kf_feat_valid[kf])

    def do_initialize(self, s: AutoState, feats: FeatureSet, d) -> AutoState:
        """StereoInitialization (Tracking.cc:584-636): more than
        min_init_features valid features required."""
        if int(spans.to_host("do_initialize.features",
                             feats.valid.sum())) <= self.cfg.min_init_features:
            return s
        dev = d.device
        N = d.shape[0]
        obs = steps.FrameObs(feats, d, torch.full((N,), -1, dtype=torch.int32,
                                                  device=dev))
        R = torch.eye(3, device=dev)
        t = torch.zeros(3, device=dev)
        m = steps.insert_keyframe(s.map, obs, R, t, s.frame_idx)
        m = steps.create_depth_landmarks(m, self.cam, 0, 1e9)
        s = s._replace(map=m, loop=self._add_bow(s.loop, m, 0),
                       prev=steps.FrameObs(feats, d, m.kf_lm[0]),
                       last_R=R, last_t=t, have_vel=False, ref_kf=0,
                       last_kf_frame=s.frame_idx, initialized=True)
        return self.write_traj(s, R, t, R, t, 0, True, self._stats8(s, c6=1))

    def do_initialize_mono(self, s: AutoState, feats: FeatureSet,
                           d) -> AutoState:
        """The two-view bootstrap (MonocularInitialization Tracking.cc:
        638-726, CreateInitialMapMonocular :733-843): a frame with more
        than 100 keypoints is stored as the reference; the next such frame
        is matched to it in a window, the H/F initializer runs, the
        two-keyframe map is bundle-adjusted (20 iterations) and scaled to
        a median scene depth of 1. A poor frame, or too few matches, drops
        the reference; a solver failure with enough matches keeps it; a
        map that fails after its BA is wiped."""
        cfg, cam = self.cfg, self.cam
        dev = d.device
        if int(spans.to_host("do_initialize_mono.features",
                             feats.valid.sum())) <= 100:  # :644
            return s._replace(init_frame_id=-1)
        obs = steps.FrameObs(feats, d, torch.full(
            (d.shape[0],), -1, dtype=torch.int32, device=dev))
        if s.init_frame_id < 0:
            return s._replace(prev=obs, init_frame_id=s.frame_idx)
        ref = s.prev
        idx, _, matched = msearch.search_for_initialization(
            ref.feats, feats, ref.feats.xy)
        if int(spans.to_host("do_initialize_mono.matches",
                             matched.sum())) < cfg.min_init_matches:  # :687
            return s._replace(init_frame_id=-1)
        res = initializer.initialize(
            s.loop.gen, (cam.fx, cam.fy, cam.cx, cam.cy), ref.feats.xy,
            feats.xy[idx.clamp(min=0).long()], matched)
        if not bool(spans.to_host("do_initialize_mono.success", res.success)):
            return s
        m = steps.insert_keyframe(s.map, ref, torch.eye(3, device=dev),
                                  torch.zeros(3, device=dev), s.init_frame_id)
        m = steps.insert_keyframe(m, obs, res.R, res.t, s.frame_idx)
        m = steps.insert_landmarks_two_view(m, cam, 0, 1, idx, res.X,
                                            res.good & matched)
        m = steps.refresh_landmarks(m)
        m, _ = steps.local_bundle_adjustment(m, cam, 1, iters_a=20)  # :787
        med = float(spans.to_host("do_initialize_mono.median_depth",
                                  steps.scene_median_depth(m, 0)))
        n_tracked = int(spans.to_host("do_initialize_mono.tracked",
                                      (m.kf_lm[1] >= 0).sum()))
        if not (np.isfinite(med) and med > 0
                and n_tracked >= cfg.min_init_matches):  # :793-799
            return s._replace(map=empty_map(cfg.map_cfg, dev),
                              init_frame_id=-1)
        m = steps.scale_map(m, spans.to_device("do_initialize_mono.scale",
                                               1.0, None, dev) / med)
        loop = self._add_bow(self._add_bow(s.loop, m, 0), m, 1)
        s = s._replace(map=m, loop=loop, prev=obs._replace(lm=m.kf_lm[1]),
                       last_R=m.kf_R[1], last_t=m.kf_t[1], have_vel=False,
                       ref_kf=1, last_kf_frame=s.frame_idx, initialized=True,
                       init_frame_id=-1)
        return self.write_traj(s, m.kf_R[1], m.kf_t[1],
                               torch.eye(3, device=dev),
                               torch.zeros(3, device=dev), 1, True,
                               self._stats8(s, c6=1))

    # ---- amortized keyframe-maintenance phases (LocalMapping.cc:47-128) ----

    @spans.span("ph_fuse_in")
    def ph_fuse_in(self, m, loop, nbrs, lam, kf):
        """Covisibility window + inward fusion (LocalMapping.cc:589-633)."""
        kk = min(N_NEIGHBORS, self.k_max)
        top_w, top_i = sort_top_k(covisibility_weights(m, kf), kk)
        nbrs = (spans.to_host("ph_fuse_in.neighbors",
                              torch.where(top_w > 0, top_i, -1))
                + [-1] * (N_NEIGHBORS - kk))
        cfg = self.cfg
        m = steps.fuse_neighbors(m, self.cam, kf, nbrs[:5], cfg.width,
                                 cfg.height, into=True)
        return m, loop, tuple(nbrs), lam

    @spans.span("ph_triangulate")
    def ph_triangulate(self, m, loop, nbrs, lam, kf):
        """New points against the covisible neighbors (CreateNewMapPoints,
        LocalMapping.cc:290-577)."""
        m = steps.triangulate_with_neighbors(m, self.cam, kf, nbrs[:5])
        return m, loop, nbrs, lam

    @spans.span("ph_fuse_out")
    def ph_fuse_out(self, m, loop, nbrs, lam, kf):
        cfg = self.cfg
        m = steps.fuse_neighbors(m, self.cam, kf, list(nbrs[:5]), cfg.width,
                                 cfg.height, into=False)
        return m, loop, nbrs, lam

    @spans.span("ph_merge")
    def ph_merge(self, m, loop, nbrs, lam, kf):
        return steps.merge_duplicate_landmarks(m, kf), loop, nbrs, lam

    @spans.span("ph_refresh_cull")
    def ph_refresh_cull(self, m, loop, nbrs, lam, kf):
        m = steps.refresh_landmarks_for_kf(m, kf)
        return steps.cull_landmarks(m, kf), loop, nbrs, lam

    @spans.span("ph_ba1")
    def ph_ba1(self, m, loop, nbrs, lam, kf):
        """Local BA chunk 1: 3 robust iterations (Optimizer.cc:689)."""
        if max(nbrs) >= 0:
            m, lam = steps.local_bundle_adjustment(
                m, self.cam, kf, iters_a=3, erase_outliers=False,
                init_lambda=1e-4)
        return m, loop, nbrs, lam

    @spans.span("ph_ba2")
    def ph_ba2(self, m, loop, nbrs, lam, kf):
        """Local BA chunk 2 (resumed damping) + outlier erasure + keyframe
        culling (Optimizer.cc:739-807, LocalMapping.cc:775-841)."""
        if max(nbrs) >= 0:
            m, lam = steps.local_bundle_adjustment(
                m, self.cam, kf, iters_a=2, erase_outliers=True,
                init_lambda=lam)
        return steps.cull_keyframes(m, kf, list(nbrs)), loop, nbrs, lam

    @spans.span("ph_loop")
    def ph_loop(self, m, loop, nbrs, lam, kf):
        """Loop closing for the maintained keyframe, whose BoW row was
        stored at insertion (LocalMapping.cc:102 feeds LoopClosing)."""
        m, loop = auto_loop.close_loop_step(
            loop, m, self.cam, kf, self.voc, fix_scale=not self.is_mono,
            width=self.cfg.width, height=self.cfg.height, add_bow=False)
        return m, loop, nbrs, lam

    # ---- keyframe insertion with slot compaction ----

    @spans.span("_insert")
    def _insert(self, s: AutoState, m: MapState, loop, res):
        """Insert the frame as a keyframe (CreateNewKeyFrame,
        Tracking.cc:1251-1336). Dead landmark slots are recycled first
        when the frame's features may not fit, dead keyframe slots when
        the keyframe table is full; the insert is refused if it is still
        full. Returns (map, loop, new slot or -1, the frame's landmark ids
        after the insert, landmark and keyframe compaction counts, the
        old->new keyframe slot map or None)."""
        lm = res.lm
        L = m.lm_pw.shape[0]
        did_lm = int(spans.to_host("_insert.n_lm", m.n_lm)) + lm.shape[0] > L
        if did_lm:
            old_valid = m.lm_valid
            inv = torch.empty(L, dtype=torch.int32, device=lm.device)
            inv[landmark_compaction_order(old_valid)] = torch.arange(
                L, dtype=torch.int32, device=lm.device)
            safe = lm.clamp(min=0).long()
            lm = torch.where((lm >= 0) & old_valid[safe], inv[safe], -1)
            m = compact_landmarks(m)
        kf_remap = None
        did_kf = int(spans.to_host("_insert.n_kf", m.n_kf)) >= self.k_max
        if did_kf:
            valid = m.kf_valid
            order, rank = keyframe_compaction(valid)
            m = compact_keyframes(m)
            if self.voc is not None:
                loop = auto_loop.permute_loop_carry(loop, order, rank, valid)
            kf_remap = spans.to_host("_insert.remap",
                                     torch.where(valid, rank, -1))
        kf = int(spans.to_host("_insert.slot", m.n_kf))
        if kf >= self.k_max:  # still full after compaction: refuse
            return m, loop, -1, lm, 0, 0, kf_remap
        m = steps.insert_keyframe(
            m, steps.FrameObs(res.feats, res.depth, lm), res.R, res.t,
            s.frame_idx)
        if self.is_mono:
            m = self.triangulate_at_insert(m, kf)
        else:
            m = steps.create_depth_landmarks(m, self.cam, kf, self.th_depth)
        return (m, self._add_bow(loop, m, kf), kf, m.kf_lm[kf], int(did_lm),
                int(did_kf), kf_remap)

    def triangulate_at_insert(self, m: MapState, kf: int) -> MapState:
        """The monocular landmark supply cannot wait for the maintenance
        cycle: a fresh keyframe is triangulated at once against the two
        slots before it (the JAX package does the same; after a keyframe
        compaction they need not be its temporal predecessors)."""
        nb = [j if j >= 0 and bool(spans.to_host("triangulate_at_insert.valid",
                                                 m.kf_valid[j])) else -1
              for j in (kf - 1, kf - 2)]
        return steps.triangulate_with_neighbors(m, self.cam, kf, nb)

    @spans.span("do_track")
    def do_track(self, s: AutoState, feats: FeatureSet, d) -> AutoState:
        cfg = self.cfg
        n_kf = int(spans.to_host("do_track.n_kf", s.map.n_kf))
        res = steps.track_frame_core(
            self.cam, s.map, s.prev, s.last_R, s.last_t, s.vel_R, s.vel_t,
            s.have_vel, s.ref_kf, feats, d, self.th_depth, cfg.desc_th,
            cfg.desc_th_local, 2 if n_kf > 2 else 1, cfg.width, cfg.height)
        with _DECIDE:
            _, _, track1_in, local_in, ref_matches, close_pack = (
                spans.to_host("do_track.stats", res.stats))
            now_lost = track1_in < 10 or local_in < 30
            need_kf = not now_lost and self._need_keyframe(
                s, res, n_kf, local_in, ref_matches, close_pack)
        if now_lost:
            # freeze: keep the map and pose (Tracking.cc:528)
            s = s._replace(lost=s.frame_idx, have_vel=False)
            stats8 = torch.cat([res.stats, spans.to_device(
                "do_track.lost_row", [0, s.loop.n_loops], torch.int32,
                d.device)])
            return self.write_traj(s, s.last_R, s.last_t, s.last_R, s.last_t,
                                   s.ref_kf, False, stats8)
        m, loop = res.map, s.loop
        new_kf, lm_after, did_lm, did_kf, remap = -1, res.lm, 0, 0, None
        if need_kf:
            m, loop, new_kf, lm_after, did_lm, did_kf, remap = self._insert(
                s, m, loop, res)
        inserted = new_kf >= 0
        # keyframe compaction renumbered the slots: remap every slot id the
        # state holds outside the map (culled ones: ref ids to slot 0,
        # maintenance ids to -1)
        ref_kf, mkf, nbrs, traj_ref = (s.ref_kf, s.maint_kf,
                                       s.maint_neighbors, s.traj_ref)
        if remap is not None:
            ref_kf = max(remap[ref_kf], 0)
            mkf = remap[mkf] if mkf >= 0 else mkf
            nbrs = tuple(remap[j] if j >= 0 else j for j in nbrs)
            table = spans.to_device("do_track.remap", remap, torch.int32,
                                    traj_ref.device)
            traj_ref = torch.where(
                traj_ref >= 0,
                table[traj_ref.clamp(0, self.k_max - 1).long()].clamp(min=0),
                traj_ref)
        lam, phase = s.maint_lambda, s.maint_phase
        m_pre, anchor = m, max(mkf, 0)
        if not inserted and mkf >= 0:
            step = self.maint_phases[min(max(phase, 0),
                                         len(self.maint_phases) - 1)]
            m, loop, nbrs, lam = step(m, loop, nbrs, lam, mkf)
            phase += 1
            if phase >= len(self.maint_phases):
                phase, mkf = 0, -1
        if inserted:  # a fresh insert (re)starts maintenance (mbAbortBA)
            mkf, phase, nbrs = new_kf, 0, NO_NEIGHBORS
            lam = torch.full_like(lam, 1e-4)
        # a closed loop moved the keyframes: re-express the frame's pose
        # through the maintained keyframe's poses before and after it, and
        # drop the velocity (Tracking.cc:301)
        loop_fired = loop.n_loops > s.loop.n_loops
        R, t = res.R, res.t
        if loop_fired:
            rel = se3.compose(res.R, res.t, *se3.inverse(
                m_pre.kf_R[anchor], m_pre.kf_t[anchor]))
            R, t = se3.compose(*rel, m.kf_R[anchor], m.kf_t[anchor])
        stats8 = torch.cat([res.stats, spans.to_device(
            "do_track.stats_row", [int(inserted), loop.n_loops], torch.int32,
            d.device)])
        s = s._replace(
            map=m, loop=loop, traj_ref=traj_ref,
            prev=steps.FrameObs(res.feats, res.depth, lm_after),
            last_R=R, last_t=t, vel_R=res.vel_R, vel_t=res.vel_t,
            have_vel=not loop_fired, ref_kf=new_kf if inserted else ref_kf,
            last_kf_frame=s.frame_idx if inserted else s.last_kf_frame,
            maint_kf=mkf, maint_phase=phase, maint_neighbors=nbrs,
            maint_lambda=lam, n_compact_lm=s.n_compact_lm + did_lm,
            n_compact_kf=s.n_compact_kf + did_kf)
        return self.write_traj(s, R, t, res.Rcr, res.tcr, ref_kf, True,
                               stats8)

    def _need_keyframe(self, s: AutoState, res, n_kf: int, local_in: int,
                       ref_matches: int, close_pack: int) -> bool:
        """NeedNewKeyFrame (Tracking.cc:1140-1244) for a tracked frame."""
        cfg = self.cfg
        c1a = s.frame_idx - s.last_kf_frame >= cfg.fps
        c1b = s.maint_kf < 0  # mapping idle: no keyframe under maintenance
        if self.is_mono:
            # no close-point rule, thRefRatio 0.9 (Tracking.cc:1205); and an
            # insert may interrupt the maintenance cycle once tracking has
            # decayed below 70% of the reference keyframe, as the
            # reference's InterruptBA lets it (:1216-1232)
            need_close, th_ref = False, 0.9
            c1b = c1b or _f32_lt_scaled(local_in, ref_matches, 0.7)
        else:
            need_close = close_pack // 10000 < 100 and close_pack % 10000 > 70
            th_ref = 0.4 if n_kf < 2 else 0.75
        c1c = _f32_lt_scaled(local_in, ref_matches, 0.25) or need_close
        c2 = ((_f32_lt_scaled(local_in, ref_matches, th_ref) or need_close)
              and local_in > 15)
        live_kf = int(spans.to_host("do_track.live_kf",
                                    res.map.kf_valid.sum()))
        return ((c1a or c1b or c1c) and c2 and live_kf < self.k_max
                and not self.localization_only)

    @spans.span("do_relocalize")
    def do_relocalize(self, s: AutoState, feats: FeatureSet, d) -> AutoState:
        """Relocalization (Tracking.cc:1582-1778): BoW candidate keyframe,
        descriptor matching, EPnP RANSAC, pose-only optimization and a
        local-map refill, accepted at >= 50 inliers (:1752). One candidate
        per lost frame, round-robin over the top 5 across frames; a refill
        in (30, 50) inliers searches again with th=3 and ORBdist 64
        (:1727-1747). The frame stays invalid until it succeeds."""
        cfg = self.cfg
        m = s.map

        def stay():
            return self.write_traj(s, s.last_R, s.last_t, s.last_R, s.last_t,
                                   s.ref_kf, False, self._stats8(s))

        voc = self.voc
        q_idx, q_w = V.bow_sparse(voc, V.transform(voc, feats.desc,
                                                   feats.valid),
                                  feats.valid, s.loop.bow_idx.shape[1])
        scr = V.score_l1_sparse(q_idx, q_w, s.loop.bow_idx, s.loop.bow_w,
                                voc.n_words)
        ids = torch.arange(self.k_max, device=d.device)
        scr = torch.where(m.kf_valid & (ids < m.n_kf), scr, -1.0)
        top_s, top_i = (spans.to_host(site, a) for site, a in zip(
            ("do_relocalize.scores", "do_relocalize.candidates"),
            sort_top_k(scr, 5)))
        n_cand = sum(v > 0 for v in top_s)
        pick = (s.frame_idx - max(s.lost, 0)) % max(n_cand, 1)
        cand = top_i[pick]
        # each gate below fails the attempt as the JAX package's combined
        # test does; later stages are skipped instead of computed
        if not top_s[pick] > 0:
            return stay()
        kf_lm = m.kf_lm[cand]
        kf_has = (kf_lm >= 0) & m.kf_feat_valid[cand] & m.lm_valid[
            kf_lm.clamp(min=0).long()]
        frame_lm = torch.empty(feats.xy.shape[0], dtype=torch.int32,
                               device=d.device)
        _, _, matched = msearch.search_brute(
            m.kf_desc[cand], feats.desc, kf_has, feats.valid, ratio=0.75,
            angle_q=m.kf_angle[cand], angle_t=feats.angle, values=kf_lm,
            out=frame_lm)
        if int(spans.to_host("do_relocalize.matches", matched.sum())) < 15:
            return stay()
        cam = self.cam
        res = pnp.solve_ransac(
            s.loop.gen, (cam.fx, cam.fy, cam.cx, cam.cy),
            m.lm_pw[frame_lm.clamp(min=0).long()], feats.xy,
            msearch.sigma2_at(feats.octave), (frame_lm >= 0) & feats.valid,
            max_iters=300)
        if int(spans.to_host("do_relocalize.pnp_inliers", res.n_inliers)) < 10:
            return stay()
        tr = steps.pose_optimize_one(cam, m, feats, frame_lm, res.R, res.t)
        if int(spans.to_host("do_relocalize.pose_inliers", tr.n_inliers)) < 10:
            return stay()
        local_mask = steps.local_landmark_mask(m, cand)
        res2, m2 = steps.track_local_map(cam, m, feats, tr.lm, tr.R, tr.t,
                                         local_mask, 10.0, cfg.width,
                                         cfg.height, cfg.desc_th)
        if 30 < int(spans.to_host("do_relocalize.local_inliers",
                                  res2.n_inliers)) < 50:
            res2, m2 = steps.track_local_map(cam, m2, feats, res2.lm, res2.R,
                                             res2.t, local_mask, 3.0,
                                             cfg.width, cfg.height, 64)
        n2 = int(spans.to_host("do_relocalize.inliers", res2.n_inliers))
        if n2 < 50:
            return stay()
        stats8 = self._stats8(
            s, c2=int(spans.to_host("do_relocalize.stats_inliers",
                                    tr.n_inliers)),
            c3=n2, c6=2, c7=s.loop.n_loops)
        s = s._replace(map=m2, prev=steps.FrameObs(feats, d, res2.lm),
                       last_R=res2.R, last_t=res2.t, have_vel=False,
                       ref_kf=cand, lost=-1)
        Rcr, tcr = se3.compose(res2.R, res2.t, *se3.inverse(m2.kf_R[cand],
                                                            m2.kf_t[cand]))
        return self.write_traj(s, res2.R, res2.t, Rcr, tcr, cand, True,
                               stats8)

    def do_reset(self, s: AutoState) -> AutoState:
        """Lost with an immature map resets the tracker (Tracking.cc:542-551);
        the trajectory rings and the random generator are kept."""
        dev = s.last_t.device
        eye = torch.eye(3, device=dev)
        s = s._replace(
            map=empty_map(self.cfg.map_cfg, dev),
            loop=auto_loop.empty_loop_carry(
                self.k_max, s.loop.bow_idx.shape[1], dev, gen=s.loop.gen),
            prev=_empty_prev(self.cfg.n_features, dev),
            last_R=eye, last_t=torch.zeros(3, device=dev), have_vel=False,
            ref_kf=0, last_kf_frame=-1, initialized=False, lost=-1,
            init_frame_id=-1, maint_kf=-1, maint_phase=0,
            maint_neighbors=NO_NEIGHBORS,
            maint_lambda=torch.full_like(s.maint_lambda, 1e-4))
        return self.write_traj(s, s.last_R, s.last_t, s.last_R, s.last_t, 0,
                               False, self._stats8(s, c6=3))

    def run_frame(self, s: AutoState, feats: FeatureSet, d) -> AutoState:
        if s.lost >= 0:
            # localization mode keeps the map it was given: relocalize
            if not self.localization_only and int(
                    spans.to_host("run_frame.n_kf", s.map.n_kf)) <= 5:
                s = self.do_reset(s)
            elif self.voc is not None:
                s = self.do_relocalize(s, feats, d)
            else:  # no vocabulary, no relocalization: the frame is invalid
                s = self.write_traj(s, s.last_R, s.last_t, s.last_R, s.last_t,
                                    s.ref_kf, False, self._stats8(s))
        elif s.initialized:
            s = self.do_track(s, feats, d)
        elif self.is_mono:
            s = self.do_initialize_mono(s, feats, d)
        else:
            s = self.do_initialize(s, feats, d)
        return s._replace(frame_idx=s.frame_idx + 1)


def build_auto_step(extractor: OrbExtractor, cfg: TrackerConfig,
                    traj_capacity: int, voc: V.Vocabulary | None = None,
                    localization_only: bool = False) -> AutoStep:
    return AutoStep(extractor, cfg, traj_capacity, voc, localization_only)


@dataclass
class AutoTrackerConfig:
    traj_capacity: int = 4096  # trajectory ring size (frames)
    # BoW relocalization and loop closing against the packaged vocabulary
    loop_closing: bool = True
    # track against the frozen map, never insert keyframes (reference:
    # System::ActivateLocalizationMode, Tracking.cc:222-235); combine with
    # checkpoint.load_auto_state for map-based localization
    localization_only: bool = False
    # RGB-D frames uploaded per batch: > 1 buffers frames on the host and
    # uploads B at a time (B frames of latency); 1 = each frame at once
    batch_frames: int = 1


class AutoTracker:
    """RGB-D, stereo or monocular tracker whose map and trajectory live on
    ``device``.

        tr = AutoTracker(cfg, device="cuda")
        for img, depth in frames:          # uint8 [H, W], uint16 [H, W]
            tr.process_rgbd(img, depth)
        result = tr.finalize()

    With ``TrackerConfig(sensor="stereo", ...)`` the frames are rectified
    pairs, ``tr.process_stereo(left, right)``; with ``sensor="mono"`` single
    images, ``tr.process_mono(img)``, and the map's scale is the monocular
    gauge (median scene depth 1 after the bootstrap). Input with lens
    distortion is refused. ``AutoTrackerConfig(localization_only=True)``
    after ``checkpoint.load_auto_state`` tracks against a saved map;
    ``batch_frames`` > 1 buffers RGB-D frames until a batch is full
    (``drain`` runs what is left, as ``sync`` and ``finalize`` do).
    """

    def __init__(self, cfg: TrackerConfig,
                 auto_cfg: AutoTrackerConfig | None = None,
                 device="cuda"):
        auto_cfg = auto_cfg or AutoTrackerConfig()
        if cfg.map_cfg.n_feat != cfg.n_features:
            raise ValueError("map_cfg.n_feat must equal n_features")
        if cfg.sensor not in ("rgbd", "stereo", "mono"):
            raise ValueError(f"unknown sensor {cfg.sensor!r}")
        if cfg.has_distortion:
            raise NotImplementedError(
                "the port runs undistorted (or rectified) input only")
        self.cfg = cfg
        self.auto_cfg = auto_cfg
        self.device = torch.device(device)
        self.extractor = OrbExtractor(n_features=cfg.n_features)
        self.voc = None
        if auto_cfg.loop_closing:
            self.voc = V.load_default_vocabulary(self.device)
            auto_loop.warm_up_autodiff()
        self._step = build_auto_step(self.extractor, cfg,
                                     auto_cfg.traj_capacity, self.voc,
                                     auto_cfg.localization_only)
        self.state = empty_auto_state(cfg, auto_cfg.traj_capacity,
                                      self.device)
        self.frame_count = 0
        self.timestamps: list[float] = []
        self._batch: list = []  # buffered (img, depth) while batch_frames > 1

    def process_rgbd(self, img, depth, timestamp: float | None = None):
        """Track one frame: uint8 image and raw (e.g. uint16) depth or
        float depth in metres (then ``cfg.depth_factor`` 1.0), as numpy
        arrays or tensors. With ``batch_frames`` > 1 the frame waits on the
        host until the batch is full."""
        with spans.frame(self.frame_count):
            self.timestamps.append(self.frame_count / self.cfg.fps
                                   if timestamp is None else timestamp)
            self.frame_count += 1
            if self.auto_cfg.batch_frames <= 1:
                with _UPLOAD:
                    img = upload_frame(img, self.device)
                    depth = upload_frame(depth, self.device, depth=True)
                self.state = self._step(self.state, img, depth)
                return
            self._batch.append((img, depth))
            if len(self._batch) >= self.auto_cfg.batch_frames:
                imgs, depths = (_stack(f) for f in zip(*self._batch))
                self._batch = []
                self.state = self._step.rgbd_batch(self.state, imgs, depths)

    def drain(self):
        """Run the buffered frames of a partial batch, one by one."""
        for img, depth in self._batch:
            self.state = self._step(
                self.state, upload_frame(img, self.device),
                upload_frame(depth, self.device, depth=True))
        self._batch = []

    def process_stereo(self, img_left, img_right,
                       timestamp: float | None = None):
        """Track one rectified stereo pair (reference: System::TrackStereo
        System.cc:169): uint8 images as numpy arrays or tensors."""
        with spans.frame(self.frame_count):
            with _UPLOAD:
                img_left = upload_frame(img_left, self.device)
                img_right = upload_frame(img_right, self.device)
            self.state = self._step.stereo(self.state, img_left, img_right)
            self.timestamps.append(self.frame_count / self.cfg.fps
                                   if timestamp is None else timestamp)
            self.frame_count += 1

    def process_mono(self, img, timestamp: float | None = None):
        """Track one monocular frame (reference: System::TrackMonocular
        System.cc:224): a uint8 or float image, numpy array or tensor."""
        with spans.frame(self.frame_count):
            with _UPLOAD:
                img = upload_frame(img, self.device)
            self.state = self._step.mono(self.state, img)
            self.timestamps.append(self.frame_count / self.cfg.fps
                                   if timestamp is None else timestamp)
            self.frame_count += 1

    def sync(self):
        """Run any buffered frames, then wait for the device to drain (no
        data readback; no wait on the CPU)."""
        self.drain()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def finalize(self) -> dict:
        """The run's trajectory, flags and per-frame statistics, in frame
        order (buffered frames run first)."""
        self.drain()
        s = self.state
        T = self.auto_cfg.traj_capacity
        n = self.frame_count
        order = np.arange(n) if n <= T else np.arange(n - T, n) % T

        def host(a):
            return a.cpu().numpy()[order]

        return {
            "R": host(s.traj_R), "t": host(s.traj_t),
            "Rcr": host(s.traj_Rcr), "tcr": host(s.traj_tcr),
            "ref_kf": host(s.traj_ref), "valid": host(s.traj_valid),
            "stats": host(s.traj_stats),
            "timestamps": np.asarray(self.timestamps[-len(order):]),
            "lost_at": s.lost, "initialized": s.initialized,
            "n_keyframes": int(s.map.n_kf), "n_frames": n,
            "n_loops_closed": s.loop.n_loops,
            "n_obs_dropped": int(s.map.n_obs_drop),
            "n_compact_kf": s.n_compact_kf, "n_compact_lm": s.n_compact_lm,
        }

    def trajectory_kitti(self) -> list[str]:
        """KITTI lines (row-major camera->world 3x4 per frame), like
        SaveTrajectoryKITTI (System.cc:436-486). Invalid frames are left
        out, as the JAX package leaves them out."""
        out = self.finalize()
        lines = []
        for i in range(len(out["timestamps"])):
            if not out["valid"][i]:
                continue
            R, t = out["R"][i], out["t"][i]
            P = np.hstack([R.T, (-R.T @ t)[:, None]]).reshape(-1)
            lines.append(" ".join(f"{v:.9e}" for v in P))
        return lines

    def trajectory_tum(self) -> list[str]:
        """TUM lines (timestamp tx ty tz qx qy qz qw), camera->world
        (SaveTrajectoryTUM, System.cc:336-394)."""
        out = self.finalize()
        lines = []
        for i in range(len(out["timestamps"])):
            if not out["valid"][i]:
                continue
            R, t = out["R"][i], out["t"][i]
            Rwc = R.T
            twc = -R.T @ t
            qw, qx, qy, qz = se3.matrix_to_quat(
                torch.as_tensor(np.ascontiguousarray(Rwc))).tolist()
            lines.append(f"{out['timestamps'][i]:.6f} {twc[0]:.7f} "
                         f"{twc[1]:.7f} {twc[2]:.7f} {qx:.7f} {qy:.7f} "
                         f"{qz:.7f} {qw:.7f}")
        return lines
