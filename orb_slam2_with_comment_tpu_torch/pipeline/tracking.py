"""Host-driven tracking state machine (port of pipeline/tracking.py).

The reference's Tracking thread (Tracking.cc Track(), :287-581): the
decisions (initialization, motion model or reference keyframe, local map,
NeedNewKeyFrame, lost, relocalization) are taken in Python from a few
scalars read back per frame, while the tensors stay on ``device``. Local
mapping runs as one keyframe_step after each insertion; loop detection is
queued at the insertion and gated on the next frame; a loop's global BA
runs in chunks polled once per frame (LoopCloser).

RGB-D tracking is pipelined: each frame's fused step (extraction and
tracking) is queued and its six statistics copied to the host without
blocking, in batches of ``fetch_batch`` frames; a frame's keyframe and
lost decisions are taken once its batch has landed (a CUDA event has
passed), or when more than ``pipeline_depth`` frames are in flight. With
pipeline_depth = 0 every frame is decided at once.

The map lives in fixed-capacity tensors: when they run low the tracker
compacts dead slots and, if still short, doubles the capacity (grow_map),
keeping each keyframe's identity as a uid across slot changes and the
evicted keyframes' poses in an archive, relative to a live one.

Random draws (the relocalization's EPnP RANSAC, the monocular
initializer's 8-point sets, the loop closer's Sim3 RANSAC) come from one
torch.Generator per tracker, ``gen``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np
import torch

from ..frontend.extractor import OrbExtractor
from ..geometry import se3
from ..mapstate.map import (MapConfig, MapState, compact_keyframes,
                            compact_landmarks, empty_map, grow_map,
                            landmark_compaction_order, set_last)
from ..matching import search as msearch
from ..matching.search import FeatureSet
from ..optim.residuals import CamParams
from . import steps
from .loop_closing import Readback

I32 = torch.int32
SEED = 0  # the JAX package seeds its monocular initializer with PRNGKey(0)


class TrackState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


@dataclass
class TrackerConfig:
    sensor: str = "rgbd"  # "mono" | "stereo" | "rgbd"
    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    bf: float = 40.0
    width: int = 640
    height: int = 480
    n_features: int = 1000
    th_depth: float = 40.0  # in baseline units; meters = th_depth * bf / fx
    fps: float = 30.0
    min_init_features: int = 500
    # monocular bootstrap: matches the two-view initializer needs, and
    # tracked points the two-keyframe map must keep (Tracking.cc:687, 793)
    min_init_matches: int = 100
    map_cfg: MapConfig = field(default_factory=MapConfig)
    # the JAX package's field for the local BA's iterations per keyframe;
    # neither package reads it (keyframe_step runs 5)
    local_ba_iters: int = 5
    # Hamming acceptance of the projection searches (reference TH_HIGH)
    desc_th: int = 100
    desc_th_local: int = 100
    # raw depth -> meters (reference: DepthMapFactor, Tracking.cc:144-148)
    depth_factor: float = 1.0
    # radial-tangential distortion (k1, k2, p1, p2, k3) of the keypoints
    # (Frame::UndistortKeyPoints, Frame.cc:434-469); only the host tracker
    # undistorts
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)
    # the host tracker doubles the map's capacity when compaction is not
    # enough (the reference's map is unbounded, Map.cc:32-44)
    allow_map_growth: bool = True

    @property
    def has_distortion(self) -> bool:
        return any(abs(d) > 1e-12 for d in self.dist)

    @property
    def cam(self) -> CamParams:
        return CamParams.of(self.fx, self.fy, self.cx, self.cy, self.bf)

    @property
    def depth_threshold(self) -> float:
        """ThDepth * baseline in meters (reference: Tracking.cc:137)."""
        return self.th_depth * self.bf / self.fx


def upload_frame(a, device, depth: bool = False) -> torch.Tensor:
    """A frame on ``device``: raw unsigned depth goes up as int32 (many ops
    lack uint16), float64 arrays as float32, anything else (float32 depth
    in metres, uint8 images, tensors) as it is."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if depth and a.dtype.kind == "u":
        a = a.astype(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a).to(device)


_VOC_CACHE: dict = {}


def default_vocabulary(device="cpu"):
    """The packaged vocabulary on ``device``, loaded once per process and
    device (reference: System.cc:71 loads ORBvoc.txt)."""
    key = str(torch.device(device))
    if key not in _VOC_CACHE:
        from ..place.vocabulary import load_default_vocabulary
        _VOC_CACHE[key] = load_default_vocabulary(device)
    return _VOC_CACHE[key]


def _map_counters(m: MapState) -> torch.Tensor:
    """[4] int32: slots used and live, of keyframes then of landmarks."""
    return torch.stack([m.n_kf, m.kf_valid.sum(dtype=I32), m.n_lm,
                        m.lm_valid.sum(dtype=I32)])


def _remap_ids(ids, inv, old_valid):
    """Landmark ids through an old->new permutation; ids of landmarks dead
    before it become -1."""
    safe = ids.clamp(min=0).long()
    return torch.where((ids >= 0) & old_valid[safe], inv[safe], -1)


class Tracker:
    """Monocular, stereo or RGB-D tracker over a map on ``device``."""

    def __init__(self, cfg: TrackerConfig, device="cuda"):
        if cfg.map_cfg.n_feat != cfg.n_features:
            raise ValueError(
                f"map_cfg.n_feat ({cfg.map_cfg.n_feat}) must equal "
                f"n_features ({cfg.n_features}): keyframe rows are "
                "fixed-width feature arrays")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Tracker: no CUDA device; pass device='cpu' "
                               "to run the plain versions on the CPU")
        self.cfg = cfg
        self.cam = cfg.cam
        self.extractor = OrbExtractor(n_features=cfg.n_features)
        self.map: MapState = empty_map(cfg.map_cfg, self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(SEED)
        self._undist_cam = None
        if cfg.has_distortion:
            from ..models.camera import PinholeCamera
            self._undist_cam = PinholeCamera.create(
                cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.dist, cfg.width,
                cfg.height)
        self.state = TrackState.NOT_INITIALIZED
        self.last_obs: steps.FrameObs | None = None
        self.last_R = torch.eye(3, device=self.device)
        self.last_t = torch.zeros(3, device=self.device)
        self.velocity = None  # (R_rel, t_rel): T_cur<-last
        self.ref_kf = 0
        self.last_kf_frame = -1
        self.frame_count = 0
        self.trajectory: list = []  # (frame id, R, t)
        self.n_kf_host = 0
        self._n_inliers = 0
        # keyframe identity across slot recycling: kf_uids[slot] is the
        # uid (insertion order) of the keyframe in that slot; rel_log keys
        # frames by uid; compaction archives an evicted keyframe as
        # uid -> (anchor uid, R_rel, t_rel), T_evicted = rel o T_anchor, so
        # later corrections of the live map reach it (the reference walks
        # the spanning tree to a live parent, System.cc:376-382); anchor
        # -1 marks an absolute pose
        self.kf_uids: list[int] = []
        self.kf_archive: dict = {}
        self._kf_uid_counter = 0
        self._maintenance_due = False
        self._counter_fut = None
        # after a relocalization: 1 s keyframe embargo (Tracking.cc:1150-
        # 1160), wider local search (:1393-1399), higher inlier bar
        # (:1119-1126)
        self.last_reloc_frame = -(10 ** 9)
        self._step = steps.build_track_frame_step(
            self.extractor, cfg.width, cfg.height, self._undist_cam)
        self.db = None
        self.loop_closer = None
        self._init_obs: steps.FrameObs | None = None
        self._init_frame_id = -1
        # tracking only: the map frozen, no keyframes (mbOnlyTracking,
        # Tracking.cc:222-235)
        self.localization_only = False
        # (frame id, timestamp, reference keyframe uid, Rcr, tcr): saved
        # trajectories follow later keyframe corrections
        # (mlRelativeFramePoses, Tracking.cc:562-579)
        self.rel_log: list = []
        self._timestamp = 0.0
        # pipelined RGB-D frames: [result, frame id, readback, ref_kf, row,
        # timestamp]; _open holds those not yet in a readback batch
        self._pending: list = []
        self._open: list = []
        self.pipeline_depth = 8
        self.fetch_batch = 4
        self._pending_loop = None

    # -- helpers ------------------------------------------------------------
    def _new_lm(self, n: int) -> torch.Tensor:
        return torch.full((n,), -1, dtype=I32, device=self.device)

    def _frame_obs(self, img, depth_map) -> steps.FrameObs:
        feats = self.extractor(upload_frame(img, self.device))
        xy = feats.xy
        if depth_map is not None:
            H, W = self.cfg.height, self.cfg.width
            dm = upload_frame(depth_map, self.device, depth=True).to(
                torch.float32)
            if self.cfg.depth_factor != 1.0:
                dm = dm * float(np.float32(self.cfg.depth_factor))
            yi = torch.round(xy[:, 1]).long().clamp(0, H - 1)
            xi = torch.round(xy[:, 0]).long().clamp(0, W - 1)
            d = dm[yi, xi]
            # occlusion-edge gate: a 3x3 depth neighborhood with an invalid
            # return or more than 4% spread rejects the feature
            dmin = dmax = d
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    dn = dm[(yi + dy).clamp(0, H - 1), (xi + dx).clamp(0, W - 1)]
                    dmin = torch.minimum(dmin, dn)
                    dmax = torch.maximum(dmax, dn)
            edge = (dmin <= 0) | ((dmax - dmin) > 0.04 * d.clamp(min=1e-6))
            d = torch.where((d > 0) & ~edge, d, -1.0)
        else:
            d = torch.full((xy.shape[0],), -1.0, device=self.device)
        # undistort after the depth sampling, before mvuRight
        # (Frame.cc:687-698)
        if self._undist_cam is not None:
            xy = self._undist_cam.undistort_points(xy)
        ur = steps.make_feature_uvr(xy[:, 0], d, self.cam.bf)
        fs = FeatureSet(xy, ur, feats.octave, feats.angle, feats.desc,
                        feats.valid)
        return steps.FrameObs(fs, d, self._new_lm(xy.shape[0]))

    def _frame_obs_stereo(self, img_left, img_right) -> steps.FrameObs:
        """A rectified pair: joint extraction and the row-band depth
        association (Frame.cc:61-117, 501-675)."""
        feats, sd = self.extractor.stereo(
            upload_frame(img_left, self.device),
            upload_frame(img_right, self.device), self.cam.bf, self.cam.fx)
        fs = FeatureSet(feats.xy, sd.u_right, feats.octave, feats.angle,
                        feats.desc, feats.valid)
        return steps.FrameObs(fs, sd.depth, self._new_lm(feats.xy.shape[0]))

    def _log_pose(self, frame_id, R, t, ref_kf=None, Rcr=None, tcr=None,
                  ts=None):
        self.trajectory.append((frame_id, R, t))
        if ref_kf is None:
            ref_kf = self.ref_kf
        if Rcr is None:
            Rcr, tcr = se3.compose(R, t, *se3.inverse(self.map.kf_R[ref_kf],
                                                      self.map.kf_t[ref_kf]))
        ref_uid = self.kf_uids[ref_kf] if ref_kf < len(self.kf_uids) else 0
        if ts is None:
            ts = self._timestamp
        self.rel_log.append((frame_id, ts, ref_uid, Rcr, tcr))

    # -- RGB-D ----------------------------------------------------------------
    def process_rgbd(self, img, depth_map, frame_id=None):
        """Track one RGB-D frame; returns (R, t) world->camera, or None.
        The pose of a frame still in flight is returned before its
        decisions are taken: it may yet turn out LOST."""
        if frame_id is None:
            frame_id = self.frame_count
        self.frame_count += 1
        self._check_maintenance()

        if self.state == TrackState.NOT_INITIALIZED:
            ok = self._initialize(self._frame_obs(img, depth_map), frame_id)
            return (self.last_R, self.last_t) if ok else None

        if self.state == TrackState.LOST:
            obs = self._frame_obs(img, depth_map)
            if self.db is not None and self._relocalize(obs, frame_id):
                return self.last_R, self.last_t
            return None

        cfg = self.cfg
        if self._pending:
            # chained on the newest in-flight frame and its velocity
            p = self._pending[-1][0]
            prev_obs = steps.FrameObs(p.feats, p.depth, p.lm)
            prev_R, prev_t = p.R, p.t
            vel_R, vel_t = p.vel_R, p.vel_t
            have_vel = True
        else:
            prev_obs = self.last_obs
            prev_R, prev_t = self.last_R, self.last_t
            have_vel = self.velocity is not None
            vel_R, vel_t = (self.velocity if have_vel else
                            (torch.eye(3, device=self.device),
                             torch.zeros(3, device=self.device)))
        min_obs = 2 if self.n_kf_host > 2 else 1
        th_local = 5.0 if frame_id < self.last_reloc_frame + 2 else 3.0
        res = self._step(
            self.cam, self.map, prev_obs, prev_R, prev_t, vel_R, vel_t,
            have_vel, self.ref_kf, upload_frame(img, self.device),
            upload_frame(depth_map, self.device, depth=True),
            float(np.float32(cfg.depth_factor)),
            float(np.float32(cfg.depth_threshold)), cfg.desc_th,
            cfg.desc_th_local, min_obs, th_local)
        self.map = res.map
        # the frame's own timestamp: it is finalized frames later
        entry = [res, frame_id, None, self.ref_kf, -1, self._timestamp]
        self._pending.append(entry)
        self._open.append(entry)
        if len(self._open) >= self.fetch_batch:
            self._submit_fetch()
        while self._pending and (
                (self._pending[0][2] is not None and self._pending[0][2].done())
                or len(self._pending) > self.pipeline_depth):
            if self._pending[0][2] is None:
                self._submit_fetch()
            if not self._finalize(*self._pending.pop(0)):
                # that frame was LOST: the frames chained on its pose go
                # (the reference drops frames until it relocalizes,
                # Tracking.cc:528)
                self._pending.clear()
                self._open.clear()
                return None
        return res.R, res.t

    def _submit_fetch(self):
        """One host copy of the open frames' stacked statistics."""
        if not self._open:
            return
        batch, self._open = self._open, []
        rb = Readback(torch.stack([e[0].stats for e in batch]))
        for row, e in enumerate(batch):
            e[2] = rb
            e[4] = row

    def _finalize(self, res, frame_id, fut=None, ref_kf=None, row=None,
                  ts=None) -> bool:
        """A frame's deferred epilogue: its statistics (the only readback),
        the lost and keyframe decisions, the host state. False when the
        frame was LOST."""
        self._finish_pending_loop()
        if fut is not None:
            stats = fut.result()[0][row]
        else:
            stats = res.stats.cpu().numpy()
        _, _, track1_in, local_in, ref_matches, close_pack = (
            int(x) for x in stats)
        min_local = (50 if frame_id < self.last_reloc_frame + self.cfg.fps
                     else 30)
        if track1_in < 10 or local_in < min_local:
            if self._lost_transition():
                return False
            if self.db is not None:
                self._relocalize(steps.FrameObs(res.feats, res.depth, res.lm),
                                 frame_id)
            return False
        self.state = TrackState.OK
        R, t = res.R, res.t
        self._n_inliers = local_in
        obs = steps.FrameObs(res.feats, res.depth, res.lm)
        self.velocity = (res.vel_R, res.vel_t)
        self.last_R, self.last_t = R, t
        self.last_obs = obs
        self._log_pose(frame_id, R, t, ref_kf=ref_kf, Rcr=res.Rcr,
                       tcr=res.tcr, ts=ts)
        tracked_close, non_tracked_close = (close_pack // 10000,
                                            close_pack % 10000)
        if (not self.localization_only and self._need_new_keyframe_stats(
                local_in, ref_matches, tracked_close, non_tracked_close,
                frame_id)):
            self._create_keyframe(obs, R, t, frame_id)
        return True

    def reset(self):
        """Tracking::Reset (Tracking.cc:1780-1826): map, database and
        per-run state cleared; the next frame initializes again."""
        self.map = empty_map(self.cfg.map_cfg, self.device)
        self.state = TrackState.NOT_INITIALIZED
        self.last_obs = None
        self.velocity = None
        self.ref_kf = 0
        self.last_kf_frame = -1
        self.n_kf_host = 0
        self._n_inliers = 0
        self.kf_uids = []
        self.kf_archive = {}
        self._kf_uid_counter = 0
        self.db = None
        self.loop_closer = None
        self._init_obs = None
        self._init_frame_id = -1
        self._pending.clear()
        self._open.clear()
        self._pending_loop = None
        self._counter_fut = None
        self._maintenance_due = False
        self.trajectory.clear()
        self.rel_log.clear()

    def _lost_transition(self) -> bool:
        """Entering LOST: with at most 5 keyframes the map was never good
        and is reset (Tracking.cc:542-551). True if it was."""
        if self.n_kf_host <= 5:
            self.reset()
            return True
        self.state = TrackState.LOST
        self.velocity = None
        return False

    def _finish_pending_loop(self):
        """Complete a queued loop detection, if any."""
        if self._pending_loop is not None:
            handle, self._pending_loop = self._pending_loop, None
            corrected = self.loop_closer.finish(self.map, handle)
            if corrected is not None:
                self.map = corrected

    def _poll_gba(self):
        """One chunk of a running global BA (the GBA thread,
        LoopClosing.cc:790-901)."""
        if self.loop_closer is not None and self.loop_closer.gba_running():
            out = self.loop_closer.poll_gba(self.map)
            if out is not None:
                self.map = out

    def flush(self):
        """Finalize the frames in flight, a queued loop detection and a
        running global BA. Call before reading trajectories, the state or
        the map at a sequence boundary."""
        self._submit_fetch()
        while self._pending:
            if not self._finalize(*self._pending.pop(0)):
                self._pending.clear()
                self._open.clear()
        self._finish_pending_loop()
        while self.loop_closer is not None and self.loop_closer.gba_running():
            self._poll_gba()

    # -- map lifecycle: slot recycling and capacity growth ----------------
    # Maintenance runs between frames with the pipeline drained: frames in
    # flight hold landmark ids a compaction would invalidate.

    @property
    def _kf_margin(self) -> int:
        return self.pipeline_depth + 2

    @property
    def _lm_margin(self) -> int:
        return (self.pipeline_depth // 3 + 2) * self.cfg.n_features

    def _check_maintenance(self):
        """At every process_* entry: a GBA chunk, the map counters if they
        have landed, and the maintenance pass when due."""
        self._poll_gba()
        if self._counter_fut is not None and self._counter_fut.done():
            n_kf, live_kf, n_lm, live_lm = (
                int(x) for x in self._counter_fut.result()[0])
            self._counter_fut = None
            if n_lm > self.map.lm_pw.shape[0] - self._lm_margin:
                self._maintenance_due = True
        if self.n_kf_host >= self.map.kf_R.shape[0] - self._kf_margin:
            self._maintenance_due = True
        if self._maintenance_due:
            self.flush()
            self._run_maintenance()
            self._maintenance_due = False

    def _run_maintenance(self):
        m = self.map
        K, L = m.kf_R.shape[0], m.lm_pw.shape[0]
        n_kf, live_kf, n_lm, live_lm = _map_counters(m).tolist()
        grow_k = grow_l = None
        if n_lm > L - self._lm_margin:
            if n_lm - live_lm >= min(L // 8, self._lm_margin):
                old_valid = m.lm_valid
                inv = torch.empty(L, dtype=I32, device=self.device)
                inv[landmark_compaction_order(old_valid)] = torch.arange(
                    L, dtype=I32, device=self.device)
                m = compact_landmarks(m)
                if self.last_obs is not None:
                    self.last_obs = self.last_obs._replace(
                        lm=_remap_ids(self.last_obs.lm, inv, old_valid))
                n_lm = live_lm
            if n_lm > L - self._lm_margin:
                grow_l = 2 * L
        if self.n_kf_host >= K - self._kf_margin:
            if n_kf - live_kf > 0:
                m = self._compact_keyframes_host(m)
            if self.n_kf_host >= K - self._kf_margin:
                grow_k = 2 * K
        if (grow_k or grow_l) and self.cfg.allow_map_growth:
            m = grow_map(m, k_max=grow_k or K, l_max=grow_l or L)
            if grow_k and self.db is not None:
                self.db.grow(grow_k)
        self.map = m

    def _compact_keyframes_host(self, m: MapState) -> MapState:
        """compact_keyframes and its host mirror: evicted poses archived by
        uid, kf_uids repacked, ref_kf remapped, database rows and the loop
        closer's slot state permuted."""
        valid = m.kf_valid.cpu().numpy()
        n_live = int(valid.sum())
        kf_R = m.kf_R.cpu().numpy()
        kf_t = m.kf_t.cpu().numpy()
        live_slots = np.where(valid)[0]
        for slot, uid in enumerate(self.kf_uids):
            if valid[slot]:
                continue
            if len(live_slots) == 0:
                self.kf_archive[uid] = (-1, kf_R[slot].copy(),
                                        kf_t[slot].copy())
                continue
            # relative to the nearest live slot
            anchor = int(live_slots[np.argmin(np.abs(live_slots - slot))])
            Ra, ta = kf_R[anchor], kf_t[anchor]
            R_rel = kf_R[slot] @ Ra.T
            t_rel = kf_t[slot] - R_rel @ ta
            self.kf_archive[uid] = (self.kf_uids[anchor], R_rel, t_rel)
        rank = np.cumsum(valid) - valid
        self.kf_uids = [u for s, u in enumerate(self.kf_uids) if valid[s]]
        if valid[self.ref_kf]:
            self.ref_kf = int(rank[self.ref_kf])
        else:
            self.ref_kf = min(int(rank[self.ref_kf]), max(n_live - 1, 0))
        self.n_kf_host = n_live
        if self.db is not None:
            self.db.permute(np.where(valid)[0], n_live)
        if self.loop_closer is not None:
            self.loop_closer.remap_slots(rank, valid)
        return compact_keyframes(m)

    # -- monocular --------------------------------------------------------
    def process_mono(self, img, frame_id=None):
        """Track one monocular frame; returns (R, t) or None (reference:
        GrabImageMonocular, Tracking.cc:239). The scale is the monocular
        gauge: median scene depth 1 after the bootstrap."""
        if frame_id is None:
            frame_id = self.frame_count
        self.frame_count += 1
        self._check_maintenance()
        obs = self._frame_obs(img, None)
        if self.state == TrackState.NOT_INITIALIZED:
            ok = self._initialize_mono(obs, frame_id)
            return (self.last_R, self.last_t) if ok else None
        return self._process_obs(obs, frame_id)

    def _make_place_recognition(self, fix_scale: bool):
        from ..place.database import KeyFrameDatabase
        from .loop_closing import LoopCloser
        self.db = KeyFrameDatabase(default_vocabulary(self.device),
                                   self.map.kf_R.shape[0])
        self.loop_closer = LoopCloser(self.cam, self.db, fix_scale=fix_scale,
                                      width=self.cfg.width,
                                      height=self.cfg.height, gen=self.gen)

    def _initialize_mono(self, obs: steps.FrameObs, frame_id) -> bool:
        """Two-view bootstrap (MonocularInitialization Tracking.cc:638-726,
        CreateInitialMapMonocular :733-843)."""
        from ..solvers import initializer
        n_valid = int(obs.feats.valid.sum())
        if self._init_obs is None:
            if n_valid > 100:  # :644
                self._init_obs = obs
                self._init_frame_id = frame_id
            return False
        if n_valid <= 100:
            self._init_obs = None
            return False
        ref = self._init_obs
        idx, _, matched = msearch.search_for_initialization(
            ref.feats, obs.feats, ref.feats.xy)
        if int(matched.sum()) < self.cfg.min_init_matches:  # :687
            self._init_obs = None
            return False
        cam = self.cam
        res = initializer.initialize(
            self.gen, (cam.fx, cam.fy, cam.cx, cam.cy), ref.feats.xy,
            obs.feats.xy[idx.clamp(min=0).long()], matched)
        if not bool(res.success):
            return False  # keep the reference frame
        dev = self.device
        m = steps.insert_keyframe(self.map, ref, torch.eye(3, device=dev),
                                  torch.zeros(3, device=dev),
                                  self._init_frame_id)
        m = steps.insert_keyframe(m, obs, res.R, res.t, frame_id)
        m = steps.insert_landmarks_two_view(m, cam, 0, 1, idx, res.X,
                                            res.good & matched)
        m = steps.refresh_landmarks(m)
        m, _ = steps.local_bundle_adjustment(m, cam, 1, iters_a=20)  # :787
        med = float(steps.scene_median_depth(m, 0))
        n_tracked = int((m.kf_lm[1] >= 0).sum())
        if (not np.isfinite(med) or med <= 0
                or n_tracked < self.cfg.min_init_matches):  # :793-799
            self.map = empty_map(self.cfg.map_cfg, dev)
            self._init_obs = None
            return False
        self.map = steps.scale_map(m, float(np.float32(1.0 / med)))
        self.n_kf_host = 2
        self.kf_uids = [0, 1]
        self._kf_uid_counter = 2
        self.ref_kf = 1
        self.last_kf_frame = frame_id
        self.last_R = self.map.kf_R[1]
        self.last_t = self.map.kf_t[1]
        self.last_obs = obs._replace(lm=self.map.kf_lm[1])
        self.state = TrackState.OK
        self._log_pose(frame_id, self.last_R, self.last_t)
        self._make_place_recognition(fix_scale=False)
        self.db.add(0, ref.feats.desc, ref.feats.valid)
        self.db.add(1, obs.feats.desc, obs.feats.valid)
        self._init_obs = None
        return True

    # -- stereo and the generic flow ---------------------------------------
    def process_stereo(self, img_left, img_right, frame_id=None):
        """Track one rectified stereo pair; returns (R, t) or None
        (GrabImageStereo, Tracking.cc:168)."""
        if frame_id is None:
            frame_id = self.frame_count
        self.frame_count += 1
        self._check_maintenance()
        return self._process_obs(self._frame_obs_stereo(img_left, img_right),
                                 frame_id)

    def _process_obs(self, obs: steps.FrameObs, frame_id):
        """The unfused per-frame flow of the stereo and monocular paths:
        initialization, motion model or reference keyframe, local map,
        keyframe decision."""
        if self.state == TrackState.NOT_INITIALIZED:
            ok = self._initialize(obs, frame_id)
            return (self.last_R, self.last_t) if ok else None
        if self.state == TrackState.LOST:
            if self.db is not None and self._relocalize(obs, frame_id):
                return self.last_R, self.last_t
            return None
        R, t, obs, ok = self._track(obs, frame_id)
        if not ok:
            if self._lost_transition():
                return None
            if self.db is not None and self._relocalize(obs, frame_id):
                return self.last_R, self.last_t
            return None
        self.state = TrackState.OK
        self.velocity = se3.compose(R, t, *se3.inverse(self.last_R,
                                                       self.last_t))
        self.last_R, self.last_t = R, t
        self.last_obs = obs
        self._log_pose(frame_id, R, t)
        if not self.localization_only and self._need_new_keyframe(obs):
            self._create_keyframe(obs, R, t, frame_id)
        return R, t

    def _need_new_keyframe_stats(self, n_in, ref_matches, tracked_close,
                                 non_tracked_close, frame_id=None) -> bool:
        """NeedNewKeyFrame (Tracking.cc:1140-1244) from the fused step's
        statistics."""
        cfg = self.cfg
        if frame_id is None:
            frame_id = self.frame_count - 1
        if (frame_id < self.last_reloc_frame + cfg.fps
                and self.n_kf_host > cfg.fps):
            return False
        frames_since = frame_id - self.last_kf_frame
        need_close = tracked_close < 100 and non_tracked_close > 70
        th_ref = 0.4 if self.n_kf_host < 2 else 0.75
        c1a = frames_since >= cfg.fps
        c1b = frames_since >= 3  # the mapping thread's duty cycle
        c1c = n_in < ref_matches * 0.25 or need_close
        c2 = (n_in < ref_matches * th_ref or need_close) and n_in > 15
        if self.n_kf_host >= self.map.kf_R.shape[0]:
            return False  # at capacity, growth off or pending
        return (c1a or c1b or c1c) and c2

    def _initialize(self, obs: steps.FrameObs, frame_id) -> bool:
        """StereoInitialization (Tracking.cc:584-636): more than
        min_init_features features; every depth point becomes a landmark
        of keyframe 0."""
        if int(obs.feats.valid.sum()) <= self.cfg.min_init_features:
            return False
        R = torch.eye(3, device=self.device)
        t = torch.zeros(3, device=self.device)
        m = steps.insert_keyframe(self.map, obs, R, t, frame_id)
        self.map = steps.create_depth_landmarks(m, self.cam, 0, 1e9)
        self.n_kf_host += 1
        self.kf_uids = [0]
        self._kf_uid_counter = 1
        self.last_R, self.last_t = R, t
        self.last_obs = obs._replace(lm=self.map.kf_lm[0])
        self.ref_kf = 0
        self.last_kf_frame = frame_id
        self.state = TrackState.OK
        self._log_pose(frame_id, R, t)
        self._make_place_recognition(fix_scale=True)
        self.db.add(0, obs.feats.desc, obs.feats.valid)
        return True

    def _track(self, obs: steps.FrameObs, frame_id):
        cam, cfg = self.cam, self.cfg
        res = None
        # motion-model window: 7 px stereo / RGB-D, 15 px monocular
        # (Tracking.cc:1011-1024)
        th_mm = 15.0 if cfg.sensor == "mono" else 7.0
        if self.velocity is not None:
            R_pred, t_pred = se3.compose(*self.velocity, self.last_R,
                                         self.last_t)
            for th in (th_mm, 2 * th_mm):  # the widened retry
                res = steps.track_motion_model(
                    cam, self.map, self.last_obs, self.last_R, self.last_t,
                    obs.feats, R_pred, t_pred, th, float(cfg.width),
                    float(cfg.height), cfg.desc_th)
                if int(res.n_inliers) >= 10:
                    break
            else:
                res = None
        if res is None:
            res = steps.track_reference_keyframe(
                cam, self.map, self.ref_kf, obs.feats, self.last_R,
                self.last_t)
            if int(res.n_inliers) < 10:
                return None, None, obs, False
        # local-map radius (Tracking.cc:1393-1399)
        if frame_id < self.last_reloc_frame + 2:
            th_local = 5.0
        elif cfg.sensor == "rgbd":
            th_local = 3.0
        else:
            th_local = 1.0
        local_mask = steps.local_landmark_mask(self.map, self.ref_kf)
        res2, self.map = steps.track_local_map(
            cam, self.map, obs.feats, res.lm, res.R, res.t, local_mask,
            th_local, cfg.width, cfg.height, cfg.desc_th_local)
        self._n_inliers = int(res2.n_inliers)
        min_in = 50 if frame_id < self.last_reloc_frame + cfg.fps else 30
        if self._n_inliers < min_in:
            return None, None, obs, False
        return res2.R, res2.t, obs._replace(lm=res2.lm), True

    def _need_new_keyframe(self, obs) -> bool:
        """NeedNewKeyFrame (Tracking.cc:1140-1244) with the mapping thread
        always idle."""
        cfg = self.cfg
        frames_since = self.frame_count - 1 - self.last_kf_frame
        # reference-keyframe landmarks with >= min_obs observations; the
        # table counts keyframe slots, so the reference's 3 / 2 (a stereo
        # observation counts twice, MapPoint.cc:105-108) become 2 / 1
        min_obs = 2 if self.n_kf_host > 2 else 1
        m = self.map
        ref_lm = m.kf_lm[self.ref_kf]
        safe = ref_lm.clamp(min=0).long()
        has = (ref_lm >= 0) & m.kf_feat_valid[self.ref_kf]
        nobs = (m.lm_obs_kf[safe] >= 0).sum(1)
        ref_matches = int((has & (nobs >= min_obs) & m.lm_valid[safe]).sum())
        # close points (Tracking.cc:1170-1193)
        d = obs.depth.cpu().numpy()
        lm = obs.lm.cpu().numpy()
        close = (d > 0) & (d < cfg.depth_threshold)
        tracked_close = int(np.sum(close & (lm >= 0)))
        non_tracked_close = int(np.sum(close & (lm < 0)))
        need_close = tracked_close < 100 and non_tracked_close > 70
        n_in = self._n_inliers
        if (self.frame_count - 1 < self.last_reloc_frame + cfg.fps
                and self.n_kf_host > cfg.fps):
            return False
        # thRefRatio 0.75 (0.9 monocular), 0.4 with one keyframe
        # (Tracking.cc:1205-1210)
        if cfg.sensor == "mono":
            need_close = False
            th_ref = 0.9
        else:
            th_ref = 0.4 if self.n_kf_host < 2 else 0.75
        c1a = frames_since >= cfg.fps
        c1b = frames_since >= 3  # the mapping thread's duty cycle
        c1c = n_in < ref_matches * 0.25 or need_close
        c2 = (n_in < ref_matches * th_ref or need_close) and n_in > 15
        if self.n_kf_host >= self.map.kf_R.shape[0]:
            return False
        return (c1a or c1b or c1c) and c2

    def _create_keyframe(self, obs, R, t, frame_id):
        kf = self.n_kf_host
        if kf >= self.map.kf_R.shape[0]:
            # full: refuse rather than write past the last slot
            self._maintenance_due = True
            return
        cfg = self.cfg
        if cfg.sensor == "mono":
            self.map = steps.keyframe_step_mono(
                self.map, self.cam, obs, R, t, frame_id, cfg.width,
                cfg.height)
        else:
            self.map = steps.keyframe_step(
                self.map, self.cam, obs, R, t, frame_id,
                float(np.float32(cfg.depth_threshold)), cfg.width,
                cfg.height)
        self.n_kf_host += 1
        self.kf_uids.append(self._kf_uid_counter)
        self._kf_uid_counter += 1
        self.ref_kf = kf
        self.last_kf_frame = frame_id
        self.last_obs = obs._replace(lm=self.map.kf_lm[kf])
        # the map counters, copied without blocking: they drive the
        # compaction and growth decisions
        self._counter_fut = Readback(_map_counters(self.map))
        if self.db is not None:
            self.db.add(kf, obs.feats.desc, obs.feats.valid)
            # loop detection: device work queued now, the host gating on
            # the next frame
            self._finish_pending_loop()
            self._pending_loop = self.loop_closer.begin(self.map, kf)

    # -- relocalization ---------------------------------------------------
    def _reloc_project_round(self, obs, c, frame_lm, R, t, th, desc_th):
        """One escalation round (Tracking.cc:1716-1752): the candidate
        keyframe's landmarks projected at the current estimate (radius th,
        descriptor gate desc_th), the new matches added, the pose
        re-optimized."""
        m, cfg = self.map, self.cfg
        kf_lm = m.kf_lm[c]
        safe_lm = kf_lm.clamp(min=0).long()
        has = (kf_lm >= 0) & m.kf_feat_valid[c] & m.lm_valid[safe_lm]
        L = m.lm_pw.shape[0]
        already = torch.zeros(L, dtype=I32, device=self.device).index_add(
            0, frame_lm.clamp(min=0).long(), (frame_lm >= 0).to(I32)) > 0
        has = has & ~already[safe_lm]
        lmset = msearch.LandmarkSet(m.lm_pw[safe_lm], m.lm_normal[safe_lm],
                                    m.lm_dmin[safe_lm], m.lm_dmax[safe_lm],
                                    m.lm_desc[safe_lm], has)
        fr = msearch.frustum_check(self.cam, R, t, lmset, cfg.width,
                                   cfg.height)
        idx, _, matched = msearch.search_local_points(
            self.cam, R, t, lmset, fr, obs.feats, th=th,
            already_matched=frame_lm >= 0, desc_th=desc_th)
        frame_lm = steps._assign(frame_lm, matched, idx, safe_lm.to(I32))
        tr = steps.pose_optimize_one(self.cam, m, obs.feats, frame_lm, R, t)
        return tr, frame_lm

    def _relocalize(self, obs: steps.FrameObs, frame_id) -> bool:
        """Relocalization (Tracking.cc:1582-1778): BoW candidates,
        descriptor matching, EPnP RANSAC, pose-only optimization, then
        projection rounds of growing strictness (th=10 / ORBdist 100, then
        th=3 / 64) until 50 inliers, over the candidates in turn."""
        from ..solvers import pnp
        cands = self.db.detect_reloc_candidates(
            self.map, obs.feats.desc, obs.feats.valid, max_candidates=5)
        m, cam = self.map, self.cam
        K = (cam.fx, cam.fy, cam.cx, cam.cy)
        N = obs.feats.xy.shape[0]
        for c in cands:
            kf_lm = m.kf_lm[c]
            kf_has = ((kf_lm >= 0) & m.kf_feat_valid[c]
                      & m.lm_valid[kf_lm.clamp(min=0).long()])
            idx, _, matched = msearch.search_brute(
                m.kf_desc[c], obs.feats.desc, kf_has, obs.feats.valid,
                ratio=0.75, angle_q=m.kf_angle[c], angle_t=obs.feats.angle)
            if int(matched.sum()) < 15:  # :1625
                continue
            frame_lm = set_last(self._new_lm(N), torch.where(matched, idx, 0),
                                torch.where(matched, kf_lm, -1))
            has = (frame_lm >= 0) & obs.feats.valid
            res = pnp.solve_ransac(
                self.gen, K, m.lm_pw[frame_lm.clamp(min=0).long()],
                obs.feats.xy, msearch.sigma2_at(obs.feats.octave), has,
                max_iters=300)
            if int(res.n_inliers) < 10:
                continue
            tr = steps.pose_optimize_one(cam, m, obs.feats, frame_lm, res.R,
                                         res.t)
            n_good = int(tr.n_inliers)
            if n_good < 10:
                continue
            if n_good < 50:
                tr, frame_lm = self._reloc_project_round(
                    obs, c, tr.lm, tr.R, tr.t, th=10.0, desc_th=100)
                n_good = int(tr.n_inliers)
                if 30 <= n_good < 50:
                    tr, frame_lm = self._reloc_project_round(
                        obs, c, tr.lm, tr.R, tr.t, th=3.0, desc_th=64)
                    n_good = int(tr.n_inliers)
            if n_good < 50:  # accepted at >= 50 (:1752)
                continue
            self.last_R, self.last_t = tr.R, tr.t
            self.last_obs = obs._replace(lm=tr.lm)
            self.ref_kf = c
            self.velocity = None
            self.state = TrackState.OK
            self._n_inliers = n_good
            self.last_reloc_frame = frame_id
            self._log_pose(frame_id, tr.R, tr.t)
            return True
        return False

    # -- export -------------------------------------------------------------
    def trajectory_arrays(self):
        """(frame ids, R [F, 3, 3], t [F, 3]) of every tracked frame."""
        self.flush()
        ids = np.array([f for f, _, _ in self.trajectory])
        Rs = torch.stack([R for _, R, _ in self.trajectory]).cpu().numpy()
        ts = torch.stack([t for _, _, t in self.trajectory]).cpu().numpy()
        return ids, Rs, ts
