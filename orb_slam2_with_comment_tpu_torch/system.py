"""System façade: construction, per-frame entry points, mode switches,
reset, shutdown and trajectory export (port of system.py).

The reference's System class (System.cc:38-506, System.h:62-123) spawns
the LocalMapping, LoopClosing and Viewer threads; here construction
configures the host-driven Tracker on ``device`` and shutdown finalizes
the frames in flight. Trajectory export keeps the reference's relative
chain (System.cc:336-394): each frame stores Tcr against its reference
keyframe, and the saved pose is Tcr * Trw with the keyframe's pose at save
time, so loop-closure and global-BA corrections reach saved trajectories.
"""
from __future__ import annotations

import enum

import numpy as np
import torch

from .geometry import se3
from .pipeline.tracking import Tracker, TrackerConfig, TrackState


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


_SENSOR_NAME = {Sensor.MONOCULAR: "mono", Sensor.STEREO: "stereo",
                Sensor.RGBD: "rgbd"}


class LazyPose:
    """4x4 Tcw (world->camera) of device tensors, copied to the host on
    first access: handing out the pose does not wait for the device. The
    pose of a frame still in flight may later turn out LOST. Acts like an
    ndarray (``np.asarray(pose)``, ``pose[...]``)."""
    __slots__ = ("_R", "_t", "_T")

    def __init__(self, R, t):
        self._R, self._t = R, t
        self._T = None

    def _mat(self) -> np.ndarray:
        if self._T is None:
            T = np.eye(4, dtype=np.float64)
            T[:3, :3] = self._R.cpu().numpy()
            T[:3, 3] = self._t.cpu().numpy()
            self._T = T
        return self._T

    def matrix(self) -> np.ndarray:
        return self._mat()

    def __array__(self, dtype=None, copy=None):
        m = self._mat()
        return m.astype(dtype) if dtype is not None else m

    def __getitem__(self, key):
        return self._mat()[key]

    @property
    def shape(self):
        return (4, 4)

    def __repr__(self):
        return (f"LazyPose({self._mat()!r})" if self._T is not None
                else "LazyPose(<on device>)")


class System:
    """The user-facing façade (System.h:62-123): the reference's
    constructor less the vocabulary file (the packaged vocabulary loads by
    itself)."""

    def __init__(self, config: TrackerConfig | None = None,
                 sensor: Sensor = Sensor.RGBD, settings_path: str | None = None,
                 use_viewer: bool = False, viewer_port: int = 8765,
                 expected_frames: int | None = None, device="cuda"):
        if use_viewer:
            raise NotImplementedError("the viewer is not ported yet")
        if config is None and settings_path is not None:
            from .dataio.settings import load_tracker_config
            config = load_tracker_config(settings_path,
                                         expected_frames=expected_frames,
                                         sensor=_SENSOR_NAME[sensor])
        if config is None:
            config = TrackerConfig()
        config.sensor = _SENSOR_NAME[sensor]
        self.sensor = sensor
        self.config = config
        self.device = torch.device(device)
        self.tracker = Tracker(config, device=self.device)
        self._localization_mode = False
        self._shutdown = False
        self._big_change_idx = 0
        self.viewer = None
        self.viewer_port = viewer_port

    # -- per-frame entries (System.cc:123-313) ------------------------------
    def track_monocular(self, img, timestamp: float = 0.0):
        """System::TrackMonocular (System.cc:224-282): 4x4 Tcw, or None
        when tracking failed."""
        assert self.sensor == Sensor.MONOCULAR, "wrong sensor for TrackMonocular"
        self.tracker._timestamp = timestamp
        return self._pose44(self.tracker.process_mono(img))

    def track_stereo(self, img_left, img_right, timestamp: float = 0.0):
        """System::TrackStereo (System.cc:123-180)."""
        assert self.sensor == Sensor.STEREO, "wrong sensor for TrackStereo"
        self.tracker._timestamp = timestamp
        return self._pose44(self.tracker.process_stereo(img_left, img_right))

    def track_rgbd(self, img, depth, timestamp: float = 0.0):
        """System::TrackRGBD (System.cc:182-222)."""
        assert self.sensor == Sensor.RGBD, "wrong sensor for TrackRGBD"
        self.tracker._timestamp = timestamp
        return self._pose44(self.tracker.process_rgbd(img, depth))

    @staticmethod
    def _pose44(out):
        return None if out is None else LazyPose(out[0], out[1])

    # -- modes (System.cc:284-307) --------------------------------------------
    def activate_localization_mode(self):
        """Tracking only: the map frozen, no keyframes inserted."""
        self._localization_mode = True
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self._localization_mode = False
        self.tracker.localization_only = False

    def map_changed(self) -> bool:
        """Whether the map changed a lot since the last call
        (System::MapChanged, System.cc:309-320)."""
        idx = self.tracker.n_kf_host
        if self.tracker.loop_closer is not None:
            idx += 1000 * self.tracker.loop_closer.n_loops_closed
        changed = idx != self._big_change_idx
        self._big_change_idx = idx
        return changed

    def reset(self):
        """Clear the map and restart tracking (System::Reset ->
        Tracking::Reset, Tracking.cc:1780-1826)."""
        self.tracker = Tracker(self.config, device=self.device)

    def shutdown(self):
        """System::Shutdown (System.cc:315-334): nothing to join; the frames
        in flight are finalized."""
        self.tracker.flush()
        self._shutdown = True

    # -- state (System.h:137-146) -----------------------------------------
    def get_tracking_state(self) -> TrackState:
        return self.tracker.state

    def get_tracked_map_points(self) -> int:
        return self.tracker._n_inliers

    # -- trajectory export (System.cc:336-486) ------------------------------
    def _chain_poses(self, keyframes_only: bool = False):
        """The relative chain resolved to absolute Tcw per frame: a uid
        living in a slot takes the map's current pose, an evicted one its
        archived pose relative to its anchor (the reference walks the
        spanning tree to a live parent, System.cc:376-382)."""
        tr = self.tracker
        tr.flush()
        m = tr.map
        kf_R = m.kf_R.cpu().numpy()
        kf_t = m.kf_t.cpu().numpy()
        rows = []
        if keyframes_only:
            n = tr.n_kf_host
            frame_ids = m.kf_frame_id[:n].cpu().numpy()
            ts_by_frame = {fid: ts for fid, ts, *_ in tr.rel_log}
            for k in range(n):
                ts = ts_by_frame.get(int(frame_ids[k]), float(frame_ids[k]))
                rows.append((ts, kf_R[k], kf_t[k]))
            return rows
        slot_of_uid = {uid: slot for slot, uid in enumerate(tr.kf_uids)}

        def resolve(uid, depth=0):
            slot = slot_of_uid.get(uid)
            if slot is not None:
                return kf_R[slot], kf_t[slot]
            entry = tr.kf_archive.get(uid)
            if entry is None or depth > len(tr.kf_archive):
                return None
            anchor_uid, R_rel, t_rel = entry
            if anchor_uid < 0:  # an absolute entry
                return R_rel, t_rel
            base = resolve(anchor_uid, depth + 1)
            if base is None:
                return None
            Ra, ta = base
            return R_rel @ Ra, R_rel @ ta + t_rel

        for frame_id, ts, ref_uid, Rcr, tcr in tr.rel_log:
            Rcr, tcr = _np(Rcr), _np(tcr)
            base = resolve(ref_uid)
            if base is None:  # logged before a compaction, never archived
                continue
            Rr, tr_ = base
            rows.append((ts, Rcr @ Rr, Rcr @ tr_ + tcr))
        return rows

    @staticmethod
    def _tum_line(ts, Rcw, tcw):
        Rwc = Rcw.T
        twc = -Rwc @ tcw
        q = se3.matrix_to_quat(torch.as_tensor(
            np.ascontiguousarray(Rwc))).numpy()  # [w, x, y, z]
        return (f"{ts:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}")

    def save_trajectory_tum(self, path: str):
        """Every frame's camera, TUM format ``ts tx ty tz qx qy qz qw``
        (System::SaveTrajectoryTUM, System.cc:336-394)."""
        with open(path, "w") as f:
            for ts, Rcw, tcw in self._chain_poses():
                f.write(self._tum_line(ts, Rcw, tcw) + "\n")

    def save_keyframe_trajectory_tum(self, path: str):
        """The keyframes only (System::SaveKeyFrameTrajectoryTUM,
        System.cc:396-431)."""
        with open(path, "w") as f:
            for ts, Rcw, tcw in self._chain_poses(keyframes_only=True):
                f.write(self._tum_line(ts, Rcw, tcw) + "\n")

    def save_trajectory_kitti(self, path: str):
        """Every frame's camera-to-world 3x4, row-major
        (System::SaveTrajectoryKITTI, System.cc:433-486)."""
        with open(path, "w") as f:
            for ts, Rcw, tcw in self._chain_poses():
                Rwc = Rcw.T
                twc = -Rwc @ tcw
                vals = [Rwc[0, 0], Rwc[0, 1], Rwc[0, 2], twc[0],
                        Rwc[1, 0], Rwc[1, 1], Rwc[1, 2], twc[1],
                        Rwc[2, 0], Rwc[2, 1], Rwc[2, 2], twc[2]]
                f.write(" ".join(f"{v:.9e}" for v in vals) + "\n")


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
