"""The RGB-D tracking slice of the PyTorch port against the JAX package's
AutoTracker (loop_closing=False), at a reduced size: 320x240, 500 features,
MapConfig(k_max=8, n_feat=500, l_max=3000, d_max=8), 16-frame orbit.

- Whole run: the keyframe-insertion frames, valid flags, loss and keyframe
  count are identical (taken from the JAX run, not hard-coded); every
  frame's translation agrees within 1e-3 m and rotation within 1e-3 rad
  (float32 sums in another order through 16 frames of tracking and local
  BA; measured <= 3.4e-5 m).
- One step from a shared state, for each of the six maintenance phases:
  the JAX state before that frame is converted with convert.py, both sides
  take the same frame, and the map tables after the step agree: integer
  tables exactly, keyframe poses within 1e-4, landmark positions within
  1e-3 (after local BA) and the other float tables within 1e-4.
"""
import numpy as np
import jax
import pytest
import torch

from orb_slam2_with_comment_tpu.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu.mapstate.map import MapConfig as JaxMapConfig
from orb_slam2_with_comment_tpu.pipeline import (
    AutoTracker as JaxAutoTracker, AutoTrackerConfig as JaxAutoTrackerConfig,
    TrackerConfig as JaxTrackerConfig)
from orb_slam2_with_comment_tpu_torch import convert
from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig
from orb_slam2_with_comment_tpu_torch.pipeline.auto import (
    AutoTracker, AutoTrackerConfig)
from orb_slam2_with_comment_tpu_torch.pipeline.tracking import TrackerConfig

torch.set_num_threads(2)

N_FRAMES = 16
CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
KW = dict(CAM, bf=20.0, n_features=500, min_init_features=100, fps=30,
          depth_factor=1.0 / 5000.0)
MAP = dict(k_max=8, n_feat=500, l_max=3000, d_max=8)
INT_TABLES = ("kf_valid", "kf_frame_id", "kf_octave", "kf_desc",
              "kf_feat_valid", "kf_lm", "lm_valid", "lm_desc", "lm_visible",
              "lm_found", "lm_first_kf", "lm_ref_kf", "lm_obs_kf",
              "lm_obs_feat", "n_kf", "n_lm", "n_obs_drop")
FLOAT_TOL = {"kf_R": 1e-4, "kf_t": 1e-4, "lm_pw": 1e-3, "lm_normal": 1e-4,
             "lm_dmin": 1e-4, "lm_dmax": 1e-4}


def _frames():
    world = SyntheticWorld(seed=1)
    out = []
    for R, t in orbit_trajectory(N_FRAMES):
        img, depth = world.render(R, t, **CAM)
        out.append((np.clip(img, 0, 255).astype(np.uint8),
                    np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)))
    return out


def _torch_tracker():
    return AutoTracker(TrackerConfig(map_cfg=MapConfig(**MAP), **KW),
                       AutoTrackerConfig(loop_closing=False), device="cpu")


@pytest.fixture(scope="module")
def runs():
    frames = _frames()
    jt = JaxAutoTracker(JaxTrackerConfig(map_cfg=JaxMapConfig(**MAP), **KW),
                        JaxAutoTrackerConfig(loop_closing=False))
    snaps = []  # JAX state before each frame, then after the last
    for img, depth in frames:
        snaps.append(jax.device_get(jt.state))
        jt.process_rgbd(img, depth)
    snaps.append(jax.device_get(jt.state))
    tt = _torch_tracker()
    for img, depth in frames:
        tt.process_rgbd(img, depth)
    return frames, snaps, jt.finalize(), tt


def test_whole_slice_matches_jax(runs):
    _, _, jout, tt = runs
    tout = tt.finalize()
    ins_j = np.nonzero(jout["stats"][:, 6])[0]
    np.testing.assert_array_equal(np.nonzero(tout["stats"][:, 6])[0], ins_j)
    assert len(ins_j) >= 3
    np.testing.assert_array_equal(tout["valid"], jout["valid"])
    assert tout["valid"].all()
    assert tout["lost_at"] == jout["lost_at"] == -1
    assert tout["initialized"] and tout["n_keyframes"] == jout["n_keyframes"]
    np.testing.assert_array_equal(tout["stats"], jout["stats"])
    np.testing.assert_allclose(tout["t"], jout["t"], rtol=0, atol=1e-3)
    for Rt, Rj in zip(tout["R"], jout["R"]):
        cos = (np.trace(Rt @ Rj.T) - 1) / 2
        assert np.arccos(np.clip(cos, -1, 1)) < 1e-3
    lines = tt.trajectory_tum()
    assert len(lines) == int(tout["valid"].sum())
    q = np.array([[float(v) for v in ln.split()[4:]] for ln in lines])
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("phase", range(6), ids=[
    "fuse_in", "fuse_out", "merge", "refresh_cull", "ba1", "ba2"])
def test_step_from_shared_state(runs, phase):
    frames, snaps, _, _ = runs
    k = next(i for i in range(N_FRAMES)
             if int(snaps[i].maint_kf) >= 0
             and int(snaps[i].maint_phase) == phase
             and snaps[i + 1].traj_stats[i, 6] == 0)
    tt = _torch_tracker()
    tt.state = convert.auto_state_from_numpy(snaps[k], "cpu")
    tt.frame_count = k
    tt.process_rgbd(*frames[k])
    got = convert.auto_state_to_numpy(tt.state)
    want = snaps[k + 1]
    for f in ("maint_kf", "maint_phase", "maint_neighbors", "ref_kf",
              "frame_idx"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)))
    np.testing.assert_allclose(got["traj_t"][k], want.traj_t[k], atol=1e-4)
    for f in INT_TABLES:
        np.testing.assert_array_equal(got["map"][f],
                                      np.asarray(getattr(want.map, f)),
                                      err_msg=f)
    for f, tol in FLOAT_TOL.items():
        np.testing.assert_allclose(got["map"][f],
                                   np.asarray(getattr(want.map, f)),
                                   rtol=0, atol=tol, err_msg=f)


def test_float_metre_depth_matches_jax():
    """Depth in float32 metres with depth_factor 1.0 (what the RGB-D
    drivers feed) initializes the same map as the raw uint16 depth at
    1/5000: the same landmark count as the JAX package given the same
    metres, and a median landmark depth within 1e-4 m of the uint16 run."""
    R, t = orbit_trajectory(N_FRAMES)[0]
    img, depth = SyntheticWorld(seed=1).render(R, t, **CAM)
    img = np.clip(img, 0, 255).astype(np.uint8)
    d16 = np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)
    metres = d16.astype(np.float32) / np.float32(5000.0)
    kw = dict(KW, depth_factor=1.0)

    def port(depth, **cfg):
        tr = AutoTracker(TrackerConfig(map_cfg=MapConfig(**MAP), **cfg),
                         AutoTrackerConfig(loop_closing=False), device="cpu")
        tr.process_rgbd(img, depth)
        m = tr.state.map
        return int(m.n_lm), m.lm_pw[m.lm_valid].numpy()

    jt = JaxAutoTracker(JaxTrackerConfig(map_cfg=JaxMapConfig(**MAP), **kw),
                        JaxAutoTrackerConfig(loop_closing=False))
    jt.process_rgbd(img, metres)
    jm = jax.device_get(jt.state.map)
    n_raw, pw_raw = port(d16, **KW)
    n_f, pw_f = port(metres, **kw)
    assert n_f == int(jm.n_lm) == n_raw and n_f > 100
    want = np.median(pw_raw[:, 2])
    assert abs(np.median(pw_f[:, 2]) - want) <= 1e-4
    assert abs(np.median(jm.lm_pw[jm.lm_valid][:, 2]) - want) <= 1e-4
