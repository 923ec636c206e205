"""The host-driven Tracker of the PyTorch port against the JAX package's,
on the CPU, at a reduced size: 320x240, 500 features, bf 20,
MapConfig(16, 500, 4000, 8), depth as uint16 at 5000 per metre.

One RGB-D run per package, pipeline_depth = 0 on both sides (every frame
decided at once): the 30-frame orbit, 3 black frames, frames 2-4 again
(a kidnap), then frames 5-7 in localization mode. The relocalization's
EPnP RANSAC takes the JAX package's own 4-point sets (PRNGKey of the frame
count) in the port. Tolerances:

- the frames that return a pose, the keyframe frames, the keyframe uids,
  the relocalization frame and the keyframe count: identical;
- every logged pose within 1e-3 m and 1e-3 in rotation entries (measured
  7.3e-4 m and 3.2e-4, both at frame 3, where one observation of the
  motion-model solve sits on the chi2 gate and the two packages count 121
  and 120 inliers; the frames before agree to 3e-6 and the keyframe at
  frame 4 pulls the next ones back within 7e-5); the relocalized pose
  within 1e-3 m (measured 3.4e-6);
- track_motion_model and track_reference_keyframe from the JAX run's state
  at frame 10: the match indices per feature identical, the pose within
  1e-4 (measured 2.6e-6 and 4.9e-7).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jax_draws import jax_samples
from orb_slam2_with_comment_tpu.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu.mapstate.map import MapConfig as JaxMapConfig
from orb_slam2_with_comment_tpu.pipeline import (
    Tracker as JaxTracker, TrackerConfig as JaxTrackerConfig)
from orb_slam2_with_comment_tpu.pipeline import steps as jsteps
from orb_slam2_with_comment_tpu_torch import convert
from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig
from orb_slam2_with_comment_tpu_torch.pipeline import (
    Tracker, TrackerConfig, TrackState, steps)

torch.set_num_threads(2)

CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
KW = dict(CAM, bf=20.0, n_features=500, min_init_features=100, fps=30,
          depth_factor=1.0 / 5000.0)
MAP = dict(k_max=16, n_feat=500, l_max=4000, d_max=8)
N_ORBIT, SNAP = 30, 10
REVISIT = N_ORBIT + 3  # the first frame after the black ones
N_LOC = 3  # frames tracked in localization mode at the end


def _frames():
    world = SyntheticWorld(seed=1)
    out = []
    for R, t in orbit_trajectory(N_ORBIT):
        img, depth = world.render(R, t, **CAM)
        out.append((np.clip(img, 0, 255).astype(np.uint8),
                    np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)))
    black = (np.zeros((240, 320), np.uint8), np.zeros((240, 320), np.uint16))
    return out + [black] * 3 + out[2:5] + out[5:5 + N_LOC]


def _drive(tracker, frames):
    """The run: None pattern and keyframe count after each frame; the
    last N_LOC frames in localization mode."""
    got, n_kf = [], []
    for i, (img, depth) in enumerate(frames):
        tracker.localization_only = i >= len(frames) - N_LOC
        got.append(tracker.process_rgbd(img, depth) is not None)
        n_kf.append(tracker.n_kf_host)
    tracker.flush()
    return got, n_kf


@pytest.fixture(scope="module")
def runs():
    frames = _frames()
    jt = JaxTracker(JaxTrackerConfig(map_cfg=JaxMapConfig(**MAP), **KW))
    jt.pipeline_depth = 0
    for img, depth in frames[:SNAP]:
        jt.process_rgbd(img, depth)
    snap = dict(map=jax.device_get(jt.map), obs=jax.device_get(jt.last_obs),
                R=np.asarray(jt.last_R), t=np.asarray(jt.last_t),
                vel=tuple(np.asarray(v) for v in jt.velocity),
                ref_kf=jt.ref_kf,
                next_obs=jax.device_get(jt._frame_obs(*frames[SNAP])))
    jt = JaxTracker(JaxTrackerConfig(map_cfg=JaxMapConfig(**MAP), **KW))
    jt.pipeline_depth = 0
    jout = _drive(jt, frames)
    tt = Tracker(TrackerConfig(map_cfg=MapConfig(**MAP), **KW), device="cpu")
    tt.pipeline_depth = 0
    with jax_samples(quad_key=lambda: jax.random.PRNGKey(tt.frame_count)):
        tout = _drive(tt, frames)
    return snap, jt, jout, tt, tout


def test_rgbd_run_matches_jax(runs):
    _, jt, (jgot, jn), tt, (tgot, tn) = runs
    assert tgot == jgot and tn == jn
    assert jgot[:N_ORBIT] == [True] * N_ORBIT
    assert tt.kf_uids == jt.kf_uids and tt.n_kf_host == jt.n_kf_host > 5
    np.testing.assert_array_equal(tt.map.kf_frame_id.numpy(),
                                  np.asarray(jt.map.kf_frame_id))
    assert [r[:3] for r in tt.rel_log] == [r[:3] for r in jt.rel_log]
    ji, jR, jt_ = jt.trajectory_arrays()
    ti, tR, tt_ = tt.trajectory_arrays()
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tt_, jt_, atol=1e-3)
    np.testing.assert_allclose(tR, jR, atol=1e-3)


def test_kidnap_relocalizes_at_the_same_frame(runs):
    _, jt, (jgot, _), tt, (tgot, _) = runs
    assert jt.last_reloc_frame == tt.last_reloc_frame == REVISIT
    assert jgot[N_ORBIT:REVISIT] == [False] * 3 == tgot[N_ORBIT:REVISIT]
    j = [i for i, r in enumerate(jt.rel_log) if r[0] == REVISIT][0]
    np.testing.assert_allclose(tt.rel_log[j][4].numpy(),
                               np.asarray(jt.rel_log[j][4]), atol=1e-3)
    ji, _, jt_ = jt.trajectory_arrays()
    ti, _, tt_ = tt.trajectory_arrays()
    k = int(np.nonzero(ji == REVISIT)[0][0])
    np.testing.assert_allclose(tt_[k], jt_[k], atol=1e-3)
    assert tt.state == TrackState.OK


def test_localization_only_inserts_no_keyframe(runs):
    _, _, (jgot, jn), _, (tgot, tn) = runs
    assert tgot[-N_LOC:] == [True] * N_LOC == jgot[-N_LOC:]
    assert len(set(tn[-N_LOC - 1:])) == 1 and tn[-N_LOC - 1:] == \
        jn[-N_LOC - 1:]


def _converted(snap):
    m = convert.map_from_numpy(snap["map"], "cpu")
    prev = convert._prev_from_numpy(snap["obs"], "cpu")
    nxt = convert._prev_from_numpy(snap["next_obs"], "cpu")
    return m, prev, nxt


@pytest.mark.parametrize("which", ["motion_model", "reference_keyframe"])
def test_track_steps_match_jax(runs, which):
    snap = runs[0]
    cam = JaxTrackerConfig(**KW).cam
    tcam = TrackerConfig(**KW).cam
    m, prev, nxt = _converted(snap)
    R, t = (torch.as_tensor(snap[k]) for k in ("R", "t"))
    jm = jax.tree_util.tree_map(jnp.asarray, snap["map"])
    jobs = jax.tree_util.tree_map(jnp.asarray, snap["obs"])
    jnext = jax.tree_util.tree_map(jnp.asarray, snap["next_obs"])
    if which == "motion_model":
        vR, vt = snap["vel"]
        Rp = vR @ snap["R"]
        tp = vR @ snap["t"] + vt
        want = jsteps.track_motion_model(
            cam, jm, jobs, jnp.asarray(snap["R"]), jnp.asarray(snap["t"]),
            jnext.feats, jnp.asarray(Rp), jnp.asarray(tp), jnp.float32(7.0),
            jnp.float32(320.0), jnp.float32(240.0), jnp.int32(100))
        got = steps.track_motion_model(
            tcam, m, prev, R, t, nxt.feats, torch.as_tensor(Rp),
            torch.as_tensor(tp), 7.0, 320.0, 240.0, 100)
    else:
        want = jsteps.track_reference_keyframe(
            cam, jm, jnp.int32(snap["ref_kf"]), jnext.feats,
            jnp.asarray(snap["R"]), jnp.asarray(snap["t"]))
        got = steps.track_reference_keyframe(tcam, m, snap["ref_kf"],
                                             nxt.feats, R, t)
    np.testing.assert_array_equal(got.lm.numpy(), np.asarray(want.lm))
    assert int(got.n_inliers) == int(want.n_inliers) > 50
    assert int(got.n_matches) == int(want.n_matches)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)


def test_tracker_defaults_to_the_card_and_never_falls_back():
    cfg = TrackerConfig(map_cfg=MapConfig(**MAP), **KW)
    import inspect
    assert inspect.signature(Tracker).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert Tracker(cfg).map.kf_R.is_cuda
        return
    with pytest.raises(RuntimeError):
        Tracker(cfg)
    with pytest.raises(RuntimeError):
        Tracker(cfg, device="cuda")
