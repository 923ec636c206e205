"""The host Tracker's stereo and monocular paths in the PyTorch port
against the JAX package's, on the CPU, at 320x240.

- Stereo: tests/test_torch_stereo.py's camera and pairs (500 features,
  bf 20, MapConfig(16, 500, 4000, 8)), 10 frames through process_stereo:
  the same frames tracked, the same keyframe frames and uids, poses within
  1e-3 m and 1e-3 in rotation entries (measured 6.5e-5 and 2.6e-5).
- Monocular: tests/test_torch_mono.py's configuration (1200 features,
  min_init_matches 50, MapConfig(16, 1200, 6000, 8), fps 10) on the first
  8 frames of its orbit, the initializer fed the JAX package's own 8-point
  sets (PRNGKey(0) at every try, as the JAX tracker draws them): the same
  bootstrap frame, the same two-view landmark count and keyframe
  decisions, the bootstrap keyframe's pose within 1e-3 (measured 2.5e-4)
  and every frame's pose within 2e-2 of the gauge's unit
  (test_torch_mono.py's whole-run tolerance; measured 8.9e-6).
- keyframe_step_mono, the call the monocular host tracker makes at its
  first insert, from the JAX run's map and frame: integer tables exact,
  poses within 1e-3 and live landmarks within 5e-3 + 1e-3 relative after
  its local BA (test_torch_mono.py's tolerances; measured 9.5e-6 and
  8.7e-5).
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
    Tracker, TrackerConfig, steps)

torch.set_num_threads(2)

CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
BF = 20.0
ST_KW = dict(CAM, sensor="stereo", bf=BF, n_features=500,
             min_init_features=100, fps=30)
ST_MAP = dict(k_max=16, n_feat=500, l_max=4000, d_max=8)
MO_KW = dict(CAM, sensor="mono", n_features=1200, min_init_features=150,
             min_init_matches=50, fps=10)
MO_MAP = dict(k_max=16, n_feat=1200, l_max=6000, d_max=8)
INT_TABLES = ("kf_valid", "kf_frame_id", "kf_octave", "kf_desc",
              "kf_feat_valid", "kf_lm", "lm_valid", "lm_desc", "lm_visible",
              "lm_found", "lm_first_kf", "lm_ref_kf", "lm_obs_kf",
              "lm_obs_feat", "n_kf", "n_lm", "n_obs_drop")


def _u8(img):
    return np.clip(img, 0, 255).astype(np.uint8)


def _trackers(kw, mp):
    jt = JaxTracker(JaxTrackerConfig(map_cfg=JaxMapConfig(**mp), **kw))
    tt = Tracker(TrackerConfig(map_cfg=MapConfig(**mp), **kw), device="cpu")
    return jt, tt


def _assert_same_run(jt, tt, jgot, tgot, t_tol, R_tol):
    assert tgot == jgot
    assert tt.kf_uids == jt.kf_uids and tt.n_kf_host == jt.n_kf_host
    np.testing.assert_array_equal(tt.map.kf_frame_id.numpy(),
                                  np.asarray(jt.map.kf_frame_id))
    ji, jR, jt_ = jt.trajectory_arrays()
    ti, tR, tt_ = tt.trajectory_arrays()
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tt_, jt_, atol=t_tol)
    np.testing.assert_allclose(tR, jR, atol=R_tol)


def test_stereo_run_matches_jax():
    world = SyntheticWorld(seed=1)
    pairs = []
    for R, t in orbit_trajectory(10):
        left = world.render(R, t, **CAM)[0]
        right = world.render(R, t - np.float32([BF / CAM["fx"], 0, 0]),
                             **CAM)[0]
        pairs.append((_u8(left), _u8(right)))
    jt, tt = _trackers(ST_KW, ST_MAP)
    jgot = [jt.process_stereo(*p) is not None for p in pairs]
    tgot = [tt.process_stereo(*p) is not None for p in pairs]
    assert all(jgot) and jt.n_kf_host >= 2
    _assert_same_run(jt, tt, jgot, tgot, 1e-3, 1e-3)


@pytest.fixture(scope="module")
def mono_runs():
    world = SyntheticWorld(seed=1)
    imgs = [_u8(world.render(R, t, **CAM)[0])
            for R, t in orbit_trajectory(n_frames=24, x_amp=0.5)[:8]]
    jt, tt = _trackers(MO_KW, MO_MAP)
    first = {}
    create = jt._create_keyframe

    def capture(obs, R, t, frame_id):
        if not first:  # the first insert after the bootstrap
            first.update(map=jax.device_get(jt.map),
                         obs=jax.device_get(obs), R=np.asarray(R),
                         t=np.asarray(t), frame=frame_id)
        return create(obs, R, t, frame_id)

    jt._create_keyframe = capture
    jgot = [jt.process_mono(img) is not None for img in imgs]
    with jax_samples(octet_key=lambda: jax.random.PRNGKey(0)):
        tgot = [tt.process_mono(img) is not None for img in imgs]
    return jt, tt, jgot, tgot, first


def test_mono_bootstrap_and_run_match_jax(mono_runs):
    jt, tt, jgot, tgot, _ = mono_runs
    boot = jgot.index(True)
    assert tgot.index(True) == boot
    j_log, t_log = jt.rel_log, tt.rel_log
    assert j_log[0][0] == t_log[0][0] == boot
    assert int(jt.map.kf_frame_id[1]) == int(tt.map.kf_frame_id[1]) == boot
    # the two-view landmarks: keyframe 1's matches at the bootstrap
    np.testing.assert_allclose(tt.map.kf_R[1].numpy(),
                               np.asarray(jt.map.kf_R[1]), atol=1e-3)
    _assert_same_run(jt, tt, jgot, tgot, 2e-2, 2e-2)
    assert jt.n_kf_host >= 3  # keyframe_step_mono ran in both


def test_keyframe_step_mono_from_the_host_tracker(mono_runs):
    *_, first = mono_runs
    assert first, "the JAX run inserted no keyframe after its bootstrap"
    jm, obs = first["map"], first["obs"]
    cam, tcam = JaxTrackerConfig(**MO_KW).cam, TrackerConfig(**MO_KW).cam
    want = jax.device_get(jsteps.keyframe_step_mono(
        jax.tree_util.tree_map(jnp.asarray, jm), cam,
        jax.tree_util.tree_map(jnp.asarray, obs), jnp.asarray(first["R"]),
        jnp.asarray(first["t"]), jnp.int32(first["frame"]), CAM["width"],
        CAM["height"]))
    got = convert.map_to_numpy(steps.keyframe_step_mono(
        convert.map_from_numpy(jm, "cpu"), tcam,
        convert._prev_from_numpy(obs, "cpu"), torch.tensor(first["R"]),
        torch.tensor(first["t"]), first["frame"], CAM["width"],
        CAM["height"]))
    for f in INT_TABLES:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)
    live = np.asarray(want.lm_valid)
    for f in ("kf_R", "kf_t"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(want, f)),
                                   atol=1e-3, err_msg=f)
    np.testing.assert_allclose(got["lm_pw"][live],
                               np.asarray(want.lm_pw)[live], atol=5e-3,
                               rtol=1e-3)
    assert int(want.n_kf) == 3 and int(want.n_lm) > int(jm.n_lm)
