"""The map lifecycle of the host Tracker in the PyTorch port against the
JAX package's, on the CPU: grow_map, and a tiny-capacity RGB-D run at
320x240 (500 features, fps 10, MapConfig(8, 500, 2000, 8), the 30-frame
orbit, pipeline_depth = 0 on both sides) in which landmark compaction
fires at frame 16 and the keyframe capacity doubles at frame 19.

The JAX tracker reads its map counters on a thread: the test waits for
that read after each insert, so both trackers see the counters at the
next frame (the port's read has landed by then on the CPU). Tolerances:

- grow_map of a converted map: every table exact against the JAX one;
  shrinking raises;
- the run: the maintenance passes at the same frames with the same
  capacities and counters before and after, the same frames tracked and
  keyframe uids, every logged pose within 1e-3 m and 1e-3 in rotation
  entries (measured 7.3e-4 and 3.2e-4 at frame 3, the borderline inlier of
  tests/test_torch_tracker.py's run; the same first frames), ATE under
  0.05 m (tests/test_lifecycle.py's gate), and every rel_log row resolving
  through the uid archive.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_with_comment_tpu.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu.mapstate import map as jmap
from orb_slam2_with_comment_tpu.pipeline import (
    Tracker as JaxTracker, TrackerConfig as JaxTrackerConfig)
from orb_slam2_with_comment_tpu_torch import convert
from orb_slam2_with_comment_tpu_torch.evaluation.ate import (
    ate_rmse, camera_centers)
from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig, grow_map
from orb_slam2_with_comment_tpu_torch.pipeline import Tracker, TrackerConfig
from orb_slam2_with_comment_tpu_torch.system import System

torch.set_num_threads(2)

CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
KW = dict(CAM, bf=20.0, n_features=500, min_init_features=100, fps=10,
          depth_factor=1.0 / 5000.0)
MAP = dict(k_max=8, n_feat=500, l_max=2000, d_max=8)
N = 30


def _watch(tracker, log):
    """Record each maintenance pass: (frame, (K, L, n_lm, n_kf_host)
    before, the same after)."""
    run = tracker._run_maintenance

    def counters():
        m = tracker.map
        return (m.kf_R.shape[0], m.lm_pw.shape[0], int(m.n_lm),
                tracker.n_kf_host)

    def watched():
        before = counters()
        run()
        log.append((tracker.frame_count - 1, before, counters()))

    tracker._run_maintenance = watched


@pytest.fixture(scope="module")
def runs():
    world = SyntheticWorld(seed=1)
    poses = orbit_trajectory(N)
    frames = []
    for R, t in poses:
        img, depth = world.render(R, t, **CAM)
        frames.append((np.clip(img, 0, 255).astype(np.uint8),
                       np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)))
    out = {}
    for name in ("jax", "port"):
        if name == "jax":
            tr = JaxTracker(JaxTrackerConfig(map_cfg=jmap.MapConfig(**MAP),
                                             **KW))
            create = tr._create_keyframe

            def synced(*a, tr=tr, create=create):
                create(*a)
                if tr._counter_fut is not None:
                    tr._counter_fut.result()

            tr._create_keyframe = synced
        else:
            tr = Tracker(TrackerConfig(map_cfg=MapConfig(**MAP), **KW),
                         device="cpu")
        tr.pipeline_depth = 0
        log = []
        _watch(tr, log)
        got = [tr.process_rgbd(img, depth, frame_id=k) is not None
               for k, (img, depth) in enumerate(frames)]
        tr.flush()
        out[name] = (tr, log, got)
    return out, poses


def test_grow_map_exact(runs):
    jt = runs[0]["jax"][0]
    jm = jax.device_get(jt.map)
    m = convert.map_from_numpy(jm, "cpu")
    K, L = m.kf_R.shape[0], m.lm_pw.shape[0]
    want = jax.device_get(jmap.grow_map(jax.tree_util.tree_map(
        jnp.asarray, jm), k_max=2 * K, l_max=2 * L + 8))
    got = convert.map_to_numpy(grow_map(m, k_max=2 * K, l_max=2 * L + 8))
    for f in got:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert grow_map(m) is m
    with pytest.raises(ValueError):
        grow_map(m, k_max=K - 1)


def test_maintenance_fires_at_the_same_frames(runs):
    out, _ = runs
    (jt, jlog, jgot), (tt, tlog, tgot) = out["jax"], out["port"]
    assert tlog == jlog
    assert any(b[2] > a[2] for _, b, a in jlog), "no landmark compaction"
    assert any(a[0] > b[0] for _, b, a in jlog), "no keyframe growth"
    assert tgot == jgot == [True] * N
    assert tt.kf_uids == jt.kf_uids


def test_run_matches_jax_and_resolves(runs):
    out, poses = runs
    jt, tt = out["jax"][0], out["port"][0]
    ji, jR, jt_ = jt.trajectory_arrays()
    ti, tR, tt_ = tt.trajectory_arrays()
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tt_, jt_, atol=1e-3)
    np.testing.assert_allclose(tR, jR, atol=1e-3)
    gt = camera_centers(np.stack([poses[i][0] for i in ti]),
                        np.stack([poses[i][1] for i in ti]))
    assert ate_rmse(camera_centers(tR, tt_), gt) < 0.05
    slam = System.__new__(System)
    slam.tracker = tt
    assert len(slam._chain_poses()) == len(tt.rel_log) == N
