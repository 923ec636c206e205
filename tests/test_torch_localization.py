"""Map-based localization in the port's AutoTracker against the JAX
package's, on the CPU, at a reduced size: 320x240, 500 features,
MapConfig(k_max=8, n_feat=500, l_max=1500, d_max=8), loop closing on (so
relocalization has its vocabulary).

The port maps the first 12 frames of a 48-frame orbit and saves its state
with checkpoint.save_auto_state (the JAX package's file layout). The JAX
AutoTracker(localization_only=True) and the port's load that file with
their own load_auto_state and take the same frames: the 12 mapped frames
again, 2 black frames, then frames 2-4.

- The mapped map has at most 5 keyframes, so the lost branch is the one
  that resets the map outside localization mode (the port's default
  tracker on the same state does reset, stats column 6 == 3).
- Valid flags, the per-frame decisions (stats column 6: 2 = relocalized,
  never 1 = insert or 3 = reset), the keyframe count (the mapper's) and
  the loss are identical; the statistics are identical except the inlier
  counts of the relocalization frame, which follow the RANSAC draws
  (another generator). Every frame's translation agrees within 1e-3 m and
  rotation within 1e-3 rad, test_torch_slice.py's tolerance.
"""
import numpy as np
import pytest
import torch

from orb_slam2_with_comment_tpu.checkpoint import (
    load_auto_state as jax_load_auto_state)
from orb_slam2_with_comment_tpu.mapstate.map import MapConfig as JaxMapConfig
from orb_slam2_with_comment_tpu.pipeline import (
    AutoTracker as JaxAutoTracker, AutoTrackerConfig as JaxAutoTrackerConfig,
    TrackerConfig as JaxTrackerConfig)
from orb_slam2_with_comment_tpu_torch import checkpoint
from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig
from orb_slam2_with_comment_tpu_torch.pipeline.auto import (
    AutoTracker, AutoTrackerConfig)
from orb_slam2_with_comment_tpu_torch.pipeline.tracking import TrackerConfig

torch.set_num_threads(2)

N_MAP = 12
CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
KW = dict(CAM, bf=20.0, n_features=500, min_init_features=100, fps=30,
          depth_factor=1.0 / 5000.0)
MAP = dict(k_max=8, n_feat=500, l_max=1500, d_max=8)


def _frames():
    world = SyntheticWorld(seed=1)
    poses = orbit_trajectory(48)[:N_MAP]
    frames = []
    for R, t in poses:
        img, depth = world.render(R, t, **CAM)
        frames.append((np.clip(img, 0, 255).astype(np.uint8),
                       np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)))
    return frames, poses


def _port(**kw):
    return AutoTracker(TrackerConfig(map_cfg=MapConfig(**MAP), **KW),
                       AutoTrackerConfig(**kw), device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    frames, poses = _frames()
    mapper = _port()
    for img, depth in frames:
        mapper.process_rgbd(img, depth)
    mapped = mapper.finalize()
    path = str(tmp_path_factory.mktemp("loc") / "map.npz")
    checkpoint.save_auto_state(path, mapper)
    black = (np.zeros((240, 320), np.uint8), np.zeros((240, 320), np.uint16))
    seq = frames + [black] * 2 + frames[2:5]
    jt = JaxAutoTracker(JaxTrackerConfig(map_cfg=JaxMapConfig(**MAP), **KW),
                        JaxAutoTrackerConfig(localization_only=True))
    jax_load_auto_state(path, jt)
    tt = _port(localization_only=True)
    checkpoint.load_auto_state(path, tt)
    for img, depth in seq:
        jt.process_rgbd(img, depth)
        tt.process_rgbd(img, depth)
    return path, seq, poses, mapped, jt.finalize(), tt.finalize()


def test_localization_matches_jax(runs):
    _, _, poses, mapped, jout, tout = runs
    n = mapped["n_frames"]
    assert 2 <= mapped["n_keyframes"] <= 5  # the lost branch would reset
    for k in ("n_keyframes", "lost_at", "n_frames", "n_loops_closed"):
        assert tout[k] == jout[k], k
    assert tout["n_keyframes"] == mapped["n_keyframes"]
    assert tout["lost_at"] == -1
    np.testing.assert_array_equal(tout["valid"], jout["valid"])
    np.testing.assert_array_equal(tout["stats"][:, 6], jout["stats"][:, 6])
    col6 = tout["stats"][n:, 6]
    assert not np.isin(col6, (1, 3)).any()  # never an insert, never a reset
    assert tout["valid"][n:n + N_MAP].all()  # the map re-tracked
    r = n + N_MAP + 2  # the first frame after the black ones
    assert not tout["valid"][n + N_MAP:r].any()
    assert col6[r - n] == 2 and tout["valid"][r:].all()
    same = jout["stats"][:, 6] != 2
    np.testing.assert_array_equal(tout["stats"][same], jout["stats"][same])
    np.testing.assert_allclose(tout["t"], jout["t"], rtol=0, atol=1e-3)
    for Rt, Rj in zip(tout["R"], jout["R"]):
        cos = (np.trace(Rt @ Rj.T) - 1) / 2
        assert np.arccos(np.clip(cos, -1, 1)) < 1e-3
    errs = [np.linalg.norm(tout["t"][n + i] - poses[i][1])
            for i in range(N_MAP)]
    assert np.median(errs) < 0.02
    assert np.linalg.norm(tout["t"][r] - poses[2][1]) < 0.05


def test_mapping_mode_resets_where_localization_relocalizes(runs):
    """The same state and frames outside localization mode: the small map
    is wiped at the first lost frame (Tracking.cc:542-551)."""
    path, seq, _, mapped, _, tout = runs
    tr = _port()
    checkpoint.load_auto_state(path, tr)
    for img, depth in seq[N_MAP - 1:N_MAP + 2]:  # a frame, 2 black ones
        tr.process_rgbd(img, depth)
    out = tr.finalize()
    assert out["stats"][-1, 6] == 3 and not out["initialized"]
    assert not (tout["stats"][mapped["n_frames"]:, 6] == 3).any()
