"""Batched dispatch in the port's AutoTracker (AutoTrackerConfig
batch_frames) against its per-frame path and the JAX package's, on the
CPU, at a reduced size: 320x240, 500 features, MapConfig(k_max=8,
n_feat=500, l_max=3000, d_max=8), loop closing off, 10 orbit frames.

With batch_frames=4 the port runs two batches through AutoStep.rgbd_batch
and drains the last two frames one by one. Its trajectory, statistics and
valid flags equal the per-frame run's bit for bit (the batch only groups
the uploads; the frames run through the same step in order), and agree
with the JAX package's batch_frames=4 run over the first 8 frames (two
batches, each scanned inside one program; with no partial batch the JAX
per-frame program is never compiled) within 1e-3 m,
tests/test_auto.py:204's bound.
"""
import numpy as np
import pytest
import torch

from orb_slam2_with_comment_tpu.mapstate.map import MapConfig as JaxMapConfig
from orb_slam2_with_comment_tpu.pipeline import (
    AutoTracker as JaxAutoTracker, AutoTrackerConfig as JaxAutoTrackerConfig,
    TrackerConfig as JaxTrackerConfig)
from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig
from orb_slam2_with_comment_tpu_torch.pipeline.auto import (
    AutoTracker, AutoTrackerConfig)
from orb_slam2_with_comment_tpu_torch.pipeline.tracking import TrackerConfig

torch.set_num_threads(2)

N = 10
CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
KW = dict(CAM, bf=20.0, n_features=500, min_init_features=100, fps=30,
          depth_factor=1.0 / 5000.0)
MAP = dict(k_max=8, n_feat=500, l_max=3000, d_max=8)


@pytest.fixture(scope="module")
def runs():
    world = SyntheticWorld(seed=1)
    frames = []
    for R, t in orbit_trajectory(16)[:N]:
        img, depth = world.render(R, t, **CAM)
        frames.append((np.clip(img, 0, 255).astype(np.uint8),
                       np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)))
    outs = {}
    for b in (4, 1):
        tr = AutoTracker(TrackerConfig(map_cfg=MapConfig(**MAP), **KW),
                         AutoTrackerConfig(loop_closing=False,
                                           batch_frames=b), device="cpu")
        for k, (img, depth) in enumerate(frames):
            tr.process_rgbd(img, depth, timestamp=0.5 * k)
        outs[b, "buffered"] = len(tr._batch)
        outs[b, "frame_count"] = tr.frame_count
        tr.drain()
        outs[b] = tr.finalize()
    jt = JaxAutoTracker(JaxTrackerConfig(map_cfg=JaxMapConfig(**MAP), **KW),
                        JaxAutoTrackerConfig(loop_closing=False,
                                             batch_frames=4))
    for k, (img, depth) in enumerate(frames[:8]):
        jt.process_rgbd(img, depth, timestamp=0.5 * k)
    assert not jt._batch_buf
    outs["jax"] = jt.finalize()
    return outs


def test_batch_equals_the_per_frame_path(runs):
    a, o = runs[4], runs[1]
    assert runs[4, "buffered"] == 2 and runs[1, "buffered"] == 0
    assert runs[4, "frame_count"] == runs[1, "frame_count"] == N
    for k in ("R", "t", "Rcr", "tcr", "ref_kf", "valid", "stats",
              "timestamps"):
        np.testing.assert_array_equal(a[k], o[k], err_msg=k)
    assert a["n_keyframes"] == o["n_keyframes"] and a["valid"].all()
    np.testing.assert_array_equal(a["timestamps"], 0.5 * np.arange(N))


def test_batch_matches_jax(runs):
    a, j = runs[4], runs["jax"]
    assert j["n_frames"] == 8 and j["valid"].all()
    np.testing.assert_array_equal(a["valid"][:8], j["valid"])
    np.testing.assert_array_equal(a["timestamps"][:8], j["timestamps"])
    ins = np.nonzero(a["stats"][:8, 6])[0]
    np.testing.assert_array_equal(ins, np.nonzero(j["stats"][:, 6])[0])
    assert len(ins) == j["n_keyframes"] >= 2
    np.testing.assert_allclose(a["t"][:8], j["t"], rtol=0, atol=1e-3)
