"""The Hamming kernels' wrappers on a card: launch counting and argument
checks, and the stereo association's one launch; the host tracker's
non-blocking readback, System on the card by default, and the map loader
and AutoTracker.sync() on the card.

The kernels' bit-exact comparison with their plain versions, and the slice
on the card against the CPU, are phases of ``chip_smoke.py`` and are not
repeated here. These tests need a CUDA device and skip without one. They
import neither jax nor the JAX package, so they also run on a machine that
has only PyTorch:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)
"""
import numpy as np
import pytest
import torch

from orb_slam2_with_comment_tpu_torch import Sensor, System
from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu_torch.frontend.extractor import OrbExtractor
from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig
from orb_slam2_with_comment_tpu_torch.ops import hamming
from orb_slam2_with_comment_tpu_torch.pipeline import TrackerConfig, TrackState
from orb_slam2_with_comment_tpu_torch.pipeline.loop_closing import Readback

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _desc(rng, n):
    d = rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    return torch.as_tensor(d.view(np.int32))


def test_wrappers_count_and_check(dev):
    d = _desc(np.random.RandomState(4), 16).to(dev)
    mask = torch.ones((16, 16), dtype=torch.bool, device=dev)
    before = dict(hamming.LAUNCHES)
    hamming.masked_best_two(d, d, mask)
    hamming.distance_matrix(d, d)
    assert hamming.LAUNCHES["masked_best_two"] == before["masked_best_two"] + 1
    assert hamming.LAUNCHES["distance_matrix"] == before["distance_matrix"] + 1
    with pytest.raises(ValueError):
        hamming.distance_matrix(d.long(), d.long())
    with pytest.raises(ValueError):
        hamming.masked_best_two(d, d.cpu(), mask)
    with pytest.raises(ValueError):
        hamming.masked_best_two(d, d, mask.int())


def test_stereo_association_is_one_launch(dev):
    """OrbExtractor.stereo on the card agrees with the CPU (plain versions)
    and launches masked_best_two once, distance_matrix never."""
    cam = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    world = SyntheticWorld(seed=1)
    R, t = orbit_trajectory(16)[5]
    t_r = np.asarray(t, np.float32) - np.array([0.08, 0, 0], np.float32)
    left, right = (torch.as_tensor(np.clip(world.render(R, tt, **cam)[0], 0,
                                           255).astype(np.uint8))
                   for tt in (t, t_r))
    ext = OrbExtractor(n_features=500)
    before = dict(hamming.LAUNCHES)
    feats, sd = ext.stereo(left.to(dev), right.to(dev), 20.0, 250.0)
    assert hamming.LAUNCHES["masked_best_two"] == before["masked_best_two"] + 1
    assert hamming.LAUNCHES["distance_matrix"] == before["distance_matrix"]
    feats_c, sd_c = ext.stereo(left, right, 20.0, 250.0)
    has = sd_c.depth > 0
    assert int(has.sum()) > 150
    # the card sums the SAD windows and the IC moments in another order
    assert torch.equal(sd.depth.cpu() > 0, has)
    assert torch.allclose(sd.depth.cpu()[has], sd_c.depth[has], rtol=1e-3)


def test_readback_goes_through_pinned_memory(dev):
    t = torch.arange(12, dtype=torch.int32, device=dev).reshape(2, 6)
    rb = Readback(t, t * 2)
    a, b = rb.result()
    assert rb.done() and all(h.is_pinned() for h in rb._host)
    np.testing.assert_array_equal(a, np.arange(12).reshape(2, 6))
    np.testing.assert_array_equal(b, 2 * a)


def test_system_runs_on_the_card_by_default(dev):
    """System(cfg) puts its map on the card; a few pipelined RGB-D frames
    give LazyPoses of device tensors, and the flushed log holds them all."""
    cam = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    cfg = TrackerConfig(**cam, bf=20.0, n_features=500, min_init_features=100,
                        fps=30, depth_factor=1.0 / 5000.0,
                        map_cfg=MapConfig(16, 500, 4000, 8))
    slam = System(cfg, Sensor.RGBD)
    assert slam.tracker.map.kf_R.is_cuda
    world = SyntheticWorld(seed=1)
    poses = orbit_trajectory(16)[:6]
    for i, (R, t) in enumerate(poses):
        img, depth = world.render(R, t, **cam)
        pose = slam.track_rgbd(np.clip(img, 0, 255).astype(np.uint8),
                               np.clip(depth * 5000, 0, 65535).astype(
                                   np.uint16), i / 30.0)
        assert pose is not None and pose._R.is_cuda
    slam.shutdown()
    assert slam.get_tracking_state() == TrackState.OK
    assert len(slam.tracker.rel_log) == len(poses)
    np.testing.assert_allclose(np.asarray(pose)[:3, 3], poses[-1][1],
                               atol=0.02)


def test_load_map_and_sync_on_the_card(dev, tmp_path):
    """checkpoint.load_map puts a map on the card by default, and
    AutoTracker.sync() waits for the card."""
    from orb_slam2_with_comment_tpu_torch import checkpoint
    from orb_slam2_with_comment_tpu_torch.mapstate.map import empty_map
    from orb_slam2_with_comment_tpu_torch.pipeline import AutoTracker
    path = str(tmp_path / "m.npz")
    checkpoint.save_map(path, empty_map(MapConfig(4, 8, 16, 2), "cpu"))
    assert checkpoint.load_map(path).kf_R.is_cuda
    cfg = TrackerConfig(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320,
                        height=240, n_features=500, min_init_features=100,
                        fps=30, depth_factor=1.0,
                        map_cfg=MapConfig(16, 500, 4000, 8))
    tracker = AutoTracker(cfg)
    img, depth = SyntheticWorld(seed=1).render(
        *orbit_trajectory(16)[0], fx=250.0, fy=250.0, cx=160.0, cy=120.0,
        width=320, height=240)
    tracker.process_rgbd(np.clip(img, 0, 255).astype(np.uint8), depth)
    tracker.sync()
    assert tracker.state.map.lm_pw.is_cuda and tracker.finalize()["valid"][0]
