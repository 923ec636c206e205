"""The Hamming kernels' wrappers on a card: launch counting and argument
checks, and the stereo association's one launch; the pose LM kernel
against its plain version and against the baseline kernel (csrc/pose_lm_v1.cu),
one launch per solve, and two of its launches bit for bit; the ORB
kernels against their plain chain on rendered frames up to 2560x1440,
two of their launches bit for bit, three launches per extracted view and
no host wait;
the host tracker's
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
import ctypes

import numpy as np
import pytest
import torch

from orb_slam2_with_comment_tpu_torch import Sensor, System
from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
    POSE_CASES, SyntheticWorld, orbit_trajectory, pose_problem)
from orb_slam2_with_comment_tpu_torch.frontend.extractor import OrbExtractor
from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig
from orb_slam2_with_comment_tpu_torch.ops import cuda_lib, hamming, orb
from orb_slam2_with_comment_tpu_torch.optim import pose_opt
from orb_slam2_with_comment_tpu_torch.optim.residuals import CamParams
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


def _pose_args(case, seed, dev, B=3, N=1000):
    p = pose_problem(case, seed, B, N)
    return [torch.as_tensor(p[k]).to(dev) for k in (
        "R0", "t0", "Xw", "obs_uvr", "inv_sigma2", "valid")]


@pytest.mark.parametrize("case", POSE_CASES)
def test_pose_lm_kernel_matches_plain(dev, case):
    """One launch per call; against the plain version on the same card:
    inlier masks and counts exact, R and t within 1e-4, chi2 within 1e-3
    relative (float32 sums in another order)."""
    cam = CamParams.of(500.0, 500.0, 320.0, 240.0, 40.0)
    args = _pose_args(case, 200 + POSE_CASES.index(case), dev)
    before = pose_opt.LAUNCHES["pose_lm"]
    got = pose_opt.optimize_pose(cam, *args)
    assert pose_opt.LAUNCHES["pose_lm"] == before + 1
    want = pose_opt.optimize_pose_plain(cam, *args)
    assert torch.equal(got.inliers, want.inliers)
    assert torch.equal(got.n_inliers, want.n_inliers)
    dR = (got.R - want.R).abs().amax((1, 2)).tolist()
    dt = (got.t - want.t).abs().amax(1).tolist()
    assert max(dR + dt) <= 1e-4, f"|dR| {dR}, |dt| {dt} per pose"
    assert torch.allclose(got.chi2, want.chi2, rtol=1e-3, atol=1e-6)


def _v1_solve(cam, *args):
    """The baseline pose LM kernel (csrc/pose_lm_v1.cu) on the same inputs."""
    lib = pose_opt.bind_solve(ctypes.CDLL(cuda_lib.build("pose_lm_v1")))
    out = pose_opt.empty_result(*args[-1].shape, args[0].device)
    assert pose_opt.launch(lib, cam, *args, out) == 0
    return out


@pytest.mark.parametrize("shape", [(3, 1000), (1, 4096), (3, 100)])
def test_pose_lm_kernel_matches_plain_and_v1(dev, shape):
    """At the main path's shapes: one launch per solve; the plain version's
    inlier masks and counts, R and t within 1e-4, chi2 within 1e-3
    relative; the baseline kernel's bits where the kernel gives a pose one
    block, as at [3x100] (else the baseline kernel meets the same
    gates)."""
    cam = CamParams.of(500.0, 500.0, 320.0, 240.0, 40.0)
    args = _pose_args("outliers", 21, dev, *shape)
    if shape == (3, 100):
        assert pose_opt.blocks_per_pose(shape[1]) == 1
    before = pose_opt.LAUNCHES["pose_lm"]
    got = pose_opt.optimize_pose(cam, *args)
    assert pose_opt.LAUNCHES["pose_lm"] == before + 1
    want = pose_opt.optimize_pose_plain(cam, *args)
    prev = _v1_solve(cam, *args)
    for out in (got, prev):
        assert torch.equal(out.inliers, want.inliers)
        assert torch.equal(out.n_inliers, want.n_inliers)
        assert max(float((out.R - want.R).abs().max()),
                   float((out.t - want.t).abs().max())) <= 1e-4
        assert torch.allclose(out.chi2, want.chi2, rtol=1e-3, atol=1e-6)
    if pose_opt.blocks_per_pose(shape[1]) == 1:
        for a, b in zip(got, prev):
            assert torch.equal(a, b)


def test_pose_lm_launches_are_bit_identical(dev):
    """Two launches on the same inputs give the same bits (fixed-order
    reductions, no atomics), at the largest N the main path gives it; the
    wrapper refuses what the kernel does not take."""
    cam = CamParams.of(500.0, 500.0, 320.0, 240.0, 40.0)
    args = _pose_args("outliers", 9, dev, B=1, N=4096)
    a = pose_opt.optimize_pose(cam, *args)
    b = pose_opt.optimize_pose(cam, *args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        pose_opt.optimize_pose(cam, *args[:2], args[2].cpu(), *args[3:])
    with pytest.raises(ValueError):
        pose_opt.optimize_pose(cam, *_pose_args(
            "mixed", 9, dev, B=1, N=pose_opt.MAX_EDGES + 1))


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


def _orb_frame(w, h, n):
    R, t = orbit_trajectory(16)[5]
    f = 500.0 * w / 640.0
    img, _ = SyntheticWorld(seed=1).render(R, t, fx=f, fy=f, cx=w / 2,
                                           cy=h / 2, width=w, height=h)
    return (torch.as_tensor(np.clip(img, 0, 255).astype(np.uint8)),
            OrbExtractor(n_features=n))


@pytest.mark.parametrize("size", [(640, 480, 1000), (320, 240, 500)])
def test_orb_kernels_match_their_plain_chain(dev, size):
    """K2's three launches against the plain chain on the same card:
    positions, responses, octaves and valid flags identical; angles
    identical on level 0 and within 1e-4 on coarser levels wherever the IC
    moments keep 1/1000 of their terms' magnitude (the moments are summed
    in another order than cuBLAS's); descriptors identical wherever the
    angles are, at most 1% of the valid rows differing, by at most 8
    bits."""
    img, ext = _orb_frame(*size)
    pyr = ext._pyramid(img.to(dev))
    levels = orb.level_table(tuple(tuple(p.shape) for p in pyr),
                             tuple(ext.budgets), tuple(ext.scales))
    flat = torch.cat([p.reshape(-1) for p in pyr])
    before = dict(orb.LAUNCHES)
    got = orb.extract_levels(pyr, ext.budgets, ext.scales)
    assert all(orb.LAUNCHES[k] == before[k] + 1 for k in orb.LAUNCHES)
    want = orb.extract_levels_plain(flat, levels)
    xy, resp, octv, ang, desc, valid = got
    for a, b in ((xy, want[0]), (resp, want[1]), (octv, want[2]),
                 (valid, want[5])):
        assert torch.equal(a, b)
    level0 = octv == 0
    assert torch.equal(ang[level0], want[3][level0])
    yx = orb.select_plain(*orb.cells_plain(flat, levels)[2:], levels)[0]
    kept = orb.moment_cancellation(flat, yx, levels) >= 1e-3
    assert (ang - want[3]).abs()[kept].max() <= 1e-4
    rows = (desc != want[4]).any(1)
    assert not rows[ang == want[3]].any()
    assert int((rows & valid).sum()) <= 0.01 * int(valid.sum())
    bits = hamming.popcount32(desc ^ want[4]).sum(1)
    assert int(bits[valid].max()) <= 8


@pytest.mark.parametrize("size", [(1921, 1081), (2560, 1440)])
def test_orb_select_takes_any_frame_size(dev, size):
    """Frames above the former 2048-cell limit: orb_select bit for bit
    against select_plain on the same candidates, one launch; the whole
    extract_levels against the plain chain: positions, responses, octaves
    and valid flags identical, angles identical on level 0 and within
    1e-4 on coarser levels where the moments keep 1/1000 of their terms,
    descriptors identical wherever the angles are, at most 1% of the valid
    rows differing, by at most 8 bits."""
    img, ext = _orb_frame(*size, 1000)
    pyr = ext._pyramid(img.to(dev))
    levels = orb.level_table(tuple(tuple(p.shape) for p in pyr),
                             tuple(ext.budgets), tuple(ext.scales))
    assert levels[0].cy * levels[0].cx > 2048
    flat = torch.cat([p.reshape(-1) for p in pyr])
    cand_v, cand_i = orb.cells_plain(flat, levels)[2:]
    before = orb.LAUNCHES["orb_select"]
    got = orb.select(cand_v, cand_i, levels)
    assert orb.LAUNCHES["orb_select"] == before + 1
    for a, b in zip(got, orb.select_plain(cand_v, cand_i, levels)):
        assert torch.equal(a, b)
    xy, resp, octv, ang, desc, valid = orb.extract_levels(
        pyr, ext.budgets, ext.scales)
    want = orb.extract_levels_plain(flat, levels)
    for a, b in ((xy, want[0]), (resp, want[1]), (octv, want[2]),
                 (valid, want[5])):
        assert torch.equal(a, b)
    assert int(valid.sum()) > 300
    level0 = octv == 0
    assert torch.equal(ang[level0], want[3][level0])
    kept = orb.moment_cancellation(flat, got[0], levels) >= 1e-3
    assert (ang - want[3]).abs()[kept].max() <= 1e-4
    rows = (desc != want[4]).any(1)
    assert not rows[ang == want[3]].any()
    assert int((rows & valid).sum()) <= 0.01 * int(valid.sum())
    bits = hamming.popcount32(desc ^ want[4]).sum(1)
    assert int(bits[valid].max()) <= 8


def test_orb_launches_are_bit_identical_and_checked(dev):
    """Two launches on the same view give the same bits (no float
    atomics); the wrapper refuses float64 and a level budget above what
    orb_select's shared memory holds."""
    img, ext = _orb_frame(640, 480, 2000)
    pyr = ext._pyramid(img.to(dev))
    a = orb.extract_levels(pyr, ext.budgets, ext.scales)
    b = orb.extract_levels(pyr, ext.budgets, ext.scales)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        orb.extract_levels([p.double() for p in pyr], ext.budgets,
                           ext.scales)
    with pytest.raises(ValueError):
        orb.extract_levels([torch.zeros((4096, 4096), device=dev)],
                           [orb.MAX_BUDGET + 1], [1.0])
    with pytest.raises(ValueError):
        orb.extract_levels([pyr[0], *(p.cpu() for p in pyr[1:])],
                           ext.budgets, ext.scales)


def test_extraction_is_three_launches_a_view(dev):
    """OrbExtractor launches each K2 kernel once per view: once for an
    image, twice for a stereo pair."""
    img, ext = _orb_frame(320, 240, 500)
    before = dict(orb.LAUNCHES)
    ext(img.to(dev))
    assert all(orb.LAUNCHES[k] == before[k] + 1 for k in orb.LAUNCHES)
    ext.stereo(img.to(dev), img.to(dev), 20.0, 250.0)
    assert all(orb.LAUNCHES[k] == before[k] + 3 for k in orb.LAUNCHES)


def test_extraction_adds_no_host_wait(dev):
    """After a warm-up call (the kernels' build, the BRIEF pattern's and
    the resize weights' one upload each), an extraction on the card runs
    under torch.cuda's sync debug mode "error": the pyramid, the packing,
    the three launches and their allocations never wait on the card."""
    img, ext = _orb_frame(640, 480, 1000)
    img = img.to(dev)
    ext(img)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        feats = ext(img)
        pyr = ext._pyramid(img)
        again = ext._extract_from_pyramid(pyr)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert feats.valid.is_cuda and int(feats.valid.sum()) > 500
    assert torch.equal(again.desc, feats.desc)


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


def test_map_writes_do_not_wait_on_the_card(dev):
    """set_last, insert_keyframe and merge_duplicate_landmarks run under
    torch.cuda's sync debug mode "error" (any host wait raises), and a
    plain System.track_rgbd call waits on the card at most twice (the sync
    debug mode's flagged waits plus the tracker's own non-blocking
    readbacks)."""
    import warnings
    from orb_slam2_with_comment_tpu_torch.mapstate.map import set_last
    from orb_slam2_with_comment_tpu_torch.pipeline import steps
    cam = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    cfg = TrackerConfig(**cam, bf=20.0, n_features=500, min_init_features=100,
                        fps=30, depth_factor=1.0 / 5000.0,
                        map_cfg=MapConfig(16, 500, 4000, 8))
    slam = System(cfg, Sensor.RGBD)
    tr = slam.tracker
    world = SyntheticWorld(seed=1)
    frames = []
    for R, t in orbit_trajectory(16)[:12]:
        img, depth = world.render(R, t, **cam)
        frames.append((np.clip(img, 0, 255).astype(np.uint8),
                       np.clip(depth * 5000, 0, 65535).astype(np.uint16)))
    waits = {"n": 0}
    wait = Readback.result

    def counted(self):
        waits["n"] += self._event is not None and not hasattr(self, "_w")
        self._w = True
        return wait(self)

    plain = []
    for i, (img, depth) in enumerate(frames):
        n_kf = tr.n_kf_host
        waits["n"] = 0
        torch.cuda.set_sync_debug_mode("warn" if i >= 4 else 0)
        Readback.result = counted
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                slam.track_rgbd(img, depth, i / 30.0)
        finally:
            Readback.result = wait
            torch.cuda.set_sync_debug_mode(0)
        n = waits["n"] + sum("synchroniz" in str(w.message) for w in caught)
        if i >= 4 and tr.n_kf_host == n_kf:
            plain.append(n)
    slam.shutdown()
    assert plain and max(plain) <= 2, plain

    m = tr.map
    obs = tr.last_obs
    k = tr.n_kf_host
    idx = torch.randint(0, 50, (300,), device=dev)
    vals = torch.randn(300, 3, device=dev)
    dst = torch.zeros(50, 3, device=dev)
    R, t = m.kf_R[0].clone(), m.kf_t[0].clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = set_last(dst, idx, vals)
        m2 = steps.insert_keyframe(m, obs, R, t, 99)
        m3 = steps.merge_duplicate_landmarks(m2, k)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    last = {}
    for i, j in enumerate(idx.tolist()):
        last[j] = i
    for j, i in last.items():
        assert torch.equal(out[j], vals[i])
    assert int(m2.n_kf) == int(m.n_kf) + 1 and bool(m3.kf_valid[k])
