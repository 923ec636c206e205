"""The Hamming kernels' wrappers on a card: launch counting and argument
checks, and the stereo association's one launch; the pose LM kernel
against its plain version and against the baseline kernel (csrc/pose_lm_v1.cu),
one launch per solve, and two of its launches bit for bit; the ORB
kernels against their plain chain on rendered frames up to 2560x1440,
two of their launches bit for bit, three launches per extracted view and
no host wait; the redesigned orb_cells against its plain version and
PR 10's kernel (csrc/orb_v1.cu) bit for bit where ties and ragged cells
live, orb_describe's gates at 2000 slots and at 1921x1081, and both
kernels' resident blocks per SM; the stereo SAD kernel's first design
(csrc/stereo_sad_v1.cu) against its plain version; K5 (csrc/stereo_sad.cu:
the refinement, the depth and the median sweep of a pair) against
stereo_depth_plain in bits at 500, 4096 and 8192 keypoints (more than
the resident grid's warps), one launch a call and no host wait, its replay in a CUDA graph
and its argument checks; the dense BA kernel (K4) against its plain version, one launch a solve, its
factorization in shared memory (24 poses) and from global memory (64),
the step it rejects where S is not positive definite, two solves bit for
bit and its limits; the host tracker's
non-blocking readback, System on the card by default, and the map loader
and AutoTracker.sync() on the card; the port's bench
(orb_slam2_with_comment_tpu_torch/bench.py) at BENCH_FRAMES 20 with no
error and each kernel launched on its paths.

The kernels' bit-exact comparison with their plain versions, and the slice
on the card against the CPU, are phases of ``chip_smoke.py`` and are not
repeated here. These tests need a CUDA device and skip without one. They
import neither jax nor the JAX package, so they also run on a machine that
has only PyTorch:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)
"""
import ctypes
import os
import re

import numpy as np
import pytest
import torch

from orb_slam2_with_comment_tpu_torch import Sensor, System, bench
from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
    POSE_CASES, SyntheticWorld, ba_problem, orbit_trajectory, pose_problem)
from orb_slam2_with_comment_tpu_torch.frontend import stereo
from orb_slam2_with_comment_tpu_torch.frontend.extractor import OrbExtractor
from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig
from orb_slam2_with_comment_tpu_torch.ops import cuda_lib, hamming, orb, sad
from orb_slam2_with_comment_tpu_torch.optim import ba, pose_opt
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


def test_masked_best_two_above_2_22_targets(dev):
    """[4 x 4,194,321]: the 64-bit key's instantiation against
    masked_best_two_plain bit for bit, with candidates past column 2^22,
    ties between columns on either side of it, and a row of none."""
    n = hamming.NARROW_TARGETS + 17
    rng = np.random.RandomState(5)
    dt = _desc(rng, n).to(dev)
    dq = _desc(rng, 4).to(dev)
    mask = torch.rand((4, n), generator=torch.Generator(dev).manual_seed(3),
                      device=dev) < 0.01
    dt[n - 5] = dq[0]  # distance 0 past 2^22 ...
    dt[7] = dq[0]      # ... and the same at column 7: 7 wins
    mask[0, [7, n - 5]] = True
    dt[n - 1] = dq[1]  # the best only past 2^22
    mask[1, n - 1] = True
    mask[3] = False
    before = hamming.LAUNCHES["masked_best_two"]
    got = hamming.masked_best_two(dq, dt, mask)
    assert hamming.LAUNCHES["masked_best_two"] == before + 1
    want = hamming.masked_best_two_plain(dq, dt, mask)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[1].tolist()[:2] == [7, n - 1] and got[0][3] == hamming.BIG


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
    wrapper refuses tensors on two devices; above the edges 8 blocks stage
    it takes the kernel too."""
    cam = CamParams.of(500.0, 500.0, 320.0, 240.0, 40.0)
    args = _pose_args("outliers", 9, dev, B=1, N=4096)
    a = pose_opt.optimize_pose(cam, *args)
    b = pose_opt.optimize_pose(cam, *args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        pose_opt.optimize_pose(cam, *args[:2], args[2].cpu(), *args[3:])
    before = pose_opt.LAUNCHES["pose_lm"]
    out = pose_opt.optimize_pose(cam, *_pose_args(
        "mixed", 9, dev, B=1, N=pose_opt.STAGED_EDGES + 1))
    assert pose_opt.LAUNCHES["pose_lm"] == before + 1
    assert int(out.n_inliers[0]) > 0.7 * pose_opt.STAGED_EDGES


@pytest.mark.parametrize("shape", [(1, 65536), (2, 130000)])
def test_pose_lm_variants_match_plain(dev, shape):
    """Above the 61,440 edges a portable cluster stages: a non-portable
    cluster of 16 blocks (65,536), then the edges read from global memory
    at every pass (130,000): against the plain version as
    test_pose_lm_kernel_matches_plain holds it; two launches bit for
    bit."""
    B, N = shape
    cam = CamParams.of(500.0, 500.0, 320.0, 240.0, 40.0)
    args = _pose_args("outliers", 11, dev, B=B, N=N)
    assert pose_opt.streams(N) == (N > 2 * pose_opt.STAGED_EDGES)
    if N <= 2 * pose_opt.STAGED_EDGES:
        assert pose_opt.blocks_per_pose(N) == 16
    out = pose_opt.optimize_pose(cam, *args)
    again = pose_opt.optimize_pose(cam, *args)
    for x, y in zip(out, again):
        assert torch.equal(x, y)
    want = pose_opt.optimize_pose_plain(cam, *args)
    assert torch.equal(out.inliers, want.inliers)
    assert torch.equal(out.n_inliers, want.n_inliers)
    assert torch.allclose(out.R, want.R, rtol=0, atol=1e-4)
    assert torch.allclose(out.t, want.t, rtol=0, atol=1e-4)
    assert torch.allclose(out.chi2, want.chi2, rtol=1e-3, atol=1e-6)


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


# configurations the strip kernel and the 16-level table did not take:
# (width, height, OrbExtractor keywords)
ORB_VARIANTS = {
    "cell30-18-levels": (640, 480, dict(n_features=1000, cell=30,
                                        n_levels=18)),
    "cell16-per_cell4": (640, 480, dict(n_features=1000, cell=16,
                                        per_cell=4)),
    "budget-above-28672": (2560, 1440, dict(n_features=140000)),
}


@pytest.mark.parametrize("name", sorted(ORB_VARIANTS))
def test_orb_variants_match_their_plain_chain(dev, name):
    """orb_cells_any (another cell side or count), the level table in
    device memory (18 levels) and orb_select's global scratch (a level of
    more than 28,672 slots) against the plain chain on the same card, as
    test_orb_kernels_match_their_plain_chain holds the default shapes:
    candidates and selection bit for bit, then the angle (on the valid
    slots) and descriptor gates."""
    w, h, kw = ORB_VARIANTS[name]
    img, _ = _orb_frame(w, h, 1)
    ext = OrbExtractor(**kw)
    pyr = ext._pyramid(img.to(dev))
    levels = orb.level_table(tuple(tuple(p.shape) for p in pyr),
                             tuple(ext.budgets), tuple(ext.scales), ext.cell)
    if "budget" in name:
        assert levels[0].budget > orb.MAX_BUDGET
    flat = torch.cat([p.reshape(-1) for p in pyr])
    plain = orb.cells_plain(flat, levels, per_cell=ext.per_cell)
    before = dict(orb.LAUNCHES)
    cells = orb.cells(flat, levels, per_cell=ext.per_cell)
    assert orb.LAUNCHES["orb_cells"] == before["orb_cells"] + 1
    for a, b in zip(cells, plain):
        assert torch.equal(a, b)
    sel = orb.select(*plain[2:], levels)
    for a, b in zip(sel, orb.select_plain(*plain[2:], levels)):
        assert torch.equal(a, b)
    xy, resp, octv, ang, desc, valid = ext._extract_from_pyramid(pyr)
    want = orb.extract_levels_plain(flat, levels, per_cell=ext.per_cell)
    for a, b in ((xy, want[0]), (resp, want[1]), (octv, want[2]),
                 (valid, want[5])):
        assert torch.equal(a, b)
    assert int(valid.sum()) > 500
    level0 = octv == 0
    assert torch.equal(ang[level0], want[3][level0])
    # the angles held on the valid slots (chip_smoke.hold_orb_variant)
    kept = (orb.moment_cancellation(flat, sel[0], levels) >= 1e-3) & valid
    assert (ang - want[3]).abs()[kept].max() <= 1e-4
    rows = (desc != want[4]).any(1)
    assert not rows[ang == want[3]].any()
    assert int((rows & valid).sum()) <= 0.01 * int(valid.sum())
    bits = hamming.popcount32(desc ^ want[4]).sum(1)
    assert int(bits[valid].max()) <= 8


def test_orb_launches_are_bit_identical_and_checked(dev):
    """Two launches on the same view give the same bits (no float
    atomics); the wrapper refuses float64 and takes a level budget above
    what orb_select's shared memory holds."""
    img, ext = _orb_frame(640, 480, 2000)
    pyr = ext._pyramid(img.to(dev))
    a = orb.extract_levels(pyr, ext.budgets, ext.scales)
    b = orb.extract_levels(pyr, ext.budgets, ext.scales)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        orb.extract_levels([p.double() for p in pyr], ext.budgets,
                           ext.scales)
    # a budget above what orb_select ranks in shared memory: its global
    # scratch
    flat0 = torch.zeros(4096 * 4096, device=dev)
    got = orb.extract_levels([flat0.view(4096, 4096)], [orb.MAX_BUDGET + 1],
                             [1.0])
    big = orb.level_table(((4096, 4096),), (orb.MAX_BUDGET + 1,), (1.0,))
    for x, y in zip(got, orb.extract_levels_plain(flat0, big)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        orb.extract_levels([pyr[0], *(p.cpu() for p in pyr[1:])],
                           ext.budgets, ext.scales)


def _v1_orb():
    """PR 10's orb_cells and orb_describe (csrc/orb_v1.cu)."""
    return orb._bind(ctypes.CDLL(cuda_lib.build("orb_v1")),
                     ("orb_table_bytes", "orb_resident_blocks", "orb_cells",
                      "orb_describe"))


def _checker_frame():
    yy, xx = np.mgrid[:480, :640]
    return torch.as_tensor((((yy // 16) + (xx // 16)) % 2 * 180
                            + 40).astype(np.uint8))


@pytest.mark.parametrize("frame", ["checkerboard", "flat", "641x479"])
def test_orb_cells_is_bit_for_bit_with_plain_and_v1(dev, frame):
    """Where ties and ragged cells live (a checkerboard's equal scores, a
    flat frame's zeros, a frame whose every level has ragged cells): the
    redesigned orb_cells gives cells_plain's score and blurred buffers and
    candidates, and PR 10's kernel's (csrc/orb_v1.cu) bit for bit, a zero
    score's sign too; one launch."""
    if frame == "checkerboard":
        img, ext = _checker_frame(), OrbExtractor(n_features=1000)
    elif frame == "flat":
        img = torch.full((480, 640), 128, dtype=torch.uint8)
        ext = OrbExtractor(n_features=1000)
    else:
        img, ext = _orb_frame(641, 479, 1000)
    pyr = ext._pyramid(img.to(dev))
    levels = orb.level_table(tuple(tuple(p.shape) for p in pyr),
                             tuple(ext.budgets), tuple(ext.scales))
    flat = torch.cat([p.reshape(-1) for p in pyr])
    before = orb.LAUNCHES["orb_cells"]
    got = orb.cells(flat, levels)
    assert orb.LAUNCHES["orb_cells"] == before + 1
    want = orb.cells_plain(flat, levels)
    prev = orb.launch_cells(_v1_orb(), flat, levels)
    for i, part in enumerate(("score", "blurred")):
        for lv in levels:
            a, b, c = (orb._view(x[i], lv) for x in (got, want, prev))
            assert torch.equal(a, b), (part, lv.lvl)
            assert torch.equal(a.view(torch.int32), c.view(torch.int32)), \
                (part, lv.lvl)
    for a, b, c in zip(got[2:], want[2:], prev[2:]):
        assert torch.equal(a, b)
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))


@pytest.mark.parametrize("size", [(640, 480, 2000), (1921, 1081, 1000)])
def test_orb_describe_holds_its_gates(dev, size):
    """orb_describe on the plain chain's keypoints against describe_plain:
    positions and octaves identical, angles identical on level 0 and
    within 1e-4 on coarser levels where the IC moments keep 1/1000 of
    their terms (their sums run in another order), descriptors identical
    wherever the angles are, at most 1% of the valid rows differing, by at
    most 8 bits; one launch; two launches bit for bit."""
    img, ext = _orb_frame(*size)
    pyr = ext._pyramid(img.to(dev))
    levels = orb.level_table(tuple(tuple(p.shape) for p in pyr),
                             tuple(ext.budgets), tuple(ext.scales))
    flat = torch.cat([p.reshape(-1) for p in pyr])
    score, blurred, cand_v, cand_i = orb.cells_plain(flat, levels)
    yx, _, valid = orb.select_plain(cand_v, cand_i, levels)
    before = orb.LAUNCHES["orb_describe"]
    got = orb.describe(flat, score, blurred, yx, levels)
    assert orb.LAUNCHES["orb_describe"] == before + 1
    again = orb.describe(flat, score, blurred, yx, levels)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    xy, octv, ang, desc = got
    want = orb.describe_plain(flat, score, blurred, yx, levels)
    assert torch.equal(xy, want[0]) and torch.equal(octv, want[1])
    level0 = octv == 0
    assert torch.equal(ang[level0], want[2][level0])
    kept = orb.moment_cancellation(flat, yx, levels) >= 1e-3
    assert (ang - want[2]).abs()[kept].max() <= 1e-4
    rows = (desc != want[3]).any(1)
    assert not rows[ang == want[2]].any()
    assert int((rows & valid).sum()) <= 0.01 * int(valid.sum())
    bits = hamming.popcount32(desc ^ want[3]).sum(1)
    assert int(bits[valid].max()) <= 8


def test_orb_kernels_are_as_resident_as_designed(dev):
    """cudaOccupancyMaxActiveBlocksPerMultiprocessor gives orb_cells and
    orb_describe at least the blocks per SM their launch bounds ask for
    (kCellBlocks and kDescribeBlocks in csrc/orb.cu)."""
    with open(os.path.join(cuda_lib.CSRC_DIR, "orb.cu")) as f:
        src = f.read()
    designed = [int(re.search(rf"{c} = (\d+);", src).group(1))
                for c in ("kCellBlocks", "kDescribeBlocks")]
    cells, describe = orb.resident_blocks()
    assert cells >= designed[0] and describe >= designed[1]
    assert min(orb.resident_blocks(_v1_orb())) >= 1


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


def _sad_inputs(dev, n=500):
    """A rendered 320x240 pair on the card: the packed pyramids, the level
    table, the left keypoints, their coarse right u from the stereo
    association, and the valid flags; a fifth of the keypoints then moved
    onto the image border and a fifth of the coarse u off either side."""
    cam = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    world = SyntheticWorld(seed=1)
    R, t = orbit_trajectory(16)[5]
    t_r = np.asarray(t, np.float32) - np.array([0.08, 0, 0], np.float32)
    ext = OrbExtractor(n_features=n)
    pyr = [ext._pyramid(torch.as_tensor(np.clip(world.render(
        R, tt, **cam)[0], 0, 255).astype(np.uint8)).to(dev))
        for tt in (t, t_r)]
    fl, fr = (ext._extract_from_pyramid(p) for p in pyr)
    mask = stereo.association_mask(fl, fr, ext.scales, 250.0)
    _, best_j, _, _ = hamming.masked_best_two(fl.desc, fr.desc, mask)
    levels = orb.level_table(tuple(tuple(p.shape) for p in pyr[0]),
                             tuple(ext.budgets), tuple(ext.scales))
    xy, u0 = fl.xy.clone(), fr.xy[best_j.long(), 0]
    k = n // 5
    xy[:k:2, 0] = 0.0
    xy[1:k:2, 1] = 239.0
    u0[k:2 * k:2] = -2.0
    u0[k + 1:2 * k:2] = 330.0
    return orb.pack(pyr[0]), orb.pack(pyr[1]), levels, xy, u0, fl.valid


def test_stereo_sad_kernel_matches_plain(dev):
    """K5's first design (csrc/stereo_sad_v1.cu) in one launch for every
    level against sad_refine_plain on the same card: the best shift and ok identical except at near-ties (the two
    lowest SADs within 1e-5 relative: the 121-term sums run in another
    order), at most 0.5% of the valid keypoints; u within 1e-4 px and the best
    SAD within 1e-5 relative where both pick the same shift; two launches
    bit for bit."""
    fl, fr, levels, xy, u0, valid = _sad_inputs(dev)
    before = sad.V1_LAUNCHES["stereo_sad_v1"]
    got = sad.sad_refine(fl, fr, levels, xy, u0)
    assert sad.V1_LAUNCHES["stereo_sad_v1"] == before + 1
    u, s, ok, best = sad.launch(sad._v1_kernel_lib(), fl, fr, levels, xy,
                                u0)
    for a, b in zip(got, (u, s, ok)):
        assert torch.equal(a, b)
    want = sad.sad_refine_plain(fl, fr, levels, xy, u0)
    curves = sad.sad_curves_plain(fl, fr, levels, xy, u0)
    two = curves.topk(2, dim=1, largest=False).values
    near = (two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 1].abs()
    same = best.long() == curves.argmin(1)
    assert bool((same | near).all()) and bool(((ok == want[2]) | near).all())
    assert int((near & valid).sum()) <= 0.005 * int(valid.sum())
    both = same & ok & want[2]
    assert int(both.sum()) > 100
    assert float((u - want[0]).abs()[both].max()) <= 1e-4
    assert torch.allclose(s[same], want[1][same], rtol=1e-5, atol=0)


def test_stereo_sad_checks_its_arguments(dev):
    fl, fr, levels, xy, u0, _ = _sad_inputs(dev, n=100)
    with pytest.raises(ValueError, match="float32"):
        sad.sad_refine(fl, fr, levels, xy.double(), u0)
    with pytest.raises(ValueError, match="one CUDA device"):
        sad.sad_refine(fl, fr.cpu(), levels, xy, u0)
    # the first design's own table check: at least 11 x 21 a level
    small = orb.level_table(((40, 20),), (3,), (1.0,))
    z = torch.zeros(800, device=dev)
    with pytest.raises(RuntimeError, match="stereo_sad launch failed"):
        sad.sad_refine(z, z, small, torch.zeros(3, 2, device=dev),
                       torch.zeros(3, device=dev))


def _depth_inputs(dev, n, **kw):
    """stereo_depth's inputs on the main path for a rendered 320x240 pair
    on the card with n features (further OrbExtractor keywords ``kw``):
    the packed pyramids, the level table, the left and right keypoints,
    K1's best distance and index."""
    cam = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    world = SyntheticWorld(seed=1)
    R, t = orbit_trajectory(16)[5]
    t_r = np.asarray(t, np.float32) - np.array([0.08, 0, 0], np.float32)
    ext = OrbExtractor(n_features=n, **kw)
    pyr = [ext._pyramid(torch.as_tensor(np.clip(world.render(
        R, tt, **cam)[0], 0, 255).astype(np.uint8)).to(dev))
        for tt in (t, t_r)]
    fl, fr = (ext._extract_from_pyramid(p) for p in pyr)
    mask = stereo.association_mask(fl, fr, ext.scales, 250.0)
    best_d, best_j, _, _ = hamming.masked_best_two(fl.desc, fr.desc, mask)
    levels = orb.level_table(tuple(tuple(p.shape) for p in pyr[0]),
                             tuple(ext.budgets), tuple(ext.scales))
    return (orb.pack(pyr[0]), orb.pack(pyr[1]), levels, fl.xy, fr.xy,
            best_d, best_j)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("n", [500, 4096, 8192, "24 levels"])
def test_stereo_depth_kernel_matches_plain_in_bits(dev, n):
    """K5 against stereo_depth_plain on the same card: u_right and depth in
    bits; the best SAD, ok and the best shift in bits against
    sad_refine_plain; two launches in bits. At 8192 keypoints the resident
    grid's warps walk the keypoints twice. At 24 levels (2000 features, a
    4 px margin) the table lies in device memory and levels 14-23 are under
    11 rows: their reads clamped, and keypoints land on some of them."""
    kw = {}
    if n == "24 levels":
        n, kw = 2000, dict(n_levels=24, margin=4)
    fl, fr, levels, xy, xy_r, bd, bj = args = _depth_inputs(dev, n, **kw)
    if kw:
        small = [lv for lv in levels if lv.h < sad.PATCH]
        assert len(levels) == 24 and small
        lo = small[0].slot
        assert bool((bd[lo:] < sad.TH_ORB).any())  # matched there
    lay = sad.layout(levels)
    assert lay.n == n
    if n == 8192:
        assert sad._kernel_lib().stereo_depth_grid(n) * 8 < n
    out = sad.launch_depth(sad._kernel_lib(), lay, *args[:2], *args[3:],
                           20.0, 250.0)
    got = sad.outputs(out, n)
    u, d = sad.stereo_depth_plain(*args, 20.0, 250.0)
    u_r0 = xy_r[bj.long(), 0]
    _, s, ok = sad.sad_refine_plain(fl, fr, levels, xy, u_r0)
    best = sad.sad_curves_plain(fl, fr, levels, xy, u_r0).argmin(1)
    assert torch.equal(_bits(got["u_right"]), _bits(u))
    assert torch.equal(_bits(got["depth"]), _bits(d))
    assert torch.equal(_bits(got["sad"]), _bits(s))
    assert torch.equal(got["ok"], ok)
    assert torch.equal(got["best"].long(), best)
    assert int((d > 0).sum()) > 40  # matches with depth were held
    again = sad.launch_depth(sad._kernel_lib(), lay, *args[:2], *args[3:],
                             20.0, 250.0)
    assert torch.equal(_bits(again), _bits(out))


def test_stereo_depth_one_launch_and_no_host_wait(dev):
    """stereo_depth and match_stereo: one K5 launch a call, nothing read
    back; the call replays in a CUDA graph with the same bits."""
    args = _depth_inputs(dev, 500)
    sad.stereo_depth(*args, 20.0, 250.0)  # built and loaded
    torch.cuda.synchronize()
    before = sad.LAUNCHES["stereo_sad"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        u, d = sad.stereo_depth(*args, 20.0, 250.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert sad.LAUNCHES["stereo_sad"] == before + 1
    want = sad.stereo_depth_plain(*args, 20.0, 250.0)
    assert torch.equal(_bits(u), _bits(want[0]))
    assert torch.equal(_bits(d), _bits(want[1]))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gu, gd = sad.stereo_depth(*args, 20.0, 250.0)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_bits(gu), _bits(u)) and torch.equal(_bits(gd),
                                                            _bits(d))
    fl, fr, levels, xy, xy_r, bd, bj = args
    ext = OrbExtractor(n_features=500)
    cam = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    world = SyntheticWorld(seed=1)
    R, t = orbit_trajectory(16)[5]
    t_r = np.asarray(t, np.float32) - np.array([0.08, 0, 0], np.float32)
    imgs = [torch.as_tensor(np.clip(world.render(R, tt, **cam)[0], 0,
                                    255).astype(np.uint8)).to(dev)
            for tt in (t, t_r)]
    before = sad.LAUNCHES["stereo_sad"]
    feats, sd = ext.stereo(*imgs, 20.0, 250.0)
    assert sad.LAUNCHES["stereo_sad"] == before + 1
    assert torch.equal(_bits(sd.u_right), _bits(u))
    assert torch.equal(_bits(sd.depth), _bits(d))


def test_stereo_depth_checks_its_arguments(dev):
    fl, fr, levels, xy, xy_r, bd, bj = _depth_inputs(dev, 100)
    with pytest.raises(ValueError, match="xy_l must be torch.float32"):
        sad.stereo_depth(fl, fr, levels, xy.double(), xy_r, bd, bj, 20.0,
                         250.0)
    with pytest.raises(ValueError, match="best_j must be torch.int32"):
        sad.stereo_depth(fl, fr, levels, xy, xy_r, bd, bj.long(), 20.0,
                         250.0)
    with pytest.raises(ValueError, match="best_d must be"):
        sad.stereo_depth(fl, fr, levels, xy, xy_r, bd[1:], bj, 20.0, 250.0)
    with pytest.raises(ValueError, match="xy_r must be"):
        sad.stereo_depth(fl, fr, levels, xy, xy_r[:0], bd, bj, 20.0, 250.0)
    with pytest.raises(ValueError, match="one CUDA device"):
        sad.stereo_depth(fl, fr, levels, xy, xy_r.cpu(), bd, bj, 20.0,
                         250.0)
    with pytest.raises(ValueError, match="packed levels"):
        sad.stereo_depth(fl[:100], fr, levels, xy, xy_r, bd, bj, 20.0,
                         250.0)
    # a level under 11 x 21 takes the kernel (its reads clamped)
    small = orb.level_table(((40, 20),), (3,), (1.0,))
    z = torch.arange(800, dtype=torch.float32, device=dev) % 7
    zi = torch.zeros(3, dtype=torch.int32, device=dev)
    xy3 = torch.tensor([[3.0, 5.0], [10.0, 20.0], [19.0, 39.0]], device=dev)
    args = (z, z, small, xy3, xy3, zi, zi, 20.0, 250.0)
    before = sad.LAUNCHES["stereo_sad"]
    got = sad.stereo_depth(*args)
    assert sad.LAUNCHES["stereo_sad"] == before + 1
    for a, b in zip(got, sad.stereo_depth_plain(*args)):
        assert torch.equal(_bits(a), _bits(b))


BA_CAM = CamParams.of(500.0, 500.0, 320.0, 240.0, 40.0)


def _ba(dev, case="mixed", seed=0, **kw):
    p = ba_problem(case, seed, **kw)
    return ba.BAProblem(*(torch.as_tensor(p[f]).to(dev)
                          for f in ba.BAProblem._fields))


def _damping_after(accepted, lam, accept_all):
    """The damping an accept sequence leads to, as the kernel computes it."""
    lam = np.float32(lam)
    for ok in ([] if accept_all else accepted):
        lam = np.float32(lam * np.float32(0.5 if ok else 5.0))
        lam = min(max(lam, np.float32(1e-9)), np.float32(1e8))
    return float(lam)


def _hold_ba(prob, iters, accept_all=False, init_lambda=1e-4):
    """K4 against ba_solve_plain on the same card: one launch a solve; the
    accept sequence identical wherever chi2 moves by more than 1e-5
    relative (nearer to convergence the two sums of the test are equal
    within their float32 rounding, and either version may decide either
    way); the final damping equal where the sequences are, else the one
    the kernel's own sequence leads to; R, t and X within 1e-4; chi2
    within 1e-3 relative; two solves bit for bit."""
    before = ba.LAUNCHES["ba_solve"]
    got = ba.ba_solve(BA_CAM, prob, iters=iters, accept_all=accept_all,
                      init_lambda=init_lambda)
    assert ba.LAUNCHES["ba_solve"] == before + 1
    ks = ba.KernelSolve(BA_CAM, prob, iters, accept_all=accept_all,
                        init_lambda=init_lambda)
    again = ks.run()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    trace = []
    want = ba.ba_solve_plain(BA_CAM, prob, iters=iters, accept_all=accept_all,
                             init_lambda=init_lambda, trace=trace)
    same = True
    if iters:
        mine, plain = ks.trace.cpu(), torch.stack(trace).cpu()
        moved = (plain[:, 1] / plain[:, 0] - 1).abs() > 1e-5
        assert torch.equal(mine[:, 2][moved], plain[:, 2][moved])
        same = torch.equal(mine[:, 2], plain[:, 2])
        assert float(got.final_lambda) == _damping_after(
            mine[:, 2].tolist(), float(torch.as_tensor(init_lambda)),
            accept_all)
    if same:
        assert float(got.final_lambda) == float(want.final_lambda)
    for f in ("R", "t", "X"):
        err = float((getattr(got, f) - getattr(want, f)).abs().max())
        assert err <= 1e-4, f"{f} differs by {err}"
    assert torch.allclose(got.chi2, want.chi2, rtol=1e-3, atol=1e-6)
    assert torch.allclose(got.obs_chi2, want.obs_chi2, rtol=1e-3, atol=1e-3)
    return got, want


@pytest.mark.parametrize("shape", [(24, 8192, 8), (64, 10000, 8)])
def test_ba_kernels_match_plain(dev, shape):
    """At local BA's shape (16 free poses: the factorization in shared
    memory) and at the most poses (56 free: from global memory); the first
    reduced camera system within 1e-5 of its largest entry; the first
    step, the kernel's float64 solution of its own float64 S, within
    n kappa 2^-52 of torch.linalg.solve of that S (relative, max norm; n
    rows, kappa the 2-norm condition number: the forward error bound of a
    backward stable solve)."""
    P, L, D = shape
    prob = _ba(dev, P=P, L=L, D=D)
    n_free = int((~prob.pose_fixed).sum())
    assert (n_free <= min(P, ba.SHARED_FREE)) == (P == 24)
    S, b_s, chi2 = ba.first_system_plain(BA_CAM, prob)
    ks = ba.KernelSolve(BA_CAM, prob, 5)
    S_k, b_k = ks.assemble()
    scale = float(S.abs().max())
    assert float((S_k - S).abs().max()) <= 1e-5 * scale
    assert float((b_k - b_s).abs().max()) <= 1e-5 * scale
    assert torch.allclose(ks.chi2_old[0], chi2, rtol=1e-5)
    assert torch.equal(ks.S64.float(), S_k)
    ks.run()
    x = torch.linalg.solve(ks.S64, ks.b64)
    bound = 6 * P * float(torch.linalg.cond(ks.S64)) * 2.0 ** -52
    err = float((ks.step0 - x).abs().max()) / float(x.abs().max())
    assert err <= bound, (err, bound)
    _hold_ba(prob, 5)


@pytest.mark.parametrize("case", ["accept_all", "20 iterations", "no step",
                                  "all invalid", "mono", "tensor damping"])
def test_ba_kernels_cases(dev, case):
    if case == "accept_all":
        _hold_ba(_ba(dev, seed=1, P=8, L=4096, n_fixed=1), 8,
                 accept_all=True)
    elif case == "20 iterations":
        # no outliers: over 20 iterations a landmark that an outlier
        # contradicts runs off toward infinity, where float32 and float64
        # solves of the plain version already part by metres
        _hold_ba(_ba(dev, seed=2, P=2, L=500, n_fixed=1, outliers=0.0), 20)
    elif case == "no step":
        _hold_ba(_ba(dev, seed=3, P=12, L=1000, n_fixed=4), 0)
    elif case == "all invalid":
        got, _ = _hold_ba(_ba(dev, "all_invalid", 4, P=12, L=1000), 3)
        assert float(got.chi2) == 0.0
    elif case == "mono":
        _hold_ba(_ba(dev, "mono", 5, P=12, L=2000, D=6, n_fixed=4), 5)
    else:
        _hold_ba(_ba(dev, seed=6, P=24, L=2000), 2,
                 init_lambda=torch.tensor(3e-3, device=dev))


def test_ba_kernel_rejects_a_step_of_a_matrix_not_positive_definite(dev):
    """A negative damping (-1e6) makes S negative definite: the first
    pivot is negative, the factorization gives NaN, the step is not
    finite and is rejected, and the damping becomes what a rejection gives
    (5 lambda, clipped to [1e-9, 1e8]); the state stays as it was, and the
    next iteration, at that damping, takes its step."""
    prob = _ba(dev, seed=7, P=12, L=1000, n_fixed=4)
    lam0 = -1e6
    ks = ba.KernelSolve(BA_CAM, prob, 1, init_lambda=lam0)
    got = ks.run()
    assert not bool(torch.isfinite(ks.step0[:6]).any())
    assert ks.trace[0, 2].item() == 0.0
    assert float(got.final_lambda) == _damping_after([False], lam0, False)
    kept = ba.ba_solve(BA_CAM, prob, iters=0)
    for f in ("R", "t", "X", "chi2", "obs_chi2"):
        assert torch.equal(getattr(got, f), getattr(kept, f)), f
    ks2 = ba.KernelSolve(BA_CAM, prob, 2, init_lambda=lam0)
    ks2.run()
    assert ks2.trace[:, 2].tolist() == [0.0, 1.0]


def test_ba_kernel_accept_tests_part_only_at_float32_ties(dev):
    """The accept test compares the two chi2 sums in float64: every
    decision is the trace's float64 comparison (its fourth column). A
    float32 strict < of the same sums rounded to float32 (the JAX
    package's test is on float32 sums) parts from it only where the two
    round to one float32, a decrease the kernel takes and that test would
    reject: on 20 iterations of a 2-pose problem near convergence it
    does."""
    prob = _ba(dev, seed=2, P=2, L=500, n_fixed=1, outliers=0.0)
    ks = ba.KernelSolve(BA_CAM, prob, 20)
    ks.run()
    tr = ks.trace.cpu()
    assert torch.equal(tr[:, 2], tr[:, 3])
    lower32 = (tr[:, 1] < tr[:, 0]).float()
    part = lower32 != tr[:, 3]
    assert bool(part.any()), "the two tests never part here"
    assert torch.equal(tr[part, 1], tr[part, 0])  # ties in float32
    assert bool((tr[part, 2] == 1.0).all())  # taken in float64


def test_ba_kernel_two_solves_bit_for_bit(dev):
    """Two launches of the whole solve on one problem give the same bits,
    the phase stamps on or off."""
    prob = _ba(dev, seed=8, P=24, L=8192)
    first = ba.KernelSolve(BA_CAM, prob, 5).run()
    timed = ba.KernelSolve(BA_CAM, prob, 5)
    stamps = timed.record_phases()
    second = timed.run()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert bool((stamps.diff() >= 0).all()) and int(stamps[-1]) > 0


def test_ba_kernels_check_their_limits(dev):
    prob = _ba(dev, P=8, L=100, n_fixed=2)
    with pytest.raises(ValueError, match="obs_pose must be int64"):
        ba.ba_solve(BA_CAM, prob._replace(obs_pose=prob.obs_pose.int()))
    with pytest.raises(ValueError, match="one CUDA device"):
        ba.ba_solve(BA_CAM, prob._replace(X=prob.X.cpu()))
    big = _ba(dev, P=65, L=100, n_fixed=2)
    with pytest.raises(ValueError, match="1 to 64 poses"):
        ba.ba_solve(BA_CAM, big)
    # 33 slots: the kernel's wide variant
    _hold_ba(_ba(dev, P=8, L=300, D=33, n_fixed=2, spread=True), 3)


@pytest.mark.parametrize("D", [48, 64])
def test_ba_wide_variant_matches_plain(dev, D):
    """More than 32 observation slots a landmark (MapConfig.d_max), the
    observations spread over all of them: the wide variant's first
    reduced camera system within 1e-5 of its largest entry, then the
    solve held as _hold_ba holds the first variant's."""
    prob = _ba(dev, seed=9, P=24, L=2000, D=D, spread=True)
    assert bool((prob.obs_w[:, 32:] > 0).any())
    S, b_s, _ = ba.first_system_plain(BA_CAM, prob)
    S_k, b_k = ba.KernelSolve(BA_CAM, prob, 5).assemble()
    scale = float(S.abs().max())
    assert float((S_k - S).abs().max()) <= 1e-5 * scale
    assert float((b_k - b_s).abs().max()) <= 1e-5 * scale
    _hold_ba(prob, 5)


def test_bench_runs_on_the_card(dev):
    """The port's bench at BENCH_FRAMES 20: no error, every figure timed by
    CUDA events, and on each figure's timed frames K1 and K3 launch, each
    K2 kernel once a view, K5 once a stereo frame and never elsewhere;
    K4 on the map-building pass (a map built from scratch). (At 12 frames
    the orbit moves about 0.2 m a frame and the monocular bootstrap finds
    too few matches on the card with its random draws.)"""
    out = bench.run(dev, 20)
    assert "error" not in out and "errors" not in out, out
    assert out["value"] > 0
    assert set(out["extra"]) == {*bench.SUB_FIGURES, "passes", "card"}
    passes = out["extra"]["passes"]
    assert set(passes) == {bench.HEADLINE, *bench.SUB_FIGURES}
    for name, p in passes.items():
        assert all(ms > 0 for ms in p["events_ms_per_frame"]), name
        per = p["launches_per_frame"]
        views = 2 if "stereo" in name else 1
        assert per["masked_best_two"] > 0 and per["pose_lm"] > 0, (name, per)
        for k in orb.LAUNCHES:
            assert per[k] == views, (name, k, per)
        assert per["stereo_sad"] == views - 1, (name, per)
    assert passes["map_building_fps"]["launches_per_frame"]["ba_solve"] > 0
