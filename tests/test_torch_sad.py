"""K5, the stereo match after the association (ops/sad.py), on the CPU:
``sad_refine_plain`` for all levels in one call against the JAX package's
``_sad_refine_block`` level by level, on the same numpy pyramids,
keypoints and coarse right u; ``stereo_tail_plain`` against a
transcription of the JAX package's tail (frontend/stereo.py:141-161) in
jax.numpy, u_right and depth bit for bit, on synthetic refinement outputs
(a disparity <= 0 and >= fx, no good keypoint, one, an even and an odd
count, ties at the median); ``stereo_depth`` on CPU tensors against
match_stereo's tail as it was written before ops/sad.py held it, and its
argument checks; the level layout's cache.

Cases: an orbit frame at 640x480 with 1000 features (SyntheticWorld's
pair at the bench's 8 cm baseline; the keypoints and coarse right u of the
port's extractor and stereo association, as the main path gives them);
then seeded sums of sinusoids rounded to grey levels, the right view the
left one shifted by a subpixel disparity, with keypoints drawn near the
true match, at the KITTI 00-02 shape (1241x376) with 2000 features, an
odd size (641x479), keypoints whose window or strip meets or leaves the
image edge, levels of budget 0 (5 features), and exact ties of the SADs
(a horizontal period of 4 px on integer level-0 pixels, where every order
of the sums gives the same values and the first minimum must win).

Tolerance, as tests/test_torch_stereo.py holds the per-level function:
``ok`` identical, the best SAD within 1e-3 relative, the refined right u
within 1e-3 px where ok. The tail is held in bits: the same float32
operations on the same inputs. The 121-term float32 sums of the non-integer
pixels of levels >= 1 are added in another order than the JAX package's
one-hot products.
"""
import ctypes

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_with_comment_tpu.frontend import stereo as jstereo
from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu_torch.frontend import stereo
from orb_slam2_with_comment_tpu_torch.frontend.extractor import (
    OrbExtractor, level_budgets)
from orb_slam2_with_comment_tpu_torch.ops import image, orb, sad

torch.set_num_threads(2)
DISPARITY = 7.3  # level-0 px


def _texture(rng, h, w, shift):
    """Grey levels of a sum of sinusoids at (x + shift, y)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    x = x + shift
    img = np.full((h, w), 128.0)
    for _ in range(12):
        fx, fy = rng.uniform(0.05, 0.6, 2) * rng.choice([-1, 1], 2)
        img += rng.uniform(6, 14) * np.sin(fx * x + fy * y
                                            + rng.uniform(0, 6.3))
    return np.clip(np.round(img), 0, 255).astype(np.float32)


def _pair(seed, h, w, period=None):
    """(left, right) float32 grey images; the right view sees the left one's
    pixel x at x - DISPARITY. ``period``: columns repeating every
    ``period`` px instead (exact ties of the SADs)."""
    if period is not None:
        row = np.float32([0, 60, 120, 60])[np.arange(w) % period]
        img = np.broadcast_to(row, (h, w)).copy()
        return img, np.roll(img, -7, axis=1)
    rng = np.random.RandomState(seed)
    left = _texture(rng, h, w, 0.0)
    rng = np.random.RandomState(seed)
    return left, _texture(rng, h, w, DISPARITY)


def _keypoints(rng, levels, w0, h0, edge=False):
    """xy [N, 2] in level-0 px inside each level's image, and the coarse
    right u [N] near the true match; with ``edge`` a third of them on the
    image's border band and some coarse u off either side."""
    xy, u0 = [], []
    for lv in levels:
        s = lv.scale
        x = rng.uniform(0, max(lv.w - 1, 0), lv.budget) * s
        y = rng.uniform(0, max(lv.h - 1, 0), lv.budget) * s
        u = x - DISPARITY + rng.uniform(-1.5, 1.5, lv.budget) * s
        if edge:
            k = lv.budget // 3
            x[:k] = rng.choice([0.0, 2.0 * s, (lv.w - 3) * s], k)
            y[:k] = rng.choice([1.0 * s, (lv.h - 2) * s], k)
            u[:k] = x[:k] - DISPARITY
            u[k:2 * k] = rng.choice([-3.0 * s, 4.0 * s, (lv.w + 2) * s], k)
        xy.append(np.stack([x, y], 1))
        u0.append(u)
    return (np.concatenate(xy).astype(np.float32),
            np.concatenate(u0).astype(np.float32))


def _jax_levels(pyr_l, pyr_r, levels, xy, u0):
    """The JAX package's per-level function over each level's slots."""
    out = []
    for lv in levels:
        sl = slice(lv.slot, lv.slot + lv.budget)
        fn = jax.jit(lambda pl, pr, p, u, inv=1.0 / lv.scale:
                     jstereo._sad_refine_block(pl, pr, inv, p, u))
        ju, jsad, jok = fn(jnp.asarray(pyr_l[lv.lvl]),
                           jnp.asarray(pyr_r[lv.lvl]), jnp.asarray(xy[sl]),
                           jnp.asarray(u0[sl]))
        out.append((np.asarray(ju) * np.float32(lv.scale), np.asarray(jsad),
                    np.asarray(jok)))
    return [np.concatenate(a) for a in zip(*out)]


def _orbit_inputs():
    """Orbit frame 5 and its right view at 8 cm: the packed pyramids, the
    level table, the left keypoints and the coarse right u of the stereo
    association, from the port's extractor on the CPU."""
    R, t = orbit_trajectory(16)[5]
    world = SyntheticWorld(seed=1)
    views = [np.clip(world.render(R, tt)[0], 0, 255).astype(np.uint8)
             for tt in (t, np.asarray(t, np.float32)
                        - np.float32([0.08, 0, 0]))]
    ext = OrbExtractor(n_features=1000)
    pyr = [ext._pyramid(torch.as_tensor(v)) for v in views]
    fl, fr = (ext._extract_from_pyramid(p) for p in pyr)
    mask = stereo.association_mask(fl, fr, ext.scales, 500.0)
    _, best_j, _, _ = stereo.hamming.masked_best_two(fl.desc, fr.desc, mask)
    levels = orb.level_table(tuple(tuple(p.shape) for p in pyr[0]),
                             tuple(ext.budgets), tuple(ext.scales))
    return pyr, levels, fl.xy.numpy(), fr.xy[best_j.long(), 0].numpy()


CASES = {
    "orbit frame, 640x480, 1000": (None, 480, 640, 1000, False, None),
    "kitti 1241x376, 2000": (1, 376, 1241, 2000, False, None),
    "odd 641x479, 1000": (2, 479, 641, 1000, False, None),
    "edges 640x480, 1000": (3, 480, 640, 1000, True, None),
    "budget 0, 5": (4, 480, 640, 5, False, None),
    "ties 320x240, 500": (5, 240, 320, 500, False, 4),
    # 24 levels: from level 14 (9 x 12) on under 11 rows, from level 11
    # under 21 columns; their reads are clamped to the level
    "24 levels 160x120, 600": (6, 120, 160, 600, False, None, 24),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sad_refine_plain_matches_jax_per_level(case):
    seed, h, w, n_feat, edge, period, *n_levels = CASES[case]
    budgets = level_budgets(n_feat, *n_levels)
    if seed is None:
        pyr, levels, xy, u0 = _orbit_inputs()
    else:
        left, right = _pair(seed, h, w, period)
        pyr = [image.build_pyramid(torch.as_tensor(im), len(budgets))
               for im in (left, right)]
        levels = orb.level_table(
            tuple(tuple(p.shape) for p in pyr[0]), tuple(budgets),
            tuple(image.level_scales(len(budgets))))
        xy, u0 = _keypoints(np.random.RandomState(100 + seed), levels, w, h,
                            edge)
    assert sum(lv.budget for lv in levels) == n_feat
    tu, tsad, tok = (a.numpy() for a in sad.sad_refine_plain(
        orb.pack(pyr[0]), orb.pack(pyr[1]), levels, torch.as_tensor(xy),
        torch.as_tensor(u0)))
    ju, jsad, jok = _jax_levels([p.numpy() for p in pyr[0]],
                                [p.numpy() for p in pyr[1]], levels, xy, u0)
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_allclose(tsad, jsad, rtol=1e-3, atol=0)
    np.testing.assert_allclose(tu[jok], ju[jok], rtol=0, atol=1e-3)
    if period is not None:
        # every SAD curve of the periodic pair has equal minima 4 shifts
        # apart: the first one wins, in both packages
        assert tsad.min() == 0.0 and int(jok.sum()) > 0
    elif edge:
        assert 0 < int(jok.sum()) < n_feat * 0.8
    else:
        # the orbit frame's unmatched and invalid slots refine too, mostly
        # to no vertex within one pixel
        assert int(jok.sum()) > (0.3 if seed is None else 0.5) * n_feat
    if case == "budget 0, 5":
        assert len(levels) < len(budgets)
    if n_levels:
        small = [lv for lv in levels if lv.h < sad.PATCH]
        assert len(levels) == 24 and len(small) >= 8
        cut = slice(small[0].slot, None)
        assert np.isfinite(tsad[cut]).all() and tsad[cut].max() > 0


def test_sad_refine_wrapper_takes_plain_on_cpu_and_checks():
    left, right = _pair(7, 120, 160)
    budgets = level_budgets(200, 4)
    pyr = [image.build_pyramid(torch.as_tensor(im), 4) for im in (left,
                                                                  right)]
    levels = orb.level_table(tuple(tuple(p.shape) for p in pyr[0]),
                             tuple(budgets),
                             tuple(image.level_scales(4)))
    xy, u0 = (torch.as_tensor(a) for a in _keypoints(
        np.random.RandomState(7), levels, 160, 120))
    flat_l, flat_r = orb.pack(pyr[0]), orb.pack(pyr[1])
    before = dict(sad.LAUNCHES)
    got = sad.sad_refine(flat_l, flat_r, levels, xy, u0)
    want = sad.sad_refine_plain(flat_l, flat_r, levels, xy, u0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert sad.LAUNCHES == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="float32"):
        sad.sad_refine(flat_l, flat_r, levels, xy.double(), u0)
    with pytest.raises(ValueError, match="float32"):
        sad.sad_refine(flat_l.double(), flat_r, levels, xy, u0)
    with pytest.raises(ValueError, match="expected xy_l"):
        sad.sad_refine(flat_l, flat_r, levels, xy[1:], u0[1:])
    with pytest.raises(ValueError, match="packed levels"):
        sad.sad_refine(flat_l[:100], flat_r, levels, xy, u0)


def test_sad_table_limits():
    """The kernel's table takes any level count and size, as the plain
    version does: a level under 11 rows or 21 columns (the kernel's clamped
    reads), more than 16 levels (their copy in device memory)."""
    small = orb.level_table(((40, 20),), (3,), (1.0,))
    t = sad._table(small)
    assert (t.n_levels, t.lv[0].h, t.lv[0].w) == (1, 40, 20)
    assert not t.levels and not t.host_levels
    many = orb.level_table(((40, 40),) * 17, (1,) * 17, (1.0,) * 17)
    lay = sad.layout(many)
    assert lay.table.n_levels == 17 and lay.table.host_levels
    assert lay.for_device(torch.device("cpu")) == lay.address
    assert lay.table.levels == lay.device_levels[
        torch.device("cpu")].data_ptr()
    assert bytes(lay.device_levels[torch.device("cpu")].numpy()) == bytes(
        lay.table.keep)
    t = sad._table(orb.level_table(((480, 640), (400, 533)), (600, 400),
                                   (1.0, 1.2)))
    assert (t.n_levels, t.n_slots) == (2, 1000)
    assert t.lv[1].slot == 600 and t.lv[1].off == 480 * 640
    assert t.lv[1].inv == np.float32(1 / 1.2)
    assert t.lv[1].scale == np.float32(1.2)


def _jax_tail(u_right, sad_best, ok_all, best_d, x_l, bf, fx: float):
    """The JAX package's tail of match_stereo (frontend/stereo.py:141-161),
    transcribed: the refinement's outputs in, (u_out, depth) out."""
    n = u_right.shape[0]
    matched = best_d < jstereo.TH_ORB
    good = matched & ok_all
    disparity = x_l - u_right
    tiny = disparity <= 0
    disparity = jnp.where(tiny, 0.01, disparity)
    u_right = jnp.where(tiny, x_l - 0.01, u_right)
    good &= disparity < fx
    sad_sorted = jnp.sort(jnp.where(good, sad_best, jnp.inf))
    n_good = jnp.sum(good)
    med = sad_sorted[jnp.clip(n_good // 2, 0, n - 1)]
    th = 1.5 * 1.4 * med
    good &= sad_best <= th
    depth = jnp.where(good, bf / disparity, -1.0)
    u_out = jnp.where(good, u_right, -1.0)
    return u_out, depth


FX, BF = 500.0, np.float32(40.0)


def _tail_inputs(case, n=400):
    """Synthetic refinement outputs (u_right, SAD, ok, best_d, x_l) for one
    case of TAIL_CASES, from a seed."""
    rng = np.random.RandomState(list(TAIL_CASES).index(case))
    x_l = rng.uniform(0, 640, n).astype(np.float32)
    u = (x_l - rng.uniform(0.3, 120, n)).astype(np.float32)
    sad_best = rng.uniform(20, 3000, n).astype(np.float32)
    ok = rng.uniform(size=n) < 0.8
    best_d = rng.randint(0, 120, n).astype(np.int32)
    if case == "disparity <= 0":
        k = n // 4
        u[:k] = x_l[:k] + rng.uniform(0, 3, k).astype(np.float32)
        u[k:k + 8] = x_l[k:k + 8]  # exactly 0
        best_d[:k + 8] = 10
        ok[:k + 8] = True
    elif case == "disparity >= fx":
        k = n // 4
        u[:k] = x_l[:k] - rng.uniform(FX, FX + 200, k).astype(np.float32)
        best_d[:k] = 10
        ok[:k] = True
    elif case == "no good keypoint":
        best_d[:] = rng.randint(75, 200, n)
    elif case in ("one good keypoint", "even good count", "odd good count"):
        count = {"one good keypoint": 1, "even good count": 120,
                 "odd good count": 121}[case]
        best_d[:] = 90
        pick = rng.choice(n, count, replace=False)
        best_d[pick] = 3
        ok[pick] = True
    elif case == "ties at the median":
        sad_best = (np.round(sad_best / 400) * 400 + 17.25).astype(
            np.float32)
    return u, sad_best, ok, best_d, x_l


TAIL_CASES = {
    "random": None, "disparity <= 0": None, "disparity >= fx": None,
    "no good keypoint": 0, "one good keypoint": 1, "even good count": 120,
    "odd good count": 121, "ties at the median": None,
}


@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_stereo_tail_matches_jax_in_bits(case):
    """u_right and depth of stereo_tail_plain are the JAX package's tail's
    bits; the depth is one IEEE division, as the JAX package's bf /
    disparity is (a Python float over a tensor would be
    disparity.reciprocal() * bf, which rounds twice)."""
    u, s, ok, bd, x_l = _tail_inputs(case)
    got = [a.numpy() for a in sad.stereo_tail_plain(
        *(torch.as_tensor(a) for a in (u, s, ok, bd, x_l)), float(BF), FX)]
    fn = jax.jit(lambda *a: _jax_tail(*a, FX))
    want = [np.asarray(a) for a in fn(u, s, ok, bd, x_l, jnp.float32(BF))]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    # what each case is about holds on these inputs
    disparity = np.where(x_l - u <= 0, np.float32(0.01), x_l - u)
    good = (bd < 75) & ok & (disparity < np.float32(FX))
    n_good = int(good.sum())
    with_depth = got[1] > 0
    if TAIL_CASES[case] is not None:
        assert n_good == TAIL_CASES[case]
    if case == "no good keypoint":
        assert not with_depth.any()
    elif case == "disparity <= 0":
        tiny = (x_l - u <= 0) & with_depth
        assert tiny.sum() > 10 and (got[0][tiny] == x_l[tiny]
                                    - np.float32(0.01)).all()
    elif case == "disparity >= fx":
        assert ((x_l - u >= FX) & (bd < 75) & ok).sum() > 50
        assert not with_depth[(x_l - u >= FX)].any()
    elif case == "ties at the median":
        med = np.sort(s[good])[n_good // 2]
        assert (s[good] == med).sum() > 5
        assert (with_depth == good & (s <= med * np.float32(2.1))).all()
    elif case == "random":
        # the data tells the division apart from a reciprocal and a product
        recip = (torch.as_tensor(disparity).reciprocal() * float(BF)).numpy()
        assert (recip.view(np.int32) != (BF / disparity).view(
            np.int32)).sum() > 10
    if n_good:
        assert 0 < with_depth.sum() <= n_good


def _orbit_depth_inputs():
    """Orbit frame 5 and its right view at 8 cm through the port's
    extractor and stereo association on the CPU: stereo_depth's inputs."""
    R, t = orbit_trajectory(16)[5]
    world = SyntheticWorld(seed=1)
    views = [np.clip(world.render(R, tt)[0], 0, 255).astype(np.uint8)
             for tt in (t, np.asarray(t, np.float32)
                        - np.float32([0.08, 0, 0]))]
    ext = OrbExtractor(n_features=1000)
    pyr = [ext._pyramid(torch.as_tensor(v)) for v in views]
    fl, fr = (ext._extract_from_pyramid(p) for p in pyr)
    mask = stereo.association_mask(fl, fr, ext.scales, 500.0)
    best_d, best_j, _, _ = stereo.hamming.masked_best_two(fl.desc, fr.desc,
                                                          mask)
    levels = orb.level_table(tuple(tuple(p.shape) for p in pyr[0]),
                             tuple(ext.budgets), tuple(ext.scales))
    return (orb.pack(pyr[0]), orb.pack(pyr[1]), levels, fl.xy, fr.xy,
            best_d, best_j)


def _former_tail(flat_l, flat_r, levels, xy_l, xy_r, best_d, best_j, bf,
                 fx):
    """match_stereo from K1's outputs on, as frontend/stereo.py wrote it
    before ops/sad.py held the tail (with the depth's one division)."""
    matched = best_d < stereo.TH_ORB
    u_r0 = xy_r[best_j.long(), 0]
    u_right, sad_best, ok_all = sad.sad_refine_plain(flat_l, flat_r, levels,
                                                     xy_l, u_r0)
    n = u_right.shape[0]
    good = matched & ok_all
    disparity = xy_l[:, 0] - u_right
    tiny = disparity <= 0
    disparity = torch.where(tiny, 0.01, disparity)
    u_right = torch.where(tiny, xy_l[:, 0] - 0.01, u_right)
    good = good & (disparity < fx)
    inf = float("inf")
    sad_sorted = torch.sort(torch.where(good, sad_best, inf)).values
    med = sad_sorted[(good.sum() // 2).clamp(0, n - 1)]
    good = good & (sad_best <= 1.5 * 1.4 * med)
    return (torch.where(good, u_right, -1.0),
            torch.where(good, torch.div(torch.tensor(bf), disparity), -1.0))


def test_stereo_depth_takes_plain_on_cpu_and_checks():
    """stereo_depth on CPU tensors is the plain version, launches nothing,
    and gives match_stereo's former tail's bits on the rendered orbit
    pair; it raises on a wrong type or shape and on mixed devices."""
    args = _orbit_depth_inputs()
    bf, fx = sad._f32(40.0), sad._f32(500.0)
    before = dict(sad.LAUNCHES)
    got = sad.stereo_depth(*args, bf, fx)
    assert sad.LAUNCHES == before
    want = _former_tail(*args, bf, fx)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int((got[1] > 0).sum()) > 300
    fl, fr, levels, xy, xy_r, bd, bj = args
    bad = {
        "xy_l must be torch.float32": (fl, fr, levels, xy.double(), xy_r, bd,
                                       bj),
        "best_d must be torch.int32": (fl, fr, levels, xy, xy_r, bd.long(),
                                       bj),
        "best_j must be torch.int32": (fl, fr, levels, xy, xy_r, bd, bj[1:]),
        "xy_r must be": (fl, fr, levels, xy, xy_r[:, :1], bd, bj),
        "flat_r must be float32": (fl, fr.double(), levels, xy, xy_r, bd,
                                   bj),
        "flat_l must be the packed levels": (fl[:100], fr, levels, xy, xy_r,
                                             bd, bj),
        "one CUDA device": (fl, fr, levels, xy, xy_r.to("meta"), bd, bj),
    }
    for match, call in bad.items():
        with pytest.raises(ValueError, match=match):
            sad.stereo_depth(*call, bf, fx)


def test_sad_layout_cache():
    """A level layout's table is built once per levels tuple and holds what
    a fresh table holds; a list of the same levels gives the same."""
    levels = orb.level_table(((480, 640), (400, 533), (333, 444)),
                             (400, 350, 250), (1.0, 1.2, 1.44))
    lay = sad.layout(levels)
    assert sad.layout(levels) is lay and lay.levels is levels
    assert (lay.n, lay.size) == (1000, 480 * 640 + 400 * 533 + 333 * 444)
    fresh = sad._table(levels)
    assert bytes(lay.table) == bytes(fresh)
    assert lay.address == ctypes.addressof(lay.table)
    again = sad.layout(list(levels))
    assert bytes(again.table) == bytes(fresh) and again.n == lay.n
    small = orb.level_table(((40, 20),), (3,), (1.0,))
    lay_small = sad.layout(small)
    assert lay_small.table.n_levels == 1
    assert lay_small.n == 3 and lay_small.size == 800
