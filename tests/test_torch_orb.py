"""ORB extraction of all levels at once (ops/orb.py, the plain versions of
K2's three kernels) against the JAX package's extractor and against the
port's per-level loop, on the CPU.

Tolerances and their reasons:
- Against the JAX package's ``_extract_from_pyramid`` on the JAX package's
  own level images (the tolerances of tests/test_torch_frontend.py's
  test_level_features_on_same_image): positions, responses, octaves and
  valid flags exact, since FAST, NMS, the selection and the parabola are
  the same float32 operations on the same pixels. Descriptors exact
  wherever the two angles are equal; where they differ by rounding, a
  rotated pattern point that lies within that much of a half flips its
  rounding, so at most 1% of the rows differ, by at most 8 bits (measured:
  one bit of one row of 8000 words at 641x479). IC angles within 1e-5 on level 0, where
  the 961-term moment sums are exact integers, and within 1e-4 on coarser
  levels, whose pixels are not integers and whose sums are added in
  another order (measured below 4.3e-5 on rendered frames) -- wherever the
  moments keep at least 1/1000 of their terms' magnitude. On a flat patch
  or at a symmetric checkerboard junction they cancel and the angle is
  set by rounding in either package: those slots are not held to it.
- Against the port's per-level loop (frontend/extractor.py
  _level_features): every field bit for bit, the same operations in the
  same order.
- The per-kernel plain versions against ops/fast.py and ops/image.py:
  bit for bit.
The CUDA kernels themselves are held against these plain versions on a
card (tests/test_torch_cuda.py, chip_smoke.py phase 3).
"""
import ctypes
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_with_comment_tpu.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu.frontend import OrbExtractor as JaxExtractor
from orb_slam2_with_comment_tpu.ops import image as jimage
from orb_slam2_with_comment_tpu_torch.frontend.extractor import OrbExtractor
from orb_slam2_with_comment_tpu_torch.ops import (
    cuda_lib, fast, image, orb, orientation)

torch.set_num_threads(2)


def _render(w, h, pose=5):
    R, t = orbit_trajectory(16)[pose]
    f = 500.0 * w / 640.0
    img, _ = SyntheticWorld(seed=1).render(R, t, fx=f, fy=f, cx=w / 2,
                                           cy=h / 2, width=w, height=h)
    return np.clip(img, 0, 255).astype(np.uint8)


def _checker(w, h):
    yy, xx = np.mgrid[:h, :w]
    return (((yy // 16) + (xx // 16)) % 2 * 180 + 40).astype(np.uint8)


# name -> (image maker, n_features)
CASES = {
    "320x240-500": (lambda: _render(320, 240), 500),
    "320x240-1000": (lambda: _render(320, 240), 1000),
    "320x240-2000": (lambda: _render(320, 240), 2000),
    "640x480-500": (lambda: _render(640, 480), 500),
    "640x480-1000": (lambda: _render(640, 480), 1000),
    "640x480-2000": (lambda: _render(640, 480), 2000),
    "641x479-1000": (lambda: _render(641, 479), 1000),
    "1241x376-2000": (lambda: _render(1241, 376), 2000),
    "flat-640x480": (lambda: np.full((480, 640), 128, np.uint8), 1000),
    "checker-640x480": (lambda: _checker(640, 480), 1000),
    "640x480-50": (lambda: _render(640, 480), 50),
    # 5 features leave levels 5-7 with a budget of 0
    "640x480-5": (lambda: _render(640, 480), 5),
}
_IMAGES: dict = {}


def _image(name):
    if name not in _IMAGES:
        _IMAGES[name] = CASES[name][0]()
    return _IMAGES[name]


def _levels(pyr, ext):
    return orb.level_table(tuple(tuple(p.shape) for p in pyr),
                           tuple(ext.budgets), tuple(ext.scales))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_chain_matches_jax_per_level(name):
    """extract_levels_plain on the JAX package's level images against the
    JAX extractor's _extract_from_pyramid on the same levels."""
    img = _image(name)
    n = CASES[name][1]
    jpyr = [np.asarray(a) for a in jax.jit(jimage.build_pyramid)(
        jnp.asarray(img, jnp.float32))]
    jx = JaxExtractor(n_features=n)
    want = [np.asarray(a) for a in jax.jit(
        lambda *lv: jx._extract_from_pyramid(list(lv)))(*jpyr)]
    ext = OrbExtractor(n_features=n)
    tpyr = [torch.as_tensor(a.copy()) for a in jpyr]
    levels = _levels(tpyr, ext)
    flat = torch.cat([p.reshape(-1) for p in tpyr])
    got = orb.extract_levels_plain(flat, levels)
    xy, resp, octv, ang, desc, valid = (a.numpy() for a in got)
    np.testing.assert_array_equal(xy, want[0])
    np.testing.assert_array_equal(resp, want[1])
    np.testing.assert_array_equal(octv, want[2])
    np.testing.assert_array_equal(valid, want[5])
    wdesc = want[4].view(np.int32)
    rows = (desc != wdesc).any(1)
    assert not rows[ang == want[3]].any()
    assert rows.sum() <= 0.01 * len(rows)
    bits = np.unpackbits((desc ^ wdesc).view(np.uint8), axis=1).sum(1)
    assert bits.max(initial=0) <= 8
    kept = (orb.moment_cancellation(flat, orb.select_plain(
        *orb.cells_plain(flat, levels)[2:], levels)[0], levels)
        >= 1e-3).numpy()
    dang = np.abs(ang - want[3])
    level0 = octv == 0
    assert dang[level0 & kept].max(initial=0) <= 1e-5
    assert dang[kept].max(initial=0) <= 1e-4


# configurations beyond the kernels' old or current limits: name ->
# (image maker, OrbExtractor keywords); both packages take each on the CPU
BEYOND = {
    # the smallest frame above the former 2048-cell limit: 34 x 61 cells
    "1081x1921-1000": (lambda: _render(1921, 1081), {}),
    "640x480-cell16": (lambda: _render(640, 480), {"cell": 16}),
    "640x480-per_cell4": (lambda: _render(640, 480), {"per_cell": 4}),
    "640x480-17-levels": (lambda: _render(640, 480), {"n_levels": 17}),
}


@pytest.mark.parametrize("name", sorted(BEYOND))
def test_extractor_matches_jax_beyond_the_kernels_limits(name):
    """The port's OrbExtractor._extract_from_pyramid (the plain chain, or
    level by level where the kernels do not take the configuration) on
    the JAX package's level images against the JAX extractor's, at
    test_plain_chain_matches_jax_per_level's tolerances."""
    make, kw = BEYOND[name]
    img = make()
    jx = JaxExtractor(n_features=1000, **kw)
    jpyr = [np.asarray(a) for a in jax.jit(
        lambda x: jimage.build_pyramid(x, jx.n_levels))(
        jnp.asarray(img, jnp.float32))]
    want = [np.asarray(a) for a in jax.jit(
        lambda *lv: jx._extract_from_pyramid(list(lv)))(*jpyr)]
    ext = OrbExtractor(n_features=1000, **kw)
    tpyr = [torch.as_tensor(a.copy()) for a in jpyr]
    got = ext._extract_from_pyramid(tpyr)
    assert got.n == 1000
    xy, resp, octv, ang, desc, valid = (a.numpy() for a in got)
    np.testing.assert_array_equal(xy, want[0])
    np.testing.assert_array_equal(resp, want[1])
    np.testing.assert_array_equal(octv, want[2])
    np.testing.assert_array_equal(valid, want[5])
    assert valid.sum() > 500
    wdesc = want[4].view(np.int32)
    rows = (desc != wdesc).any(1)
    assert not rows[ang == want[3]].any()
    assert rows.sum() <= 0.01 * len(rows)
    bits = np.unpackbits((desc ^ wdesc).view(np.uint8), axis=1).sum(1)
    assert bits.max(initial=0) <= 8
    levels = _levels(tpyr, ext)
    flat = torch.cat([p.reshape(-1) for p in tpyr])
    yx = torch.cat([fast.select_keypoints(
        orb.masked_score(tpyr[lv.lvl], ext.margin), lv.budget, ext.cell,
        ext.per_cell)[0] for lv in levels])
    kept = (orb.moment_cancellation(flat, yx, levels) >= 1e-3).numpy()
    dang = np.abs(ang - want[3])
    level0 = octv == 0
    assert dang[level0 & kept].max(initial=0) <= 1e-5
    assert dang[kept].max(initial=0) <= 1e-4


def test_sigma2_lists_match_jax():
    for kw in ({}, {"n_levels": 17}, {"scale_factor": 1.3}):
        jx, ext = JaxExtractor(**kw), OrbExtractor(**kw)
        assert ext.sigma2 == jx.sigma2
        assert ext.inv_sigma2 == jx.inv_sigma2


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_chain_equals_the_per_level_loop(name):
    """OrbExtractor (ops/orb.py's plain chain on the CPU) against the
    port's _level_features loop, bit for bit on every field."""
    ext = OrbExtractor(n_features=CASES[name][1])
    img = torch.as_tensor(_image(name))
    pyr = ext._pyramid(img)
    parts = [ext._level_features(p, lvl, b)
             for lvl, (p, b) in enumerate(zip(pyr, ext.budgets)) if b > 0]
    want = [torch.cat(p) for p in zip(*parts)]
    got = ext(img)
    assert got.n == sum(b for b in ext.budgets if b > 0)
    for field, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert torch.equal(a, b), field


@pytest.mark.parametrize("name", ["640x480-1000", "641x479-1000",
                                  "checker-640x480", "640x480-5"])
def test_cells_and_select_plain_match_the_per_level_ops(name):
    """cells_plain's score, blur and candidates and select_plain's slots
    against fast.fast_score_map, image.gaussian_blur and
    fast.select_keypoints level by level, bit for bit."""
    ext = OrbExtractor(n_features=CASES[name][1])
    pyr = ext._pyramid(torch.as_tensor(_image(name)))
    levels = _levels(pyr, ext)
    flat = torch.cat([p.reshape(-1) for p in pyr])
    score, blurred, cand_v, cand_i = orb.cells_plain(flat, levels)
    yx, resp, valid = orb.select_plain(cand_v, cand_i, levels)
    assert cand_v.shape == cand_i.shape == (orb.n_cells(levels), 8)
    assert [lv.lvl for lv in levels] == [
        i for i, b in enumerate(ext.budgets) if b > 0]
    for lv in levels:
        img = pyr[lv.lvl]
        h, w = img.shape
        s = fast.fast_score_map(img)
        inner = torch.zeros_like(s)
        inner[16:h - 16, 16:w - 16] = s[16:h - 16, 16:w - 16]
        assert torch.equal(orb._view(score, lv), inner)
        assert torch.equal(orb._view(blurred, lv),
                           torch.round(image.gaussian_blur(img)))
        want = fast.select_keypoints(inner, lv.budget, 32, 8)
        cut = slice(lv.slot, lv.slot + lv.budget)
        for a, b in zip((yx[cut], resp[cut], valid[cut]), want):
            assert torch.equal(a, b)


def test_selection_key_ties_break_by_flat_index():
    """Near 1e7 the float32 key steps by 1: rank-1 candidates whose values
    round to the same key tie, and the lower flat index (cell, rank) comes
    first, not the larger value."""
    top_v = torch.tensor([[[30.0, 9.0], [25.0, 9.25]]])  # [cy 1, cx 2, 2]
    top_i = torch.tensor([[[0, 1], [2, 3]]], dtype=torch.int32)
    yx, resp, _ = fast.select_from_candidates(top_v, top_i, 4, cell=32)
    assert resp.tolist() == [30.0, 25.0, 9.0, 9.25]
    assert yx[:, 1].tolist() == [0, 34, 1, 35]


def test_resize_weights_are_cached_bit_for_bit():
    image._WEIGHTS.clear()
    fresh = image.resize_weights(480, 400, torch.device("cpu"))
    got = image.cached_resize_weights(480, 400, "cpu")
    assert torch.equal(got, fresh)
    assert image.cached_resize_weights(480, 400, torch.device("cpu")) is got
    image.build_pyramid(torch.zeros((480, 640)))
    image.build_pyramid(torch.zeros((480, 640)))
    sizes = image.level_sizes(480, 640)
    want = {(a[i], b[i], torch.device("cpu")) for a, b in zip(sizes, sizes[1:])
            for i in (0, 1)}
    assert set(image._WEIGHTS) == want | {(480, 400, torch.device("cpu"))}
    for (n_in, n_out, dev), w in image._WEIGHTS.items():
        assert torch.equal(w, image.resize_weights(n_in, n_out, dev))


def _pyr(ext, name="640x480-1000"):
    return ext._pyramid(torch.as_tensor(_image(name)))


def test_cpu_takes_the_plain_chain_and_counts_no_launch():
    ext = OrbExtractor(n_features=1000)
    pyr = _pyr(ext)
    before = dict(orb.LAUNCHES)
    got = orb.extract_levels(pyr, ext.budgets, ext.scales)
    levels = _levels(pyr, ext)
    flat = torch.cat([p.reshape(-1) for p in pyr])
    parts = orb.cells(flat, levels)
    orb.select(*parts[2:], levels)
    orb.describe(flat, parts[0], parts[1],
                 orb.select_plain(*parts[2:], levels)[0], levels)
    assert orb.LAUNCHES == before
    for a, b in zip(got, orb.extract_levels_plain(flat, levels)):
        assert torch.equal(a, b)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    ext = OrbExtractor(n_features=1000)
    pyr = _pyr(ext)
    levels = _levels(pyr, ext)
    flat = torch.cat([p.reshape(-1) for p in pyr])
    with pytest.raises(ValueError):  # a device that is not CUDA
        orb.extract_levels([p.to("meta") for p in pyr], ext.budgets,
                           ext.scales)
    with pytest.raises(ValueError):  # levels on two devices
        orb.extract_levels([pyr[0].to("meta"), *pyr[1:]], ext.budgets,
                           ext.scales)
    with pytest.raises(ValueError):  # float64 levels
        orb.extract_levels([p.double() for p in pyr], ext.budgets,
                           ext.scales)
    with pytest.raises(ValueError):
        orb.cells(flat.double(), levels)
    with pytest.raises(ValueError):
        orb.cells(flat[:100], levels)
    score, blurred, cand_v, cand_i = orb.cells_plain(flat, levels)
    with pytest.raises(ValueError):
        orb.select(cand_v, cand_i.long(), levels)
    with pytest.raises(ValueError):
        orb.select(cand_v[1:], cand_i[1:], levels)
    with pytest.raises(ValueError):
        orb.select(cand_v.to("meta"), cand_i, levels)
    yx = orb.select_plain(cand_v, cand_i, levels)[0]
    with pytest.raises(ValueError):
        orb.describe(flat, score, blurred, yx.long(), levels)
    with pytest.raises(ValueError):
        orb.describe(flat, score.to("meta"), blurred, yx, levels)
    # frame size is not limited; the kernels' own limits (16 levels with
    # a budget, MAX_BUDGET slots a level) raise on the card only
    big = orb.level_table(((1081, 1921),), (100,), (1.0,))
    assert big[0].cy * big[0].cx == 34 * 61
    got = orb.extract_levels([torch.zeros((1081, 1921))], [100], [1.0])
    assert got[0].shape == (100, 2) and not got[5].any()
    many = orb.level_table(((64, 64),) * 17, (1,) * 17, (1.0,) * 17)
    assert len(many) == 17
    with pytest.raises(ValueError, match="16 levels"):
        orb.check_kernel_limits(many)
    with pytest.raises(ValueError, match=str(orb.MAX_BUDGET)):
        orb.check_kernel_limits(orb.level_table(
            ((4096, 4096),), (orb.MAX_BUDGET + 1,), (1.0,)))
    orb.check_kernel_limits(orb.level_table(((4096, 4096),),
                                            (orb.MAX_BUDGET,), (1.0,)))
    with pytest.raises(ValueError, match="per_cell=4"):
        OrbExtractor(n_features=100, per_cell=4)._extract_from_pyramid(
            [p.to("meta") for p in pyr])
    with pytest.raises(ValueError, match="n_levels=17"):
        OrbExtractor(n_features=100, n_levels=17)._extract_from_pyramid(
            [p.to("meta") for p in pyr])


class _FakeFn:
    """Takes the argtypes and restype a ctypes function would."""


def _source():
    with open(os.path.join(cuda_lib.CSRC_DIR, "orb.cu")) as f:
        return f.read()


def test_binding_matches_the_extern_c_interface():
    """The symbols the wrapper binds are orb.cu's extern "C" functions with
    the same parameter types in the same order."""
    src = _source()
    extern = src[src.index('extern "C" {'):]
    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p}

    class Lib:
        orb_table_bytes = _FakeFn()
        orb_cells = _FakeFn()
        orb_select = _FakeFn()
        orb_describe = _FakeFn()

    lib = orb._bind(Lib())
    for fn in ("orb_cells", "orb_select", "orb_describe"):
        m = re.search(rf"int {fn}\(([^)]*)\)", extern)
        assert m, fn
        params = [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]
        assert getattr(lib, fn).argtypes == [c_types[p] for p in params], fn
        assert getattr(lib, fn).restype is ctypes.c_int
    assert re.search(r"int orb_table_bytes\(\)", extern)


def _c_fields(src, struct):
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in body.split(";"):
        words = decl.replace(",", " , ").split()
        if not words:
            continue
        ctype = words[0]
        for name in " ".join(words[1:]).split(","):
            name = name.strip()
            m = re.match(r"(\w+)\[(\w+)( \+ 1)?\]", name)
            out.append((ctype, m.group(1) if m else name))
    return out


def test_table_layout_matches_the_source():
    """_LevelDesc and _OrbTable have orb.cu's fields in its order, and the
    source's limits and FAST ring are the wrapper's."""
    src = _source()
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    for struct, mirror in (("LevelDesc", orb._LevelDesc),
                           ("OrbTable", orb._OrbTable)):
        fields = _c_fields(src, struct)
        assert [n for _, n in fields] == [f[0] for f in mirror._fields_]
        for (ctype, _), (_, ptype) in zip(fields, mirror._fields_):
            base = (ptype._type_ if issubclass(ptype, ctypes.Array)
                    else ptype)
            if ctype in kinds:
                assert base is kinds[ctype], struct
    for const, value in (("kCell", orb.CELL), ("kPerCell", orb.PER_CELL),
                         ("kMaxLevels", orb.MAX_LEVELS),
                         ("kMaxBudget", orb.MAX_BUDGET),
                         ("kHalfPatch", orientation.HALF_PATCH)):
        assert int(re.search(rf"{const} = (\d+);", src).group(1)) == value
    ring = [[int(v) for v in re.search(
        rf"{name}\[16\] = \{{([^}}]*)\}}", src).group(1).split(",")]
        for name in ("kRingDy", "kRingDx")]
    assert list(zip(*ring)) == list(fast.CIRCLE)
    table = orb._table(_levels(_pyr(OrbExtractor(n_features=1000)),
                               OrbExtractor(n_features=1000)))
    assert list(table.gauss) == image.gaussian_kernel1d(7, 2.0).tolist()
    assert list(table.umax) == orientation.UMAX.tolist()
    assert table.n_slots == 1000 and table.n_levels == 8
