"""The real-sequence I/O of the PyTorch port against PIL and the JAX
package's, on the CPU; every comparison is exact.

- The port's PNG codec (dataio/png.py) against PIL: 8-bit gray, 16-bit
  gray, RGB, RGBA, gray + alpha and palette images (with and without a
  tRNS chunk) made from a numpy seed, each written by a test-local encoder
  that applies one filter type to every row (and once all five in turn);
  what it refuses; ``write_png`` round trips and PIL reads it alike.
- The gray conversion of the readers against the JAX package's PIL path
  (``convert("L")``: integer luma) for every kind of image.
- ``load_tum_list`` and ``associate_tum`` (tests/test_system_dataio.py's
  greedy case and a nonzero offset) against the JAX functions.
- ``TumRgbdDataset`` (with and without an associations file),
  ``TumMonoDataset``, ``KittiDataset`` and ``EurocDataset`` yield what the
  JAX package's yield, on fixtures written by the repository's
  scripts/make_fixture_dataset.py; ``prefetch()`` (both native libraries
  built here with g++ and libpng) yields what the JAX ``prefetch()``
  yields, also on color PNGs where its float luma differs from the plain
  reader's integer luma.
- The port's fixture writer against the script: the same text files, and
  the same pixels once decoded.
"""
import importlib.util
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from orb_slam2_with_comment_tpu.dataio import datasets as jds
from orb_slam2_with_comment_tpu.dataio import native_loader as jnative
from orb_slam2_with_comment_tpu_torch.dataio import datasets as tds
from orb_slam2_with_comment_tpu_torch.dataio import fixtures
from orb_slam2_with_comment_tpu_torch.dataio import native_loader, png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 2  # per fixture: each frame is a 640x480 ray-cast render
STREET_FRAMES = 1  # a 1241x376 street render takes seconds a view


def _script():
    spec = importlib.util.spec_from_file_location(
        "make_fixture_dataset",
        os.path.join(ROOT, "scripts", "make_fixture_dataset.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- a test-local PNG encoder: one filter type per row -----------------------

_BPP_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _filtered(raw: np.ndarray, bpp: int, filters) -> np.ndarray:
    """raw [H, stride] bytes -> [H, 1 + stride] filtered rows, row y with
    filter filters[y % len(filters)] (PNG spec section 9)."""
    h, stride = raw.shape
    cur_all = raw.astype(np.int32)
    out = np.zeros((h, stride + 1), np.uint8)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = cur_all[y]
        up = cur_all[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        if f == 4:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        else:
            pred = [0, left, up, (left + up) // 2][f]
        out[y, 0] = f
        out[y, 1:] = (cur - pred) & 0xFF
    return out


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode(path, arr, color, depth=8, filters=(0,), palette=None, trns=None,
           interlace=0):
    h, w = arr.shape[:2]
    if depth == 16:
        raw = arr.astype(">u2").view(np.uint8).reshape(h, -1)
    else:
        raw = arr.reshape(h, -1).astype(np.uint8)
    bpp = max(1, _BPP_CHANNELS[color] * depth // 8)
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                          0, interlace)))
    if palette is not None:
        data += _chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns.tobytes())
    data += _chunk(b"IDAT", zlib.compress(
        _filtered(raw, bpp, filters).tobytes()))
    data += _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


KINDS = {  # name: (color type, bit depth, array shape tail)
    "gray8": (0, 8, ()), "gray16": (0, 16, ()), "rgb8": (2, 8, (3,)),
    "rgba8": (6, 8, (4,)), "gray_alpha": (4, 8, (2,)),
    "palette": (3, 8, ()), "palette_trns": (3, 8, ()),
}
FILTERS = {"none": (0,), "sub": (1,), "up": (2,), "average": (3,),
           "paeth": (4,), "mixed": (0, 1, 2, 3, 4, 4, 2)}


def _write_kind(path, kind, filters, seed=0, h=37, w=53):
    color, depth, tail = KINDS[kind]
    rng = np.random.RandomState(seed)
    if color == 3:
        pal = rng.randint(0, 256, (200, 3)).astype(np.uint8)
        trns = (rng.randint(0, 256, 90).astype(np.uint8)
                if kind == "palette_trns" else None)
        encode(path, rng.randint(0, 200, (h, w)), 3, 8, filters, pal, trns)
        return
    arr = rng.randint(0, 65536 if depth == 16 else 256, (h, w) + tail)
    # smooth rows give the predictors' branches other values than noise
    arr[: h // 2] = np.sort(arr[: h // 2], axis=1)
    encode(path, arr, color, depth, filters)


def _pil_pixels(path, kind):
    im = Image.open(path)
    if kind == "palette":
        im = im.convert("RGB")
    elif kind == "palette_trns":
        im = im.convert("RGBA")
    return np.asarray(im)


@pytest.mark.parametrize("filt", sorted(FILTERS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_read_png_matches_pil(tmp_path, kind, filt):
    path = str(tmp_path / "a.png")
    _write_kind(path, kind, FILTERS[filt])
    got, want = png.read_png(path), _pil_pixels(path, kind)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert png.read_shape(path) == want.shape[:2]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_gray_conversion_matches_the_jax_reader(tmp_path, kind):
    path = str(tmp_path / "a.png")
    _write_kind(path, kind, FILTERS["mixed"], seed=3)
    got, want = tds._imread_gray(path), jds._imread_gray(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if kind in ("gray8", "gray16"):
        np.testing.assert_array_equal(tds._imread_depth(path, 5000.0),
                                      jds._imread_depth(path, 5000.0))


@pytest.mark.parametrize("case", ["interlaced", "bit_depth_4", "rgb16"])
def test_read_png_refuses(tmp_path, case):
    path = str(tmp_path / "a.png")
    rng = np.random.RandomState(1)
    if case == "interlaced":
        encode(path, rng.randint(0, 256, (8, 8)), 0, interlace=1)
    elif case == "bit_depth_4":
        encode(path, rng.randint(0, 256, (8, 4)), 0, depth=4)
    else:
        encode(path, rng.randint(0, 65536, (8, 8, 3)), 2, depth=16)
    with pytest.raises(ValueError):
        png.read_png(path)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_write_png_round_trips(tmp_path, dtype):
    rng = np.random.RandomState(2)
    arr = rng.randint(0, np.iinfo(dtype).max + 1, (41, 67)).astype(dtype)
    path = str(tmp_path / "w.png")
    png.write_png(path, arr)
    got = png.read_png(path)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, arr)
    pil = Image.open(path)
    assert pil.mode == ("L" if dtype == np.uint8 else "I;16")
    np.testing.assert_array_equal(np.asarray(pil), arr)
    with pytest.raises(ValueError):
        png.write_png(path, arr.astype(np.float32))


# -- list parsing and association ------------------------------------------

def test_load_tum_list_matches_jax(tmp_path):
    p = tmp_path / "rgb.txt"
    p.write_text("# color images\n# timestamp filename\n"
                 "1305031102.175304 rgb/1305031102.175304.png\n\n"
                 "  1305031102.211214 rgb/1305031102.211214.png  \n"
                 "1305031102.243211 rgb/1305031102.243211.png extra\n")
    got = tds.load_tum_list(str(p))
    assert got == jds.load_tum_list(str(p)) and len(got) == 3


@pytest.mark.parametrize("offset", [0.0, 0.03])
def test_associate_tum_matches_jax(offset):
    rgb = [(0.00, "a"), (0.05, "b"), (0.10, "c")]
    dep = [(0.011, "x"), (0.049, "y"), (0.30, "z")]
    got = tds.associate_tum(rgb, dep, max_diff=0.02, offset=offset)
    assert got == jds.associate_tum(rgb, dep, max_diff=0.02, offset=offset)
    if offset == 0.0:  # tests/test_system_dataio.py's greedy case
        assert got == [(0, 0), (1, 1)]
    rng = np.random.RandomState(4)
    a = [(float(t), f"a{i}") for i, t in enumerate(
        np.sort(rng.uniform(0, 3, 60)))]
    b = [(float(t), f"b{i}") for i, t in enumerate(
        np.sort(rng.uniform(0, 3, 55)))]
    got = tds.associate_tum(a, b, max_diff=0.02, offset=offset)
    assert got == jds.associate_tum(a, b, max_diff=0.02, offset=offset)
    assert len(got) > 5


# -- readers, prefetch and the fixture writer -------------------------------

FIXTURES = ("tum_fixture", "tum_loop_fixture", "kitti_fixture",
            "euroc_fixture", "kitti_street_fixture")


def _write_all(make, root, **kw):
    make.make_tum_rgbd(os.path.join(root, "tum_fixture"), n_frames=N_FRAMES,
                       **kw)
    make.make_tum_rgbd(os.path.join(root, "tum_loop_fixture"),
                       n_frames=N_FRAMES, laps=2, style="lookout",
                       cal_err=0.015, **kw)
    make.make_kitti_stereo(os.path.join(root, "kitti_fixture"),
                           n_frames=N_FRAMES, **kw)
    make.make_euroc_stereo(os.path.join(root, "euroc_fixture"),
                           n_frames=N_FRAMES, **kw)
    make.make_kitti_street(os.path.join(root, "kitti_street_fixture"),
                           n_frames=STREET_FRAMES, **kw)
    return root


@pytest.fixture(scope="module")
def jax_root(tmp_path_factory):
    return _write_all(_script(), str(tmp_path_factory.mktemp("jax_fix")))


@pytest.fixture(scope="module")
def port_root(tmp_path_factory):
    written = {}
    root = _write_all(fixtures, str(tmp_path_factory.mktemp("port_fix")),
                      workers=2, written=written)
    return root, written


def _files(root):
    out = []
    for base, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(base, n), root) for n in names]
    return sorted(out)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_fixture_writer_matches_the_script(jax_root, port_root, fixture):
    root, written = port_root
    a, b = os.path.join(jax_root, fixture), os.path.join(root, fixture)
    names = _files(a)
    assert names == _files(b) and len(names) >= 5
    n_png = 0
    for rel in names:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".png"):
            want = np.asarray(Image.open(pa))
            got = png.read_png(pb)
            assert got.dtype == want.dtype, rel
            np.testing.assert_array_equal(got, want, rel)
            np.testing.assert_array_equal(png.read_png(pa), want, rel)
            np.testing.assert_array_equal(written[pb], want, rel)
            n_png += 1
        else:
            with open(pa) as fa, open(pb) as fb:
                assert fa.read() == fb.read(), rel
    assert n_png == 2 * (STREET_FRAMES if "street" in fixture else N_FRAMES)


def _same_items(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w) and g[0] == w[0]
        for x, y in zip(g[1:], w[1:]):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("reader", ["tum_rgbd", "tum_rgbd_associations",
                                    "tum_mono", "kitti", "kitti_stereo",
                                    "euroc", "euroc_stereo"])
def test_readers_match_jax(jax_root, tmp_path, reader):
    tum = os.path.join(jax_root, "tum_fixture")
    kitti = os.path.join(jax_root, "kitti_fixture")
    euroc = os.path.join(jax_root, "euroc_fixture")
    if reader == "tum_rgbd_associations":
        assoc = tmp_path / "associations.txt"
        rows = tds.load_tum_list(os.path.join(tum, "rgb.txt"))
        assoc.write_text("# ts rgb ts depth\n" + "".join(
            f"{ts:.6f} {rel} {ts:.6f} {rel.replace('rgb', 'depth')}\n"
            for ts, rel in rows[::-1]))
        args = (tum, 5000.0, str(assoc))
    make = {
        "tum_rgbd": lambda m: m.TumRgbdDataset(tum),
        "tum_rgbd_associations": lambda m: m.TumRgbdDataset(*args),
        "tum_mono": lambda m: m.TumMonoDataset(tum),
        "kitti": lambda m: m.KittiDataset(kitti),
        "kitti_stereo": lambda m: m.KittiDataset(kitti, stereo=True),
        "euroc": lambda m: m.EurocDataset(
            os.path.join(euroc, "mav0"),
            os.path.join(euroc, "timestamps.txt")),
        "euroc_stereo": lambda m: m.EurocDataset(
            os.path.join(euroc, "mav0"),
            os.path.join(euroc, "timestamps.txt"), stereo=True),
    }[reader]
    got, want = make(tds), make(jds)
    assert len(got) == len(want) == N_FRAMES
    _same_items(got, want)


def _color_sequence(root):
    """A TUM RGB-D sequence whose rgb PNGs are RGB (Paeth-filtered, as real
    TUM frames are) and whose depth PNGs are 16-bit."""
    rng = np.random.RandomState(5)
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    rgb_lines, dep_lines = [], []
    for k in range(3):
        name = f"{k / 30:.6f}.png"
        encode(os.path.join(root, "rgb", name),
               rng.randint(0, 256, (24, 32, 3)), 2, 8, (4, 1, 2, 3))
        encode(os.path.join(root, "depth", name),
               rng.randint(0, 65536, (24, 32)), 0, 16, (4, 0))
        rgb_lines.append(f"{k / 30:.6f} rgb/{name}\n")
        dep_lines.append(f"{k / 30:.6f} depth/{name}\n")
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("".join(rgb_lines))
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("".join(dep_lines))
    return root


@pytest.mark.parametrize("sequence", ["fixture", "color"])
def test_prefetch_matches_jax(jax_root, tmp_path, monkeypatch, sequence):
    monkeypatch.setenv("ORB_TPU_NATIVE_CACHE", str(tmp_path / "cache"))
    assert native_loader.get_lib() is not None, "g++ and libpng are here"
    assert jnative.get_lib() is not None
    seq = (os.path.join(jax_root, "tum_fixture") if sequence == "fixture"
           else _color_sequence(str(tmp_path / "color")))
    got = list(tds.TumRgbdDataset(seq).prefetch(n_threads=2))
    _same_items(got, jds.TumRgbdDataset(seq).prefetch(n_threads=2))
    plain = list(tds.TumRgbdDataset(seq))
    if sequence == "fixture":  # gray8 and 16-bit depth: the plain values
        _same_items(got, plain)
    else:  # float luma against PIL's integer luma: rounding, plus PIL's
        # weights (19595, 38470, 7471) / 65536 off 0.299, 0.587, 0.114 by
        # at most 1.1e-5 in all, times 255
        assert not np.array_equal(got[0][1], plain[0][1])
        assert np.abs(got[0][1] - plain[0][1]).max() <= 0.5 + 3e-3
        np.testing.assert_array_equal(got[0][2], plain[0][2])


def test_native_loader_builds_keyed_and_raises(tmp_path, monkeypatch):
    """The library is built into build/ under a hash of the source and the
    flags; without g++ (or png.h) get_lib() is None and prefetch() takes the
    plain reader; a build that runs and fails raises."""
    gxx = native_loader.toolchain()
    assert gxx is not None
    so = native_loader.build(gxx)
    assert os.path.dirname(so) == os.path.join(ROOT, "build")
    assert os.path.basename(so).startswith("libframe_loader-")
    monkeypatch.setattr(native_loader, "_LIB", None)
    monkeypatch.setattr(native_loader, "toolchain", lambda: None)
    assert native_loader.get_lib() is None
    seq = _color_sequence(str(tmp_path / "color"))
    _same_items(tds.TumRgbdDataset(seq).prefetch(), tds.TumRgbdDataset(seq))
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "_SRC", str(bad))
    monkeypatch.setattr(native_loader, "BUILD_DIR", str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_loader.build(gxx)
