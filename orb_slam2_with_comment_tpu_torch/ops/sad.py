"""The stereo match after the association (K5): the SAD refinement of every
pyramid level, the depth and the median-SAD sweep of a rectified pair.

For each left keypoint, at its level's scale: the 11x11 left patch less its
centre against the 11x21 right strip at the rounded coarse right u, the SAD
at the 11 shifts (each window less its own centre), the argmin, the
parabola through the three SADs around it, and the gates: the strip inside
the image, the best shift not at the search edge, |delta| <= 1 (reference
Frame.cc:586-643; the JAX package's frontend/stereo.py _sad_refine_block,
one XLA program a level). Then the tail (Frame.cc:645-674; the JAX
package's frontend/stereo.py:141-161): K1's match under the threshold, the
disparity clamped above 0 and below fx, and the good SADs no larger than
1.5 * 1.4 times their median; the depth is bf / disparity.

The pyramids come packed, as ops/orb.py's kernels read them, and the
levels are ops/orb.level_table's rows (budget above 0, in level order):
keypoint slot ``n`` belongs to the level whose slots hold it.

``stereo_depth_plain`` is the plain PyTorch version (``sad_refine_plain``
level by level, then ``stereo_tail_plain``). ``stereo_depth`` takes it only
for tensors on the CPU; for CUDA tensors it launches the hand-written
kernel of ``csrc/stereo_sad.cu`` once for the whole pair, or raises.
``LAUNCHES`` counts those launches.

``sad_refine`` is the refinement alone through the kernel's first design,
``csrc/stereo_sad_v1.cu``, kept as its timing baseline (``V1_LAUNCHES``);
the main path does not call it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import cuda_lib

W = 5  # SAD half-window (reference: const int w = 5, Frame.cc:593)
L = 5  # shift search range (reference: const int L = 5, Frame.cc:600)
PATCH = 2 * W + 1  # the window's side, 11
SPAN = 2 * W + 2 * L + 1  # the strip's width, 21
MAX_LEVELS = 16  # levels csrc/stereo_sad.cu's SadTable holds by value
TH_ORB = 75  # (TH_HIGH + TH_LOW) / 2 (reference: Frame.cc:540)
LAUNCHES = {"stereo_sad": 0}
# the launches, among LAUNCHES', of the kernel's instantiation with its
# level table in device memory (more than MAX_LEVELS levels)
VARIANT_LAUNCHES = {"stereo_sad_far": 0}
V1_LAUNCHES = {"stereo_sad_v1": 0}


def _f32(x: float) -> float:
    """A Python scalar rounded to float32, as JAX weakly types it."""
    return float(np.float32(x))


def _curves(pyr_l: torch.Tensor, pyr_r: torch.Tensor, inv_scale: float,
            xy_l: torch.Tensor, u_r0: torch.Tensor):
    """(rounded coarse right u in level pixels, strip inside the image,
    SAD at the 11 shifts [N, 11]) of one level's keypoint block."""
    h, w = pyr_l.shape
    inv = _f32(inv_scale)
    ur0 = torch.round(u_r0 * inv)
    yi = torch.round(xy_l[:, 1] * inv).to(torch.int64)
    xi = torch.round(xy_l[:, 0] * inv).to(torch.int64)
    uri = ur0.to(torch.int64)
    # a window that would leave the image is shifted back inside; on a
    # level under 11 rows or 21 columns the bound is negative and the reads
    # are clamped to the level, as the JAX package's one-hot reads clip
    # them (on the other levels the clamps change nothing)
    yc = (yi - W).clamp(0, h - PATCH) + W
    xc = (xi - W).clamp(0, w - PATCH) + W
    off = torch.arange(-W, W + 1, device=pyr_l.device)
    rows = (yc[:, None] + off[None, :]).clamp(0, h - 1)[:, :, None]
    cols_l = (xc[:, None] + off[None, :]).clamp(0, w - 1)
    p_l = pyr_l[rows, cols_l[:, None, :]]  # [N,11,11]
    p_l = p_l - p_l[:, W:W + 1, W:W + 1]
    x0 = uri - W - L
    inb = (x0 >= 0) & (x0 + SPAN <= w)
    x0c = x0.clamp(0, w - SPAN)
    cols = (x0c[:, None] + torch.arange(SPAN, device=pyr_l.device)[None, :]
            ).clamp(0, w - 1)
    strip = pyr_r[rows, cols[:, None, :]]  # [N, 11, 21]
    win = strip.unfold(2, PATCH, 1)  # [N, 11 rows, 11 shifts, 11 cols]
    win = win - win[:, W:W + 1, :, W:W + 1]
    diff = (p_l[:, :, None, :] - win).abs()  # [N, rows, shifts, cols]
    # the 121 terms summed in one fixed order, which csrc/stereo_sad.cu
    # repeats: along each row, then the 11 row sums
    row = diff[..., 0]
    for c in range(1, PATCH):
        row = row + diff[..., c]
    sad = row[:, 0]
    for r in range(1, PATCH):
        sad = sad + row[:, r]
    return ur0, inb, sad


def sad_refine_block(pyr_l: torch.Tensor, pyr_r: torch.Tensor,
                     inv_scale: float, xy_l: torch.Tensor,
                     u_r0: torch.Tensor):
    """Subpixel correlation for one pyramid level's keypoint block.

    Returns (refined right u in level pixels, best SAD, ok): the strip lies
    inside the image, the best shift is not at the search edge and the
    parabola's vertex within one pixel (reference Frame.cc:611-636).
    """
    ur0, inb, sad = _curves(pyr_l, pyr_r, inv_scale, xy_l, u_r0)
    best = torch.argmin(sad, dim=1)
    edge = (best == 0) | (best == 2 * L)
    b = best.clamp(1, 2 * L - 1)

    def take(i):
        return sad.gather(1, i[:, None])[:, 0]

    d1, d2, d3 = take(b - 1), take(b), take(b + 1)
    denom = d1 + d3 - 2.0 * d2
    delta = torch.where(denom > 0,
                        (d1 - d3) / (2.0 * denom.clamp(min=1e-9)), 2.0)
    ok = inb & ~edge & (delta.abs() <= 1.0)
    inc = (b.to(torch.float32) - L) + delta
    return ur0 + inc, take(best), ok


def _level_view(flat: torch.Tensor, lv) -> torch.Tensor:
    return flat[lv.off:lv.off + lv.h * lv.w].view(lv.h, lv.w)


def sad_refine_plain(flat_l: torch.Tensor, flat_r: torch.Tensor, levels,
                     xy_l: torch.Tensor, u_r0: torch.Tensor):
    """(right u in level-0 pixels, best SAD, ok), each [N], of the packed
    left and right pyramids ``flat_l`` / ``flat_r`` at the left keypoints
    ``xy_l`` [N, 2] (level-0 pixels) and their coarse right u ``u_r0`` [N];
    N is the levels' slot count. Level by level with sad_refine_block."""
    u_right, sad_best, ok_all = [], [], []
    for lv in levels:
        sl = slice(lv.slot, lv.slot + lv.budget)
        ur_lvl, sad, ok = sad_refine_block(
            _level_view(flat_l, lv), _level_view(flat_r, lv), 1.0 / lv.scale,
            xy_l[sl], u_r0[sl])
        u_right.append(ur_lvl * _f32(lv.scale))
        sad_best.append(sad)
        ok_all.append(ok)
    if not levels:
        empty = xy_l.new_empty(0)
        return empty, empty, torch.zeros(0, dtype=torch.bool,
                                         device=xy_l.device)
    return torch.cat(u_right), torch.cat(sad_best), torch.cat(ok_all)


def sad_curves_plain(flat_l: torch.Tensor, flat_r: torch.Tensor, levels,
                     xy_l: torch.Tensor, u_r0: torch.Tensor) -> torch.Tensor:
    """The SAD at the 11 shifts [N, 11] of every keypoint, as
    sad_refine_plain forms them."""
    out = [_curves(_level_view(flat_l, lv), _level_view(flat_r, lv),
                   1.0 / lv.scale, xy_l[lv.slot:lv.slot + lv.budget],
                   u_r0[lv.slot:lv.slot + lv.budget])[2] for lv in levels]
    return torch.cat(out) if out else xy_l.new_empty(0, 2 * L + 1)


def stereo_tail_plain(u_right: torch.Tensor, sad_best: torch.Tensor,
                      ok: torch.Tensor, best_d: torch.Tensor,
                      x_l: torch.Tensor, bf: float, fx: float):
    """(right u, depth), each [N] float32, -1 where a left keypoint has no
    match: the refinement's right u, best SAD and ok [N], K1's best
    distance ``best_d`` [N] int32 and the left keypoints' u ``x_l`` [N];
    ``bf`` and ``fx`` float32 values (the JAX package's
    frontend/stereo.py:141-161)."""
    n = u_right.shape[0]
    if n == 0:
        return u_right.new_empty(0), u_right.new_empty(0)
    good = (best_d < TH_ORB) & ok
    disparity = x_l - u_right
    # disparity <= 0 is clamped to a tiny positive value (reference :650-653)
    tiny = disparity <= 0
    disparity = torch.where(tiny, 0.01, disparity)
    u_right = torch.where(tiny, x_l - 0.01, u_right)
    good = good & (disparity < fx)
    # thDist = 1.5 * 1.4 * median(best SAD) (reference Frame.cc:661-674);
    # with no good match the median is inf and nothing more is rejected
    sad_sorted = torch.sort(torch.where(good, sad_best, float("inf"))).values
    med = sad_sorted[(good.sum() // 2).clamp(0, n - 1)]
    good = good & (sad_best <= 1.5 * 1.4 * med)
    # one IEEE division, as the JAX package's bf / disparity: a Python
    # float over a tensor would be disparity.reciprocal() * bf
    depth = torch.div(torch.tensor(bf, dtype=torch.float32), disparity)
    return (torch.where(good, u_right, -1.0), torch.where(good, depth, -1.0))


def stereo_depth_plain(flat_l: torch.Tensor, flat_r: torch.Tensor, levels,
                       xy_l: torch.Tensor, xy_r: torch.Tensor,
                       best_d: torch.Tensor, best_j: torch.Tensor, bf: float,
                       fx: float):
    """(right u, depth), each [N] float32, -1 where a left keypoint has no
    match, of the packed left and right pyramids ``flat_l`` / ``flat_r``:
    the left keypoints ``xy_l`` [N, 2] and the right ones ``xy_r`` [M, 2]
    (level-0 px), K1's best distance and index ``best_d`` / ``best_j`` [N]
    int32 (a row without a candidate carries a distance >= TH_ORB), ``bf``
    and ``fx`` float32 values; N is the levels' slot count."""
    u_r0 = xy_r[best_j.long(), 0]
    u_right, sad_best, ok = sad_refine_plain(flat_l, flat_r, levels, xy_l,
                                             u_r0)
    return stereo_tail_plain(u_right, sad_best, ok, best_d, xy_l[:, 0], bf,
                             fx)


class _SadLevel(ctypes.Structure):
    _fields_ = [("off", ctypes.c_int), ("h", ctypes.c_int),
                ("w", ctypes.c_int), ("budget", ctypes.c_int),
                ("slot", ctypes.c_int), ("inv", ctypes.c_float),
                ("scale", ctypes.c_float)]


class _SadTable(ctypes.Structure):
    """csrc/stereo_sad.cu's SadTable. Above MAX_LEVELS levels ``levels``
    (device memory, set at the launch) and ``host_levels`` hold them all
    and ``lv`` is not read."""
    _fields_ = [("n_levels", ctypes.c_int), ("n_slots", ctypes.c_int),
                ("lv", _SadLevel * MAX_LEVELS),
                ("levels", ctypes.c_void_p), ("host_levels", ctypes.c_void_p)]


# the bytes of csrc/stereo_sad_v1.cu's SadTable: this one's up to the end of ``lv``
V1_TABLE_BYTES = _SadTable.lv.offset + _SadTable.lv.size


def _table(levels: tuple) -> _SadTable:
    """The kernels' level table (every level size and count; the levels'
    copy in device memory, above MAX_LEVELS, is Layout.device_levels')."""
    t = _SadTable()
    t.n_levels = len(levels)
    t.n_slots = sum(lv.budget for lv in levels)
    # the two factors as the plain version rounds them on the host
    descs = [_SadLevel(lv.off, lv.h, lv.w, lv.budget, lv.slot,
                       _f32(1.0 / lv.scale), _f32(lv.scale)) for lv in levels]
    if len(levels) <= MAX_LEVELS:
        for i, d in enumerate(descs):
            t.lv[i] = d
    else:
        t.keep = (_SadLevel * len(descs))(*descs)
        t.host_levels = ctypes.addressof(t.keep)
    return t


class Layout(NamedTuple):
    """What a call needs of a level layout, worked out once a layout."""
    levels: tuple
    n: int  # keypoint slots
    size: int  # pixels of a packed pyramid
    table: _SadTable
    address: int  # the table's address, for ctypes
    device_levels: dict  # device -> the levels in its memory (> MAX_LEVELS)

    def for_device(self, dev: torch.device) -> int:
        """The table's address with its levels in ``dev``'s memory where
        it has more than MAX_LEVELS of them."""
        if self.table.host_levels:
            got = self.device_levels.get(dev)
            if got is None:
                got = torch.frombuffer(bytearray(self.table.keep),
                                       dtype=torch.uint8).to(dev)
                self.device_levels[dev] = got
            self.table.levels = got.data_ptr()
        return self.address


# layouts by the id of their levels tuple (ops/orb.level_table gives the
# same tuple for a pyramid's sizes, budgets and scales each time); the
# entry holds the tuple, so an id is not reused while it stays
_layouts: dict[int, Layout] = {}


def layout(levels) -> Layout:
    """The Layout of ``levels``, built once per levels tuple."""
    got = _layouts.get(id(levels))
    if got is not None and got.levels is levels:
        return got
    key = levels if isinstance(levels, tuple) else None
    levels = tuple(levels)
    n = sum(lv.budget for lv in levels)
    size = levels[-1].off + levels[-1].h * levels[-1].w if levels else 0
    table = _table(levels)
    out = Layout(levels, n, size, table, ctypes.addressof(table), {})
    if key is not None:
        if len(_layouts) >= 256:
            _layouts.clear()
        _layouts[id(key)] = out
    return out


def _check_pyramids(flat_l, flat_r, lay: Layout):
    for name, x in (("flat_l", flat_l), ("flat_r", flat_r)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 1 or x.shape[0] < lay.size:
            raise ValueError(f"{name} must be the packed levels, "
                             f"[>= {lay.size}], got {tuple(x.shape)}")


def _check_devices(ts) -> bool:
    """True for CPU tensors; raises unless all lie on one CUDA device."""
    dev = ts[0].device
    if dev.type == "cpu" and all(x.device.type == "cpu" for x in ts):
        return True
    if dev.type != "cuda" or any(x.device != dev for x in ts):
        raise ValueError("the SAD kernel takes tensors on one CUDA device "
                         f"(got {[str(x.device) for x in ts]})")
    return False


def _contiguous(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_contiguous() else x.contiguous()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# the kernel of the main path (csrc/stereo_sad.cu) and the first design of
# the refinement alone (csrc/stereo_sad_v1.cu), each loaded on first use
_lib: ctypes.CDLL | None = None
_v1_lib: ctypes.CDLL | None = None


def bind_v1(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.stereo_sad_table_bytes.argtypes = []
    lib.stereo_sad_table_bytes.restype = ctypes.c_int
    lib.stereo_sad.argtypes = [ctypes.c_void_p] * 10
    lib.stereo_sad.restype = ctypes.c_int
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.stereo_depth_table_bytes.argtypes = []
    lib.stereo_depth_table_bytes.restype = i
    lib.stereo_depth_out_floats.argtypes = [ctypes.c_longlong]
    lib.stereo_depth_out_floats.restype = ctypes.c_longlong
    lib.stereo_depth_stamps.argtypes = []
    lib.stereo_depth_stamps.restype = i
    lib.stereo_depth_grid.argtypes = [i]
    lib.stereo_depth_grid.restype = i
    lib.stereo_depth.argtypes = [p, p, p, p, p, p, p, i, ctypes.c_float,
                                 ctypes.c_float, p, p, p]
    lib.stereo_depth.restype = i
    return lib


def out_floats(n: int) -> int:
    """Floats of stereo_depth's output buffer: u, depth, SAD and key [N] (4
    bytes each), then ok and the best shift [N] (a byte each)."""
    return 4 * n + (2 * n + 3) // 4


N_STAMPS = 3  # csrc/stereo_sad.cu kStamps


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = bind(cuda_lib.load("stereo_sad"))
        for what, got, want in (
                ("SadTable bytes", lib.stereo_depth_table_bytes(),
                 ctypes.sizeof(_SadTable)),
                ("output floats at N = 1001",
                 lib.stereo_depth_out_floats(1001), out_floats(1001)),
                ("stamps", lib.stereo_depth_stamps(), N_STAMPS)):
            if got != want:
                raise RuntimeError(f"csrc/stereo_sad.cu's {what}: {got}, "
                                   f"ops/sad.py's {want}")
        _lib = lib
    return _lib


def _v1_kernel_lib() -> ctypes.CDLL:
    global _v1_lib
    if _v1_lib is None:
        lib = bind_v1(cuda_lib.load("stereo_sad_v1"))
        got, want = lib.stereo_sad_table_bytes(), V1_TABLE_BYTES
        if got != want:
            raise RuntimeError(f"csrc/stereo_sad_v1.cu's SadTable is {got} "
                               f"bytes, ops/sad.py's {want}")
        _v1_lib = lib
    return _v1_lib


def _check_depth_args(flat_l, flat_r, levels, xy_l, xy_r, best_d,
                      best_j) -> tuple[Layout, bool]:
    """(the layout, on the CPU) of a stereo_depth call; raises on a wrong
    type, shape or device."""
    lay = layout(levels)
    _check_pyramids(flat_l, flat_r, lay)
    n = lay.n
    for name, x, dtype, shape in (
            ("xy_l", xy_l, torch.float32, (n, 2)),
            ("best_d", best_d, torch.int32, (n,)),
            ("best_j", best_j, torch.int32, (n,))):
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {list(shape)}, got "
                             f"{x.dtype} {list(x.shape)}")
    if (xy_r.dtype != torch.float32 or xy_r.dim() != 2 or xy_r.shape[1] != 2
            or (n and xy_r.shape[0] == 0)):
        raise ValueError(f"xy_r must be float32 [M >= 1, 2], got "
                         f"{xy_r.dtype} {list(xy_r.shape)}")
    return lay, _check_devices((flat_l, flat_r, xy_l, xy_r, best_d, best_j))


def launch_depth(lib: ctypes.CDLL, lay: Layout, flat_l, flat_r, xy_l, xy_r,
                 best_d, best_j, bf: float, fx: float,
                 stamps: torch.Tensor | None = None) -> torch.Tensor:
    """stereo_depth of ``lib`` on checked CUDA tensors of one device: one
    cooperative launch on the current stream into a new output buffer
    (out_floats(N) float32; ``outputs`` names its parts); raises on a
    launch error. ``stamps``: an int64 [N_STAMPS] tensor for the kernel's
    globaltimer stamps."""
    dev = flat_l.device
    out = torch.empty(out_floats(lay.n), dtype=torch.float32, device=dev)
    if lay.n == 0:
        return out
    err = lib.stereo_depth(
        lay.for_device(dev), _contiguous(flat_l).data_ptr(),
        _contiguous(flat_r).data_ptr(), _contiguous(xy_l).data_ptr(),
        _contiguous(xy_r).data_ptr(), _contiguous(best_d).data_ptr(),
        _contiguous(best_j).data_ptr(), xy_r.shape[0], bf, fx,
        out.data_ptr(), None if stamps is None else stamps.data_ptr(),
        _stream(dev))
    if err != 0:
        raise RuntimeError(f"stereo_depth launch failed: cudaError_t {err}")
    return out


def outputs(out: torch.Tensor, n: int) -> dict:
    """The parts of stereo_depth's output buffer for N = ``n``: "u_right"
    and "depth" (the results), and the intermediates "sad" (the best SAD),
    "key" (int32: the SAD's bits where the keypoint is good before the
    median's gate, else -1), "ok" (bool) and "best" (the best shift,
    int8)."""
    tail = out[4 * n:].view(torch.uint8)
    return {"u_right": out[:n], "depth": out[n:2 * n],
            "sad": out[2 * n:3 * n],
            "key": out[3 * n:4 * n].view(torch.int32),
            "ok": tail[:n].view(torch.bool),
            "best": tail[n:2 * n].view(torch.int8)}


def stereo_depth(flat_l: torch.Tensor, flat_r: torch.Tensor, levels,
                 xy_l: torch.Tensor, xy_r: torch.Tensor, best_d: torch.Tensor,
                 best_j: torch.Tensor, bf: float, fx: float):
    """K5: see stereo_depth_plain. The refinement of every level, the depth
    and the median sweep in one launch of csrc/stereo_sad.cu on CUDA
    tensors, reading nothing back."""
    lay, on_cpu = _check_depth_args(flat_l, flat_r, levels, xy_l, xy_r,
                                    best_d, best_j)
    if on_cpu:
        return stereo_depth_plain(flat_l, flat_r, lay.levels, xy_l, xy_r,
                                  best_d, best_j, bf, fx)
    out = launch_depth(_kernel_lib(), lay, flat_l, flat_r, xy_l, xy_r,
                       best_d, best_j, bf, fx)
    n = lay.n
    if n:
        LAUNCHES["stereo_sad"] += 1
        if len(lay.levels) > MAX_LEVELS:
            VARIANT_LAUNCHES["stereo_sad_far"] += 1
    return out[:n], out[n:2 * n]


def _check_args(flat_l, flat_r, levels, xy_l, u_r0) -> int:
    """N of a sad_refine call; raises on a wrong type, shape or device."""
    lay = layout(levels)
    _check_pyramids(flat_l, flat_r, lay)
    for name, x in (("xy_l", xy_l), ("u_r0", u_r0)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
    n = lay.n
    if tuple(xy_l.shape) != (n, 2) or tuple(u_r0.shape) != (n,):
        raise ValueError(f"expected xy_l [{n}, 2] and u_r0 [{n}], got "
                         f"{tuple(xy_l.shape)}, {tuple(u_r0.shape)}")
    _check_devices((flat_l, flat_r, xy_l, u_r0))
    return n


def launch(lib: ctypes.CDLL, flat_l, flat_r, levels, xy_l, u_r0):
    """stereo_sad of ``lib`` (csrc/stereo_sad_v1.cu) on checked contiguous
    CUDA tensors: allocates the outputs, launches on the current stream,
    raises on a launch error. Returns (u_right, best SAD, ok, best shift [N]
    int8)."""
    lay = layout(levels)
    n = lay.n
    dev = flat_l.device
    u_right = torch.empty(n, dtype=torch.float32, device=dev)
    sad = torch.empty(n, dtype=torch.float32, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    best = torch.empty(n, dtype=torch.int8, device=dev)
    err = lib.stereo_sad(
        flat_l.data_ptr(), flat_r.data_ptr(), xy_l.data_ptr(),
        u_r0.data_ptr(), u_right.data_ptr(), sad.data_ptr(), ok.data_ptr(),
        best.data_ptr(), lay.address, _stream(dev))
    if err != 0:
        raise RuntimeError(f"stereo_sad launch failed: cudaError_t {err}")
    return u_right, sad, ok, best


def sad_refine(flat_l: torch.Tensor, flat_r: torch.Tensor, levels,
               xy_l: torch.Tensor, u_r0: torch.Tensor):
    """The refinement alone (see sad_refine_plain) through the kernel's
    first design: every level in one launch of csrc/stereo_sad_v1.cu on
    CUDA tensors, reading nothing back."""
    n = _check_args(flat_l, flat_r, levels, xy_l, u_r0)
    if flat_l.device.type == "cpu":
        return sad_refine_plain(flat_l, flat_r, levels, xy_l, u_r0)
    out = launch(_v1_kernel_lib(), _contiguous(flat_l), _contiguous(flat_r),
                 levels, _contiguous(xy_l), _contiguous(u_r0))
    if n:
        V1_LAUNCHES["stereo_sad_v1"] += 1
    return out[:3]
