"""Stereo SAD refinement of every pyramid level in one call (K5).

For each left keypoint, at its level's scale: the 11x11 left patch less its
centre against the 11x21 right strip at the rounded coarse right u, the SAD
at the 11 shifts (each window less its own centre), the argmin, the
parabola through the three SADs around it, and the gates: the strip inside
the image, the best shift not at the search edge, |delta| <= 1 (reference
Frame.cc:586-643; the JAX package's frontend/stereo.py _sad_refine_block,
one XLA program a level).

The pyramids come packed, as ops/orb.py's kernels read them, and the
levels are ops/orb.level_table's rows (budget above 0, in level order):
keypoint slot ``n`` belongs to the level whose slots hold it.

``sad_refine_plain`` is the plain PyTorch version, level by level.
``sad_refine`` takes it only for tensors on the CPU; for CUDA tensors it
launches the hand-written kernel of ``csrc/stereo_sad.cu`` once for all
levels, or raises. ``LAUNCHES`` counts those launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_lib

W = 5  # SAD half-window (reference: const int w = 5, Frame.cc:593)
L = 5  # shift search range (reference: const int L = 5, Frame.cc:600)
PATCH = 2 * W + 1  # the window's side, 11
SPAN = 2 * W + 2 * L + 1  # the strip's width, 21
MAX_LEVELS = 16  # csrc/stereo_sad.cu's SadTable holds 16 levels
LAUNCHES = {"stereo_sad": 0}


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
    # a window that would leave the image is shifted back inside
    yc = (yi - W).clamp(0, h - PATCH) + W
    xc = (xi - W).clamp(0, w - PATCH) + W
    off = torch.arange(-W, W + 1, device=pyr_l.device)
    rows = (yc[:, None] + off[None, :])[:, :, None]
    p_l = pyr_l[rows, (xc[:, None] + off[None, :])[:, None, :]]  # [N,11,11]
    p_l = p_l - p_l[:, W:W + 1, W:W + 1]
    x0 = uri - W - L
    inb = (x0 >= 0) & (x0 + SPAN <= w)
    x0c = x0.clamp(0, w - SPAN)
    cols = x0c[:, None] + torch.arange(SPAN, device=pyr_l.device)[None, :]
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


class _SadLevel(ctypes.Structure):
    _fields_ = [("off", ctypes.c_int), ("h", ctypes.c_int),
                ("w", ctypes.c_int), ("budget", ctypes.c_int),
                ("slot", ctypes.c_int), ("inv", ctypes.c_float),
                ("scale", ctypes.c_float)]


class _SadTable(ctypes.Structure):
    _fields_ = [("n_levels", ctypes.c_int), ("n_slots", ctypes.c_int),
                ("lv", _SadLevel * MAX_LEVELS)]


def _table(levels: tuple) -> _SadTable:
    """The kernel's level table; raises for what it does not take."""
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"the SAD kernel takes at most {MAX_LEVELS} levels "
                         f"with a budget, got {len(levels)}")
    for lv in levels:
        if lv.h < PATCH or lv.w < SPAN:
            raise ValueError(
                f"the SAD kernel takes levels of at least {PATCH} rows and "
                f"{SPAN} columns; level {lv.lvl} is {lv.h}x{lv.w}")
    t = _SadTable()
    t.n_levels = len(levels)
    t.n_slots = sum(lv.budget for lv in levels)
    for i, lv in enumerate(levels):
        # the two factors as the plain version rounds them on the host
        t.lv[i] = _SadLevel(lv.off, lv.h, lv.w, lv.budget, lv.slot,
                            _f32(1.0 / lv.scale), _f32(lv.scale))
    return t


_lib: ctypes.CDLL | None = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.stereo_sad_table_bytes.argtypes = []
    lib.stereo_sad_table_bytes.restype = ctypes.c_int
    lib.stereo_sad.argtypes = [ctypes.c_void_p] * 10
    lib.stereo_sad.restype = ctypes.c_int
    return lib


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = bind(cuda_lib.load("stereo_sad"))
        got, want = lib.stereo_sad_table_bytes(), ctypes.sizeof(_SadTable)
        if got != want:
            raise RuntimeError(f"csrc/stereo_sad.cu's SadTable is {got} "
                               f"bytes, ops/sad.py's {want}")
        _lib = lib
    return _lib


def _check_args(flat_l, flat_r, levels, xy_l, u_r0) -> int:
    """N of a call; raises on a wrong type, shape or device."""
    for name, x in (("flat_l", flat_l), ("flat_r", flat_r), ("xy_l", xy_l),
                    ("u_r0", u_r0)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
    n = sum(lv.budget for lv in levels)
    size = levels[-1].off + levels[-1].h * levels[-1].w if levels else 0
    for name, x in (("flat_l", flat_l), ("flat_r", flat_r)):
        if x.dim() != 1 or x.shape[0] < size:
            raise ValueError(f"{name} must be the packed levels, [>= {size}]"
                             f", got {tuple(x.shape)}")
    if tuple(xy_l.shape) != (n, 2) or tuple(u_r0.shape) != (n,):
        raise ValueError(f"expected xy_l [{n}, 2] and u_r0 [{n}], got "
                         f"{tuple(xy_l.shape)}, {tuple(u_r0.shape)}")
    ts = (flat_l, flat_r, xy_l, u_r0)
    dev = flat_l.device
    if not all(x.device.type == "cpu" for x in ts) and (
            dev.type != "cuda" or any(x.device != dev for x in ts)):
        raise ValueError("the SAD kernel takes tensors on one CUDA device "
                         f"(got {[str(x.device) for x in ts]})")
    return n


def launch(lib: ctypes.CDLL, flat_l, flat_r, levels, xy_l, u_r0):
    """stereo_sad of ``lib`` on checked contiguous CUDA tensors: allocates
    the outputs, launches on the current stream, raises on a launch error.
    Returns (u_right, best SAD, ok, best shift [N] int8)."""
    t = _table(tuple(levels))
    n = t.n_slots
    dev = flat_l.device
    u_right = torch.empty(n, dtype=torch.float32, device=dev)
    sad = torch.empty(n, dtype=torch.float32, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    best = torch.empty(n, dtype=torch.int8, device=dev)
    err = lib.stereo_sad(
        flat_l.data_ptr(), flat_r.data_ptr(), xy_l.data_ptr(),
        u_r0.data_ptr(), u_right.data_ptr(), sad.data_ptr(), ok.data_ptr(),
        best.data_ptr(), ctypes.addressof(t),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stereo_sad launch failed: cudaError_t {err}")
    return u_right, sad, ok, best


def sad_refine(flat_l: torch.Tensor, flat_r: torch.Tensor, levels,
               xy_l: torch.Tensor, u_r0: torch.Tensor):
    """K5: see sad_refine_plain. All levels in one launch of
    csrc/stereo_sad.cu on CUDA tensors, reading nothing back."""
    n = _check_args(flat_l, flat_r, levels, xy_l, u_r0)
    if flat_l.device.type == "cpu":
        return sad_refine_plain(flat_l, flat_r, levels, xy_l, u_r0)
    out = launch(_kernel_lib(), flat_l.contiguous(), flat_r.contiguous(),
                 levels, xy_l.contiguous(), u_r0.contiguous())
    if n:
        LAUNCHES["stereo_sad"] += 1
    return out[:3]
