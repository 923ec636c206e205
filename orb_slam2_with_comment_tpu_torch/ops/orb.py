"""ORB extraction of every pyramid level of one view in three kernels (K2).

Port of the JAX package's extraction program (frontend/extractor.py,
``_extract_from_pyramid`` and ``_level_features``, on ops/fast.py,
ops/image.py, ops/orientation.py and ops/brief.py): XLA ops there, not a
Pallas kernel. Here the per-level work of all levels runs as three
hand-written kernels of ``csrc/orb.cu``, one launch each per view:

- ``cells``: per 32x32 cell of every level, the masked FAST score, 3x3 NMS,
  the cell's 20 -> 7 threshold and its top 8 corners, and the rounded 7x7
  blur;
- ``select``: per level, the spatial round-robin top-``budget`` of the
  cells' candidates;
- ``describe``: per output slot, the IC angle, the rotated BRIEF
  descriptor, the subpixel position and the octave.

The levels are packed into one flat float32 buffer (each level's pixels
row-major, level after level); the score and blurred buffers are packed
the same way. ``level_table`` says where each level with a budget above 0
lies, for any frame size and level count; the kernels take at most
MAX_LEVELS levels and MAX_BUDGET slots a level, which their wrappers check
on the card. Each kernel has a plain PyTorch version at its own interface
(``cells_plain``, ``select_plain``, ``describe_plain``) built from the
port's per-level functions, and ``extract_levels_plain`` chains them: it
equals frontend/extractor.py's per-level loop bit for bit. The wrappers
take the plain versions only for tensors on the CPU; for CUDA tensors they
launch the kernels or raise. ``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import brief, consts, cuda_lib, fast, image, orientation

CELL = 32  # the kernels' cell side
PER_CELL = 8  # candidates per cell
MAX_LEVELS = 16  # csrc/orb.cu's OrbTable holds 16 levels
MAX_BUDGET = 28672  # orb_select ranks a level's winners in 224 KB
LAUNCHES = {"orb_cells": 0, "orb_select": 0, "orb_describe": 0}


class Level(NamedTuple):
    """Where one level with a budget above 0 lies in the packed buffers."""
    lvl: int  # pyramid level: the octave
    off: int  # first pixel in the packed image, score and blurred buffers
    h: int
    w: int
    budget: int  # output slots
    slot: int  # first output slot
    cell: int  # first cell in the candidate buffers
    scale: float  # 1.2 ** lvl (the kernels take it rounded to float32)

    @property
    def cy(self) -> int:
        return -(-self.h // CELL)

    @property
    def cx(self) -> int:
        return -(-self.w // CELL)


@functools.lru_cache(maxsize=64)
def level_table(sizes: tuple, budgets: tuple, scales: tuple
                ) -> tuple[Level, ...]:
    """The levels of a pyramid of level sizes ``sizes`` ((h, w) each)
    whose budget is above 0, in level order."""
    out, off, slot, cell = [], 0, 0, 0
    for lvl, ((h, w), budget, scale) in enumerate(zip(sizes, budgets,
                                                      scales)):
        lv = Level(lvl, off, h, w, budget, slot, cell, scale)
        if budget > 0:
            out.append(lv)
            slot += budget
            cell += lv.cy * lv.cx
        off += h * w
    return tuple(out)


def n_slots(levels) -> int:
    return sum(lv.budget for lv in levels)


def n_cells(levels) -> int:
    return sum(lv.cy * lv.cx for lv in levels)


def _view(buf: torch.Tensor, lv: Level) -> torch.Tensor:
    return buf[lv.off:lv.off + lv.h * lv.w].view(lv.h, lv.w)


def masked_score(lvl_img: torch.Tensor, margin: int) -> torch.Tensor:
    """FAST score of a level, zero within ``margin`` px of its edge."""
    h, w = lvl_img.shape
    m = margin
    score = fast.fast_score_map(lvl_img)
    inner = torch.zeros_like(score)
    inner[m:h - m, m:w - m] = score[m:h - m, m:w - m]
    return inner


# ---------------------------------------------------------------- plain


def moment_cancellation(pyr: torch.Tensor, yx: torch.Tensor, levels):
    """Per slot, |(m10, m01)| of its IC moments over the sum of the moment
    terms' magnitudes, in float64. Near 0 the moments cancel (a flat patch,
    a symmetric junction) and the float32 angle is set by the order of the
    sums, which differs between the kernel and the plain version on levels
    >= 1: the card checks hold angles to 1e-4 where this is >= 1e-3."""
    k = consts.on_device("orientation.KMAT", orientation._KMAT,
                         pyr.device).double()
    parts = []
    for lv in levels:
        p = orientation.gather_patches(_view(pyr, lv),
                                       yx[lv.slot:lv.slot + lv.budget],
                                       orientation.HALF_PATCH)
        p = p.reshape(lv.budget, -1).double()
        parts.append((p @ k).norm(dim=1)
                     / (p @ k.abs()).sum(1).clamp(min=1e-30))
    return torch.cat(parts) if parts else pyr.new_zeros(0, dtype=torch.float64)



def cells_plain(pyr: torch.Tensor, levels, margin: int = 16,
                th_high: float = 20.0, th_low: float = 7.0):
    """pyr [P] packed levels -> (score [P], blurred [P], cand_v [C, 8]
    float32, cand_i [C, 8] int32) for the C cells of ``levels``; pixels of
    levels outside ``levels`` are left unset in score and blurred."""
    score = torch.empty_like(pyr)
    blurred = torch.empty_like(pyr)
    vs, idx = [], []
    for lv in levels:
        img = _view(pyr, lv)
        s = masked_score(img, margin)
        _view(score, lv).copy_(s)
        _view(blurred, lv).copy_(torch.round(image.gaussian_blur(img)))
        v, i = fast.cell_candidates(s, CELL, PER_CELL, th_high, th_low)
        vs.append(v.reshape(-1, PER_CELL))
        idx.append(i.reshape(-1, PER_CELL).to(torch.int32))
    if not vs:
        return (score, blurred, pyr.new_zeros((0, PER_CELL)),
                torch.zeros((0, PER_CELL), dtype=torch.int32,
                            device=pyr.device))
    return score, blurred, torch.cat(vs), torch.cat(idx)


def select_plain(cand_v: torch.Tensor, cand_i: torch.Tensor, levels):
    """-> (yx [N, 2] int32, response [N] float32, valid [N] bool), the N
    slots of ``levels`` in level order."""
    parts = []
    for lv in levels:
        cut = slice(lv.cell, lv.cell + lv.cy * lv.cx)
        parts.append(fast.select_from_candidates(
            cand_v[cut].view(lv.cy, lv.cx, PER_CELL),
            cand_i[cut].view(lv.cy, lv.cx, PER_CELL), lv.budget, CELL))
    if not parts:
        dev = cand_v.device
        return (torch.zeros((0, 2), dtype=torch.int32, device=dev),
                cand_v.new_zeros(0), torch.zeros(0, dtype=torch.bool,
                                                 device=dev))
    return tuple(torch.cat(p) for p in zip(*parts))


def describe_plain(pyr: torch.Tensor, score: torch.Tensor,
                   blurred: torch.Tensor, yx: torch.Tensor, levels):
    """-> (xy [N, 2] float32 in level-0 pixels, octave [N] int32, angle [N]
    float32, desc [N, 8] int32) of the slots' keypoints yx [N, 2]."""
    parts = []
    for lv in levels:
        k = yx[lv.slot:lv.slot + lv.budget]
        img = _view(pyr, lv)
        ang = orientation.ic_angles(img, k)
        desc = brief.descriptors_exact(_view(blurred, lv), k, ang)
        sub = fast.subpixel_refine(_view(score, lv), k)
        xy0 = torch.stack([(k[:, 1].float() + sub[:, 1]) * lv.scale,
                           (k[:, 0].float() + sub[:, 0]) * lv.scale], -1)
        octv = torch.full((lv.budget,), lv.lvl, dtype=torch.int32,
                          device=pyr.device)
        parts.append((xy0, octv, ang, desc))
    if not parts:
        dev = pyr.device
        return (pyr.new_zeros((0, 2)),
                torch.zeros(0, dtype=torch.int32, device=dev),
                pyr.new_zeros(0),
                torch.zeros((0, 8), dtype=torch.int32, device=dev))
    return tuple(torch.cat(p) for p in zip(*parts))


def extract_levels_plain(pyr: torch.Tensor, levels, margin: int = 16,
                         th_high: float = 20.0, th_low: float = 7.0):
    """The three plain versions chained: (xy, response, octave, angle,
    desc, valid), FrameFeatures' order."""
    score, blurred, cand_v, cand_i = cells_plain(pyr, levels, margin,
                                                 th_high, th_low)
    yx, resp, valid = select_plain(cand_v, cand_i, levels)
    xy, octv, ang, desc = describe_plain(pyr, score, blurred, yx, levels)
    return xy, resp, octv, ang, desc, valid


# -------------------------------------------------------------- kernels


class _LevelDesc(ctypes.Structure):
    """csrc/orb.cu's LevelDesc."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "off", "h", "w", "budget", "slot", "cell", "cy", "cx", "lvl")] + [
        ("scale", ctypes.c_float)]


class _OrbTable(ctypes.Structure):
    """csrc/orb.cu's OrbTable, passed by pointer and copied into each
    launch's arguments."""
    _fields_ = [("n_levels", ctypes.c_int), ("n_cells", ctypes.c_int),
                ("n_slots", ctypes.c_int), ("margin", ctypes.c_int),
                ("th_high", ctypes.c_float), ("th_low", ctypes.c_float),
                ("gauss", ctypes.c_float * 7),
                ("umax", ctypes.c_int * (orientation.HALF_PATCH + 1)),
                ("lv", _LevelDesc * MAX_LEVELS)]


def check_kernel_limits(levels) -> None:
    """Raises for what the kernels do not take: more than MAX_LEVELS
    levels with a budget, or a level budget above MAX_BUDGET. Frame size
    is not limited."""
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"the ORB kernels take at most {MAX_LEVELS} levels "
                         f"with a budget, got {len(levels)}")
    most = max((lv.budget for lv in levels), default=0)
    if most > MAX_BUDGET:
        raise ValueError(f"the ORB kernels take at most {MAX_BUDGET} slots "
                         f"a level (orb_select's shared memory), got {most}")


@functools.lru_cache(maxsize=64)
def _table(levels: tuple, margin: int = 16, th_high: float = 20.0,
           th_low: float = 7.0) -> _OrbTable:
    check_kernel_limits(levels)
    t = _OrbTable()
    t.n_levels, t.n_cells, t.n_slots = (len(levels), n_cells(levels),
                                        n_slots(levels))
    t.margin, t.th_high, t.th_low = margin, th_high, th_low
    # the float32 weights gaussian_blur multiplies by
    t.gauss[:] = image.gaussian_kernel1d(7, 2.0).tolist()
    t.umax[:] = [int(u) for u in orientation.UMAX]
    for i, lv in enumerate(levels):
        t.lv[i] = _LevelDesc(lv.off, lv.h, lv.w, lv.budget, lv.slot, lv.cell,
                             lv.cy, lv.cx, lv.lvl,
                             float(np.float32(lv.scale)))
    return t


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.orb_table_bytes.argtypes = []
    lib.orb_table_bytes.restype = i
    lib.orb_cells.argtypes = [p, p, p, p, p, p, p]
    lib.orb_cells.restype = i
    lib.orb_select.argtypes = [p, p, p, p, p, p, p]
    lib.orb_select.restype = i
    lib.orb_describe.argtypes = [p, p, p, p, p, p, p, p, p, p, p]
    lib.orb_describe.restype = i
    return lib


_lib: ctypes.CDLL | None = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _bind(cuda_lib.load("orb"))
        got, want = lib.orb_table_bytes(), ctypes.sizeof(_OrbTable)
        if got != want:
            raise RuntimeError(f"csrc/orb.cu's OrbTable is {got} bytes, "
                               f"ops/orb.py's {want}")
        _lib = lib
    return _lib


def _check(*ts: torch.Tensor) -> tuple[bool, torch.device]:
    """(all on the CPU, the device); raises for tensors on several devices
    or on a device other than the CPU or CUDA."""
    dev = ts[0].device
    if all(t.device.type == "cpu" for t in ts):
        return True, dev
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("the ORB kernels take tensors on one CUDA device "
                         f"(got {[str(t.device) for t in ts]})")
    return False, dev


def _check_type(t: torch.Tensor, dtype, name: str) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError_t {err}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _packed_size(levels) -> int:
    return levels[-1].off + levels[-1].h * levels[-1].w if levels else 0


def cells(pyr: torch.Tensor, levels, margin: int = 16,
          th_high: float = 20.0, th_low: float = 7.0):
    """K2a: see cells_plain. One launch of orb_cells on a CUDA tensor."""
    _check_type(pyr, torch.float32, "pyr")
    if pyr.dim() != 1 or pyr.shape[0] < _packed_size(levels):
        raise ValueError(f"pyr must be the packed levels, [>= "
                         f"{_packed_size(levels)}], got {tuple(pyr.shape)}")
    on_cpu, dev = _check(pyr)
    if on_cpu:
        return cells_plain(pyr, levels, margin, th_high, th_low)
    t = _table(levels, margin, th_high, th_low)
    score = torch.empty_like(pyr)
    blurred = torch.empty_like(pyr)
    cand = torch.empty((2, t.n_cells, PER_CELL), dtype=torch.float32,
                       device=dev)  # one allocation: values, indices
    cand_v, cand_i = cand[0], cand[1].view(torch.int32)
    err = _kernel_lib().orb_cells(
        pyr.data_ptr(), score.data_ptr(), blurred.data_ptr(),
        cand_v.data_ptr(), cand_i.data_ptr(), ctypes.addressof(t),
        _stream(dev))
    _raise_on(err, "orb_cells")
    if t.n_cells:
        LAUNCHES["orb_cells"] += 1
    return score, blurred, cand_v, cand_i


def select(cand_v: torch.Tensor, cand_i: torch.Tensor, levels):
    """K2b: see select_plain. One launch of orb_select on CUDA tensors."""
    _check_type(cand_v, torch.float32, "cand_v")
    _check_type(cand_i, torch.int32, "cand_i")
    want = (n_cells(levels), PER_CELL)
    if tuple(cand_v.shape) != want or tuple(cand_i.shape) != want:
        raise ValueError(f"cand_v and cand_i must be {list(want)}, got "
                         f"{tuple(cand_v.shape)}, {tuple(cand_i.shape)}")
    on_cpu, dev = _check(cand_v, cand_i)
    if on_cpu:
        return select_plain(cand_v, cand_i, levels)
    t = _table(levels)  # selection reads no threshold
    n = t.n_slots
    yx = torch.empty((n, 2), dtype=torch.int32, device=dev)
    resp = torch.empty(n, dtype=torch.float32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    err = _kernel_lib().orb_select(
        cand_v.data_ptr(), cand_i.data_ptr(), yx.data_ptr(),
        resp.data_ptr(), valid.data_ptr(), ctypes.addressof(t),
        _stream(dev))
    _raise_on(err, "orb_select")
    if levels:
        LAUNCHES["orb_select"] += 1
    return yx, resp, valid


def describe(pyr: torch.Tensor, score: torch.Tensor, blurred: torch.Tensor,
             yx: torch.Tensor, levels):
    """K2c: see describe_plain. One launch of orb_describe on CUDA
    tensors."""
    for t_, name in ((pyr, "pyr"), (score, "score"), (blurred, "blurred")):
        _check_type(t_, torch.float32, name)
        if t_.dim() != 1 or t_.shape[0] < _packed_size(levels):
            raise ValueError(f"{name} must be packed levels, got "
                             f"{tuple(t_.shape)}")
    _check_type(yx, torch.int32, "yx")
    if tuple(yx.shape) != (n_slots(levels), 2):
        raise ValueError(f"yx must be int32 [{n_slots(levels)}, 2], got "
                         f"{tuple(yx.shape)}")
    on_cpu, dev = _check(pyr, score, blurred, yx)
    if on_cpu:
        return describe_plain(pyr, score, blurred, yx, levels)
    t = _table(levels)  # describing reads no threshold
    n = t.n_slots
    xy = torch.empty((n, 2), dtype=torch.float32, device=dev)
    octv = torch.empty(n, dtype=torch.int32, device=dev)
    ang = torch.empty(n, dtype=torch.float32, device=dev)
    desc = torch.empty((n, 8), dtype=torch.int32, device=dev)
    pattern = consts.on_device("brief.PATTERN", brief.PATTERN, dev)
    err = _kernel_lib().orb_describe(
        pyr.data_ptr(), score.data_ptr(), blurred.data_ptr(), yx.data_ptr(),
        pattern.data_ptr(), xy.data_ptr(), octv.data_ptr(), ang.data_ptr(),
        desc.data_ptr(), ctypes.addressof(t), _stream(dev))
    _raise_on(err, "orb_describe")
    if n:
        LAUNCHES["orb_describe"] += 1
    return xy, octv, ang, desc


def extract_levels(pyr: list, budgets, scales, margin: int = 16,
                   th_high: float = 20.0, th_low: float = 7.0):
    """ORB features of one view's pyramid ``pyr`` (a list of [h, w]
    float32 level images): (xy [N, 2], response [N], octave [N], angle [N],
    desc [N, 8] int32, valid [N]) for N = the sum of the positive
    ``budgets``, level by level as frontend/extractor.py's per-level loop
    gives them. On the CPU the plain chain; on CUDA one launch each of
    orb_cells, orb_select and orb_describe, reading nothing back."""
    for i, lvl_img in enumerate(pyr):
        if lvl_img.dim() != 2 or lvl_img.dtype != torch.float32:
            raise ValueError(f"level {i} must be float32 [h, w], got "
                             f"{lvl_img.dtype} {tuple(lvl_img.shape)}")
    _check(*pyr)
    levels = level_table(tuple(tuple(p.shape) for p in pyr), tuple(budgets),
                         tuple(scales))
    flat = torch.cat([p.reshape(-1) for p in pyr])
    if flat.device.type == "cpu":
        return extract_levels_plain(flat, levels, margin, th_high, th_low)
    score, blurred, cand_v, cand_i = cells(flat, levels, margin, th_high,
                                           th_low)
    yx, resp, valid = select(cand_v, cand_i, levels)
    xy, octv, ang, desc = describe(flat, score, blurred, yx, levels)
    return xy, resp, octv, ang, desc, valid
