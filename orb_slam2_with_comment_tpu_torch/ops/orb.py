"""ORB extraction of every pyramid level of one view in three kernels (K2).

Port of the JAX package's extraction program (frontend/extractor.py,
``_extract_from_pyramid`` and ``_level_features``, on ops/fast.py,
ops/image.py, ops/orientation.py and ops/brief.py): XLA ops there, not a
Pallas kernel. Here the per-level work of all levels runs as three
hand-written kernels of ``csrc/orb.cu``, one launch each per view:

- ``cells``: per strip of 32x32 cells along a row of every level (one
  block each), the masked FAST score (arcs on the pixels' bits with
  Hopper's three-input integer minima where the tile holds no negative
  value), 3x3 NMS, each cell's 20 -> 7 threshold and its top 8 corners
  (each warp ranks its list of kept values, one warp a cell its warps'
  8s), and the rounded 7x7 blur; for any other cell side or candidate
  count, ``orb_cells_any`` (one block a cell, the pair read from the
  table);
- ``select``: per level, the spatial round-robin top-``budget`` of the
  cells' candidates;
- ``describe``: per output slot (one block each, every load that does not
  wait on the angle issued first), the IC angle, the rotated BRIEF
  descriptor, the subpixel position and the octave.

The levels are packed into one flat float32 buffer (each level's pixels
row-major, level after level); the score and blurred buffers are packed
the same way. ``level_table`` says where each level with a budget above 0
lies, for any frame size, level count and cell side. The kernels take any
of them: above MAX_LEVELS levels the table's levels go to device memory,
above MAX_BUDGET slots a level orb_select ranks through global scratch
(csrc/orb.cu's header). Each kernel has a plain PyTorch version at its own interface
(``cells_plain``, ``select_plain``, ``describe_plain``) built from the
port's per-level functions, and ``extract_levels_plain`` chains them: it
equals frontend/extractor.py's per-level loop bit for bit. The wrappers
take the plain versions only for tensors on the CPU; for CUDA tensors they
launch the kernels or raise. ``LAUNCHES`` counts the launches.
``launch_cells`` and ``launch_describe`` launch a given library's kernels
(the package's, or chip_smoke.py's PR 10 baseline, csrc/orb_v1.cu);
``resident_blocks`` asks the runtime how many blocks of each fit an SM.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import brief, consts, cuda_lib, fast, image, orientation

CELL = 32  # the default cell side (the strip kernel's)
PER_CELL = 8  # the default candidates per cell
MAX_LEVELS = 16  # levels csrc/orb.cu's OrbTable holds by value
MAX_BUDGET = 28672  # slots orb_select ranks in 224 KB of shared memory
LAUNCHES = {"orb_cells": 0, "orb_select": 0, "orb_describe": 0}
# the launches, among LAUNCHES', of the kernels' variants for other shapes:
# orb_cells_any (another cell side or count), any of the three with its
# level table in device memory (more than MAX_LEVELS levels), orb_select
# ranking through global scratch (a level above MAX_BUDGET slots)
VARIANT_LAUNCHES = {"orb_cells_any": 0, "orb_far": 0, "orb_select_global": 0}


def _count_far(levels) -> None:
    if len(levels) > MAX_LEVELS:
        VARIANT_LAUNCHES["orb_far"] += 1


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
    side: int = CELL  # the cell side in pixels

    @property
    def cy(self) -> int:
        return -(-self.h // self.side)

    @property
    def cx(self) -> int:
        return -(-self.w // self.side)


@functools.lru_cache(maxsize=64)
def level_table(sizes: tuple, budgets: tuple, scales: tuple,
                cell: int = CELL) -> tuple[Level, ...]:
    """The levels of a pyramid of level sizes ``sizes`` ((h, w) each)
    whose budget is above 0, in level order, cut into cells of side
    ``cell``."""
    out, off, slot, first = [], 0, 0, 0
    for lvl, ((h, w), budget, scale) in enumerate(zip(sizes, budgets,
                                                      scales)):
        lv = Level(lvl, off, h, w, budget, slot, first, scale, cell)
        if budget > 0:
            out.append(lv)
            slot += budget
            first += lv.cy * lv.cx
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
                th_high: float = 20.0, th_low: float = 7.0,
                per_cell: int = PER_CELL):
    """pyr [P] packed levels -> (score [P], blurred [P], cand_v [C,
    per_cell] float32, cand_i [C, per_cell] int32) for the C cells of
    ``levels`` (of their cell side); pixels of levels outside ``levels``
    are left unset in score and blurred."""
    score = torch.empty_like(pyr)
    blurred = torch.empty_like(pyr)
    vs, idx = [], []
    for lv in levels:
        img = _view(pyr, lv)
        s = masked_score(img, margin)
        _view(score, lv).copy_(s)
        _view(blurred, lv).copy_(torch.round(image.gaussian_blur(img)))
        v, i = fast.cell_candidates(s, lv.side, per_cell, th_high, th_low)
        vs.append(v.reshape(-1, per_cell))
        idx.append(i.reshape(-1, per_cell).to(torch.int32))
    if not vs:
        return (score, blurred, pyr.new_zeros((0, per_cell)),
                torch.zeros((0, per_cell), dtype=torch.int32,
                            device=pyr.device))
    return score, blurred, torch.cat(vs), torch.cat(idx)


def select_plain(cand_v: torch.Tensor, cand_i: torch.Tensor, levels):
    """-> (yx [N, 2] int32, response [N] float32, valid [N] bool), the N
    slots of ``levels`` in level order."""
    parts = []
    per_cell = cand_v.shape[1]
    for lv in levels:
        cut = slice(lv.cell, lv.cell + lv.cy * lv.cx)
        parts.append(fast.select_from_candidates(
            cand_v[cut].view(lv.cy, lv.cx, per_cell),
            cand_i[cut].view(lv.cy, lv.cx, per_cell), lv.budget, lv.side))
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
                         th_high: float = 20.0, th_low: float = 7.0,
                         per_cell: int = PER_CELL):
    """The three plain versions chained: (xy, response, octave, angle,
    desc, valid), FrameFeatures' order."""
    score, blurred, cand_v, cand_i = cells_plain(pyr, levels, margin,
                                                 th_high, th_low, per_cell)
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
    launch's arguments. Above MAX_LEVELS levels ``levels`` (device memory)
    and ``host_levels`` hold them all and ``lv`` is not read. ``cell_side``
    and ``per_cell``: the cells' side and the candidates each keeps."""
    _fields_ = [("n_levels", ctypes.c_int), ("n_cells", ctypes.c_int),
                ("n_slots", ctypes.c_int), ("margin", ctypes.c_int),
                ("th_high", ctypes.c_float), ("th_low", ctypes.c_float),
                ("gauss", ctypes.c_float * 7),
                ("umax", ctypes.c_int * (orientation.HALF_PATCH + 1)),
                ("lv", _LevelDesc * MAX_LEVELS),
                ("levels", ctypes.c_void_p), ("host_levels", ctypes.c_void_p),
                ("cell_side", ctypes.c_int), ("per_cell", ctypes.c_int)]


# the bytes of csrc/orb_v1.cu's OrbTable: this one's up to the end of ``lv``
V1_TABLE_BYTES = _OrbTable.lv.offset + _OrbTable.lv.size


@functools.lru_cache(maxsize=64)
def _table(levels: tuple, margin: int = 16, th_high: float = 20.0,
           th_low: float = 7.0, device: torch.device | None = None,
           per_cell: int = PER_CELL) -> _OrbTable:
    """The kernels' table of ``levels`` with ``per_cell`` candidates a
    cell; above MAX_LEVELS levels its levels are also copied to ``device``
    (the table keeps both copies)."""
    t = _OrbTable()
    t.n_levels, t.n_cells, t.n_slots = (len(levels), n_cells(levels),
                                        n_slots(levels))
    t.cell_side, t.per_cell = _side(levels), per_cell
    t.margin, t.th_high, t.th_low = margin, th_high, th_low
    # the float32 weights gaussian_blur multiplies by
    t.gauss[:] = image.gaussian_kernel1d(7, 2.0).tolist()
    t.umax[:] = [int(u) for u in orientation.UMAX]
    descs = [_LevelDesc(lv.off, lv.h, lv.w, lv.budget, lv.slot, lv.cell,
                        lv.cy, lv.cx, lv.lvl, float(np.float32(lv.scale)))
             for lv in levels]
    if len(levels) <= MAX_LEVELS:
        for i, d in enumerate(descs):
            t.lv[i] = d
        return t
    host = (_LevelDesc * len(descs))(*descs)
    dev = torch.frombuffer(bytearray(host), dtype=torch.uint8).to(device)
    t.levels, t.host_levels = dev.data_ptr(), ctypes.addressof(host)
    t.keep = (host, dev)
    return t


# csrc/orb.cu's extern "C" functions: the number of pointer arguments each
# takes (csrc/orb_v1.cu has orb_table_bytes, orb_resident_blocks,
# orb_cells and orb_describe of them)
SIGNATURES = {"orb_table_bytes": 0, "orb_resident_blocks": 1,
              "orb_cells": 7, "orb_cells_any": 8, "orb_select": 8,
              "orb_describe": 11}


def _bind(lib: ctypes.CDLL, names=tuple(SIGNATURES)) -> ctypes.CDLL:
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def _side(levels) -> int:
    return levels[0].side if levels else CELL


def strip_kernel(cell: int, per_cell: int) -> bool:
    """Whether (cell, per_cell) takes the strip kernel orb_cells, else
    orb_cells_any."""
    return (cell, per_cell) == (CELL, PER_CELL)


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
          th_high: float = 20.0, th_low: float = 7.0,
          per_cell: int = PER_CELL):
    """K2a: see cells_plain. One launch of orb_cells (orb_cells_any for
    another cell side or count) on a CUDA tensor."""
    _check_type(pyr, torch.float32, "pyr")
    if pyr.dim() != 1 or pyr.shape[0] < _packed_size(levels):
        raise ValueError(f"pyr must be the packed levels, [>= "
                         f"{_packed_size(levels)}], got {tuple(pyr.shape)}")
    on_cpu, _ = _check(pyr)
    if on_cpu:
        return cells_plain(pyr, levels, margin, th_high, th_low, per_cell)
    out = launch_cells(_kernel_lib(), pyr, levels, margin, th_high, th_low,
                       per_cell)
    if n_cells(levels):
        LAUNCHES["orb_cells"] += 1
        _count_far(levels)
        if not strip_kernel(_side(levels), per_cell):
            VARIANT_LAUNCHES["orb_cells_any"] += 1
    return out


def launch_cells(lib: ctypes.CDLL, pyr: torch.Tensor, levels,
                 margin: int = 16, th_high: float = 20.0,
                 th_low: float = 7.0, per_cell: int = PER_CELL):
    """orb_cells of ``lib`` on a checked CUDA tensor (orb_cells_any, with
    its scratch, for another cell side or count):
    allocates the outputs, launches on the current stream, raises on a
    launch error. cells' one launch; chip_smoke.py also gives it
    csrc/orb_v1.cu's library."""
    dev = pyr.device
    t = _table(levels, margin, th_high, th_low, dev, per_cell)
    score = torch.empty_like(pyr)
    blurred = torch.empty_like(pyr)
    cand = torch.empty((2, t.n_cells, per_cell), dtype=torch.float32,
                       device=dev)  # one allocation: values, indices
    cand_v, cand_i = cand[0], cand[1].view(torch.int32)
    side = _side(levels)
    args = [pyr.data_ptr(), score.data_ptr(), blurred.data_ptr(),
            cand_v.data_ptr(), cand_i.data_ptr()]
    if strip_kernel(side, per_cell):
        err = lib.orb_cells(*args, ctypes.addressof(t), _stream(dev))
        _raise_on(err, "orb_cells")
    else:
        # each cell's scores with a 1 px halo and its kept values
        scratch = torch.empty(
            t.n_cells * ((side + 2) ** 2 + side * side), dtype=torch.float32,
            device=dev)
        err = lib.orb_cells_any(*args, scratch.data_ptr(),
                                ctypes.addressof(t), _stream(dev))
        _raise_on(err, "orb_cells_any")
    return score, blurred, cand_v, cand_i


def select(cand_v: torch.Tensor, cand_i: torch.Tensor, levels):
    """K2b: see select_plain. One launch of orb_select on CUDA tensors."""
    _check_type(cand_v, torch.float32, "cand_v")
    _check_type(cand_i, torch.int32, "cand_i")
    per_cell = cand_v.shape[1] if cand_v.dim() == 2 else -1
    want = (n_cells(levels), per_cell)
    if (cand_v.dim() != 2 or tuple(cand_v.shape) != want
            or tuple(cand_i.shape) != want):
        raise ValueError(f"cand_v and cand_i must be [{n_cells(levels)}, "
                         f"per_cell], got {tuple(cand_v.shape)}, "
                         f"{tuple(cand_i.shape)}")
    on_cpu, dev = _check(cand_v, cand_i)
    if on_cpu:
        return select_plain(cand_v, cand_i, levels)
    t = _table(levels, device=dev, per_cell=per_cell)  # and no threshold
    n = t.n_slots
    yx = torch.empty((n, 2), dtype=torch.int32, device=dev)
    resp = torch.empty(n, dtype=torch.float32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    # the winners of a level above MAX_BUDGET slots: a word a slot
    big = max((lv.budget for lv in levels), default=0) > MAX_BUDGET
    scratch = torch.empty(n if big else 0, dtype=torch.int64, device=dev)
    err = _kernel_lib().orb_select(
        cand_v.data_ptr(), cand_i.data_ptr(), yx.data_ptr(),
        resp.data_ptr(), valid.data_ptr(),
        scratch.data_ptr() if big else None, ctypes.addressof(t),
        _stream(dev))
    _raise_on(err, "orb_select")
    if levels:
        LAUNCHES["orb_select"] += 1
        _count_far(levels)
        if big:
            VARIANT_LAUNCHES["orb_select_global"] += 1
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
    on_cpu, _ = _check(pyr, score, blurred, yx)
    if on_cpu:
        return describe_plain(pyr, score, blurred, yx, levels)
    out = launch_describe(_kernel_lib(), pyr, score, blurred, yx, levels)
    if n_slots(levels):
        LAUNCHES["orb_describe"] += 1
        _count_far(levels)
    return out


def launch_describe(lib: ctypes.CDLL, pyr: torch.Tensor, score: torch.Tensor,
                    blurred: torch.Tensor, yx: torch.Tensor, levels):
    """orb_describe of ``lib`` on checked CUDA tensors, as launch_cells."""
    dev = pyr.device
    t = _table(levels, device=dev)  # describing reads no threshold
    n = t.n_slots
    xy = torch.empty((n, 2), dtype=torch.float32, device=dev)
    octv = torch.empty(n, dtype=torch.int32, device=dev)
    ang = torch.empty(n, dtype=torch.float32, device=dev)
    desc = torch.empty((n, 8), dtype=torch.int32, device=dev)
    pattern = consts.on_device("brief.PATTERN", brief.PATTERN, dev)
    err = lib.orb_describe(
        pyr.data_ptr(), score.data_ptr(), blurred.data_ptr(), yx.data_ptr(),
        pattern.data_ptr(), xy.data_ptr(), octv.data_ptr(), ang.data_ptr(),
        desc.data_ptr(), ctypes.addressof(t), _stream(dev))
    _raise_on(err, "orb_describe")
    return xy, octv, ang, desc


def resident_blocks(lib: ctypes.CDLL | None = None) -> tuple[int, int]:
    """(orb_cells, orb_describe) blocks resident on one SM of the current
    CUDA device at their launch shapes (cudaOccupancyMaxActiveBlocksPer-
    Multiprocessor), for ``lib`` or the package's kernels."""
    out = (ctypes.c_int * 2)()
    _raise_on((lib or _kernel_lib()).orb_resident_blocks(ctypes.addressof(out)),
              "orb_resident_blocks")
    return out[0], out[1]


def pack(pyr: list) -> torch.Tensor:
    """A pyramid's levels concatenated row-major, level after level: the
    packed buffer the kernels read (Level.off is a level's first pixel)."""
    return torch.cat([p.reshape(-1) for p in pyr])


def extract_levels(pyr: list, budgets, scales, margin: int = 16,
                   th_high: float = 20.0, th_low: float = 7.0,
                   flat: torch.Tensor | None = None, cell: int = CELL,
                   per_cell: int = PER_CELL):
    """ORB features of one view's pyramid ``pyr`` (a list of [h, w]
    float32 level images): (xy [N, 2], response [N], octave [N], angle [N],
    desc [N, 8] int32, valid [N]) for N = the sum of the positive
    ``budgets``, level by level as frontend/extractor.py's per-level loop
    gives them, the top ``per_cell`` corners of each ``cell`` px cell
    competing. On the CPU the plain chain; on CUDA one launch each of
    orb_cells, orb_select and orb_describe, reading nothing back.
    ``flat``: pack(pyr), where the caller has it already."""
    for i, lvl_img in enumerate(pyr):
        if lvl_img.dim() != 2 or lvl_img.dtype != torch.float32:
            raise ValueError(f"level {i} must be float32 [h, w], got "
                             f"{lvl_img.dtype} {tuple(lvl_img.shape)}")
    _check(*pyr)
    levels = level_table(tuple(tuple(p.shape) for p in pyr), tuple(budgets),
                         tuple(scales), cell)
    if flat is None:
        flat = pack(pyr)
    if flat.device.type == "cpu":
        return extract_levels_plain(flat, levels, margin, th_high, th_low,
                                    per_cell)
    score, blurred, cand_v, cand_i = cells(flat, levels, margin, th_high,
                                           th_low, per_cell)
    yx, resp, valid = select(cand_v, cand_i, levels)
    xy, octv, ang, desc = describe(flat, score, blurred, yx, levels)
    return xy, resp, octv, ang, desc, valid
