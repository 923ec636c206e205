"""Matching primitives shared by every search mode (port of matching/core.py).

Every mode is a masked dense [queries x targets] Hamming problem: a
candidate mask from vectorized window / level / chi2 gates, then the fused
masked best-two of ops/hamming.py (K1), then the match tail: the ratio
test, the rotation-histogram consistency check, many-to-one collision
resolution and, where the caller asks, the assignment of the matches into
the frame's landmark map. Constants follow the reference
(ORBmatcher.cc:37-39, 1854-1895).

``match_tail_plain`` is the tail's plain PyTorch version, built from
``ratio_ok``, ``rotation_bins``, ``rotation_consistency``,
``dedupe_matches`` and ``set_last``. ``match_tail`` takes it only for
tensors on the CPU; for CUDA tensors it launches K7, the hand-written
kernel ``match_tail_kernel`` of ``csrc/hamming.cu``, once a call, or
raises. ``LAUNCHES`` counts those launches (kept apart from
``hamming.LAUNCHES``, which counts K1's).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..mapstate.map import set_last
from ..ops import cuda_lib, hamming
from ..ops.fast import sort_top_k

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
BIG = hamming.BIG
LAUNCHES = {"match_tail": 0}
# the launches, among LAUNCHES', of the instantiation whose per-target
# tables lie in global scratch (more than TAIL_SHARED targets)
VARIANT_LAUNCHES = {"match_tail_global": 0}
TAIL_SHARED = 2048  # csrc/hamming.cu kTailShared
RATIO_NONE, RATIO_ALWAYS, RATIO_SAME_LEVEL = 0, 1, 2


def masked_best_two(dist: torch.Tensor, mask: torch.Tensor):
    """Row-wise best and second-best of a distance matrix already computed,
    dist [Q, N] int32, over the candidates of mask [Q, N] bool: (best, idx,
    second), masked entries counted as BIG (the searches themselves call
    the fused hamming.masked_best_two)."""
    d = torch.where(mask, dist, BIG)
    best, idx = d.min(1)
    cols = torch.arange(d.shape[1], device=d.device)
    second = torch.where(cols == idx[:, None], BIG, d).amin(1)
    return best, idx.to(torch.int32), second


def ratio_ok(best: torch.Tensor, second: torch.Tensor, ratio: float):
    """Lowe-style test as the reference uses it: best < ratio * second."""
    return best.float() < ratio * second.float()


def rotation_bins(angle_q: torch.Tensor, angle_t: torch.Tensor):
    """30-bin histogram index of the angle difference (radians in)."""
    rot = (angle_q - angle_t) * (180.0 / math.pi)
    rot = torch.where(rot < 0, rot + 360.0, rot)
    b = torch.round(rot * (HISTO_LENGTH / 360.0)).to(torch.int32)
    return torch.where(b == HISTO_LENGTH, 0, b)


def rotation_consistency(bins: torch.Tensor, matched: torch.Tensor):
    """Keep matches whose rotation bin is among the top-3 bins; bins 2 and 3
    only when they hold at least 0.1x bin 1's count."""
    hist = torch.arange(HISTO_LENGTH, device=bins.device)
    counts = ((bins[:, None] == hist) & matched[:, None]).sum(0)
    top_v, top_i = sort_top_k(counts, 3)
    keep1 = bins == top_i[0]
    keep2 = (bins == top_i[1]) & (top_v[1] >= 0.1 * top_v[0])
    keep3 = (bins == top_i[2]) & (top_v[2] >= 0.1 * top_v[0])
    return matched & (keep1 | keep2 | keep3)


def dedupe_matches(idx: torch.Tensor, dist: torch.Tensor,
                   matched: torch.Tensor, n_targets: int):
    """Many-to-one collisions: keep the lowest-distance query per target,
    exact ties to the lowest query index."""
    d = torch.where(matched, dist, BIG)
    tgt = torch.where(matched, idx, n_targets).long()
    int_max = torch.iinfo(torch.int32).max
    best_per_tgt = torch.full((n_targets + 1,), int_max, dtype=d.dtype,
                              device=d.device).scatter_reduce(
        0, tgt, d, "amin")
    is_best = matched & (d == best_per_tgt[tgt])
    q_ids = torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device)
    first_q = torch.full((n_targets + 1,), int_max, dtype=torch.int32,
                         device=idx.device).scatter_reduce(
        0, tgt, torch.where(is_best, q_ids, 2 ** 30), "amin")
    return is_best & (q_ids == first_q[tgt])


def match_tail_plain(best, idx, second, idx2, n_targets: int, max_dist: int,
                     ratio: float | None = None, octave_t=None, angle_q=None,
                     angle_t=None, dedupe: bool = True, values=None,
                     frame_lm=None, out=None):
    """What a search does after the best-two (best, idx, second, idx2 [Q]
    int32 over n_targets targets): matched = best <= max_dist; the ratio
    test with ``ratio`` (only where octave_t [N] of the best and second
    targets agree, when octave_t is given); the rotation consistency of
    angle_q [Q] against angle_t [N] at the best target, when given; the
    dedupe, when asked. With ``values`` [Q] int32, writes into ``out`` [N]
    int32 the frame's landmark map frame_lm (all -1 when None) with
    frame_lm[idx] = values for the matched queries; unmatched queries
    rewrite slot 0 with its own value, the last write winning (set_last).
    Returns (idx [Q] target per query, dist [Q], matched [Q] bool)."""
    matched = best <= max_dist
    if ratio is not None:
        ok = ratio_ok(best, second, ratio)
        if octave_t is not None:
            ok = torch.where(octave_t[idx] == octave_t[idx2], ok, True)
        matched &= ok
    if angle_q is not None:
        matched = rotation_consistency(
            rotation_bins(angle_q, angle_t[idx]), matched)
    if dedupe:
        matched = dedupe_matches(idx, best, matched, n_targets)
    if values is not None:
        if frame_lm is None:
            frame_lm = torch.full((n_targets,), -1, dtype=torch.int32,
                                  device=idx.device)
        safe = torch.where(matched, idx, 0)
        out.copy_(set_last(frame_lm, safe, torch.where(
            matched, values, frame_lm[safe.long()])))
    return idx, best, matched


_lib: ctypes.CDLL | None = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_lib.load("hamming")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hamming_match_tail.argtypes = [p] * 12 + [i, i, i, ctypes.c_float,
                                                      i, i, p]
        lib.hamming_match_tail.restype = i
        _lib = lib
    return _lib


def match_tail(best, idx, second, idx2, n_targets: int, max_dist: int,
               ratio: float | None = None, octave_t=None, angle_q=None,
               angle_t=None, dedupe: bool = True, values=None,
               frame_lm=None, out=None):
    """match_tail_plain on the CPU; on CUDA tensors one launch of K7,
    whose outputs (and ``out``) are the plain version's bits, or an
    error."""
    q = best.shape[0]
    if (angle_q is None) != (angle_t is None):
        raise ValueError("angle_q and angle_t come together")
    if octave_t is not None and ratio is None:
        raise ValueError("octave_t is the ratio test's same-level rule")
    if (values is None) != (out is None):
        raise ValueError("values and out come together")
    if frame_lm is not None and values is None:
        raise ValueError("frame_lm is assigned into only with values")
    if n_targets < 1:
        raise ValueError("match_tail needs at least one target")
    shapes = {"best": (best, q, torch.int32), "idx": (idx, q, torch.int32),
              "second": (second, q, torch.int32),
              "idx2": (idx2, q, torch.int32),
              "octave_t": (octave_t, n_targets, torch.int32),
              "angle_q": (angle_q, q, torch.float32),
              "angle_t": (angle_t, n_targets, torch.float32),
              "values": (values, q, torch.int32),
              "frame_lm": (frame_lm, n_targets, torch.int32),
              "out": (out, n_targets, torch.int32)}
    given = {k: v for k, v in shapes.items() if v[0] is not None}
    for name, (t, size, dtype) in given.items():
        if t.dtype != dtype or tuple(t.shape) != (size,):
            raise ValueError(f"{name} must be {dtype} [{size}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if out is not None and not out.is_contiguous():
        raise ValueError("out must be contiguous")
    ts = [t for t, _, _ in given.values()]
    if all(t.device.type == "cpu" for t in ts):
        return match_tail_plain(best, idx, second, idx2, n_targets, max_dist,
                                ratio, octave_t, angle_q, angle_t, dedupe,
                                values, frame_lm, out)
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("match_tail takes tensors on one CUDA device (got "
                         f"{[str(t.device) for t in ts]})")
    matched = torch.empty(q, dtype=torch.bool, device=dev)
    if q:
        wide = launch_tail(given, matched, q, n_targets, max_dist, ratio,
                           dedupe)
        LAUNCHES["match_tail"] += 1
        VARIANT_LAUNCHES["match_tail_global"] += wide
    elif frame_lm is not None:  # nothing to launch: the map as it was
        out.copy_(frame_lm)
    elif out is not None:
        out.fill_(-1)
    return idx, best, matched


def launch_tail(given: dict, matched, q: int, n: int, max_dist: int, ratio,
                dedupe: bool) -> bool:
    """One launch of K7 on the CUDA tensors of ``given`` (match_tail's
    arguments by name, checked; ``out`` contiguous); returns whether it
    took the global-scratch instantiation."""
    args = {k: t.contiguous() for k, (t, _, _) in given.items()}
    wide = n > TAIL_SHARED and (dedupe or "out" in args)
    # the per-target keys (8 bytes) and last writers (4 bytes)
    scratch = (torch.empty(3 * n, dtype=torch.int32, device=matched.device)
               if wide else None)
    if ratio is None:
        mode = RATIO_NONE
    else:
        mode = RATIO_ALWAYS if "octave_t" not in args else RATIO_SAME_LEVEL

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _kernel_lib().hamming_match_tail(
        *(ptr(args.get(k)) for k in ("best", "idx", "second", "idx2",
                                      "octave_t", "angle_q", "angle_t",
                                      "values", "frame_lm")),
        matched.data_ptr(), ptr(args.get("out")), ptr(scratch), q, n,
        int(max_dist), 0.0 if ratio is None else float(ratio), mode,
        int(dedupe),
        torch.cuda.current_stream(matched.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"hamming_match_tail launch failed: cudaError_t {err}")
    return wide


def windowed_match(desc_q, desc_t, cand_mask, max_dist: int,
                   ratio: float | None = None, angle_q=None, angle_t=None,
                   dedupe: bool = True, values=None, out=None):
    """One-direction matcher: (idx [Q] target per query, dist [Q],
    matched [Q] bool), K1 then the match tail; with ``values`` [Q] the
    matches are also assigned into a fresh frame map written to ``out``
    [N] (match_tail_plain)."""
    best, idx, second, idx2 = hamming.masked_best_two(desc_q, desc_t,
                                                      cand_mask)
    return match_tail(best, idx, second, idx2, desc_t.shape[0], max_dist,
                      ratio, angle_q=angle_q, angle_t=angle_t, dedupe=dedupe,
                      values=values, out=out)
