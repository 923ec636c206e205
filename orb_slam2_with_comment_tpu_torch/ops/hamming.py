"""Batched 256-bit Hamming distance (XOR + popcount) and the fused matcher.

Port of orb_slam2_with_comment_tpu/ops/hamming.py and of its Pallas kernel
(ops/hamming_pallas.py). Descriptors are ``int32 [N, 8]`` tensors holding the
same 32-bit patterns as the JAX package's ``uint32 [N, 8]``.

Each entry point has a plain PyTorch version (``*_plain``) and a wrapper.
The wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the hand-written kernel of ``csrc/hamming.cu`` or
raises. ``LAUNCHES`` counts the kernel launches per entry point.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib

BIG = 10_000  # matching/core.py: distance of a masked candidate
MAX_TARGETS = 1 << 22  # the fused kernel's keys hold a column in 22 bits
LAUNCHES = {"distance_matrix": 0, "masked_best_two": 0}
_CHUNK_ELEMS = 1 << 22  # bounds the plain versions' [rows, N, 8] temporaries


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each int32 word (SWAR; the arithmetic shifts are masked)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming distance of broadcastable [..., 8] int32."""
    return popcount32(a ^ b).sum(-1, dtype=torch.int32)


def distance_matrix_plain(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """[N1, 8] x [N2, 8] int32 -> [N1, N2] int32 Hamming distances."""
    rows = max(1, _CHUNK_ELEMS // max(8 * d2.shape[0], 1))
    parts = [hamming_pair(d1[i:i + rows, None, :], d2[None, :, :])
             for i in range(0, d1.shape[0], rows)]
    if not parts:
        return torch.zeros((0, d2.shape[0]), dtype=torch.int32,
                           device=d1.device)
    return torch.cat(parts)


def masked_best_two_plain(dq, dt, mask):
    """Row-wise lexicographic (distance, column) top-2 over masked candidates.

    dq [Q, 8], dt [N, 8] int32, mask [Q, N] bool ->
    (best, idx, second, idx2), each [Q] int32. A masked entry counts as BIG;
    ``idx`` is the first column of the minimum, ``second`` the minimum over
    the other columns (equal to ``best`` when the minimum repeats) and
    ``idx2`` the first column attaining it. With N = 1, second = BIG and
    idx2 = 0. The first three are matching/core.masked_best_two's outputs.
    """
    d = torch.where(mask, distance_matrix_plain(dq, dt), BIG)
    idx = torch.argmin(d, dim=1)
    best = d.gather(1, idx[:, None])[:, 0]
    cols = torch.arange(d.shape[1], device=d.device)
    d_ex = torch.where(cols[None, :] == idx[:, None], BIG + 1, d)
    idx2 = torch.argmin(d_ex, dim=1)
    second = d_ex.gather(1, idx2[:, None])[:, 0].clamp(max=BIG)
    return (best.to(torch.int32), idx.to(torch.int32),
            second.to(torch.int32), idx2.to(torch.int32))


_lib: ctypes.CDLL | None = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_lib.load("hamming")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hamming_distance_matrix.argtypes = [p, p, p, i, i, p]
        lib.hamming_distance_matrix.restype = i
        lib.hamming_masked_best_two.argtypes = [p, p, p, p, p, p, p, i, i, p]
        lib.hamming_masked_best_two.restype = i
        _lib = lib
    return _lib


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check_cuda(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("hamming kernels take tensors on one CUDA device "
                         f"(got {[str(t.device) for t in ts]})")
    return dev


def _check_desc(d: torch.Tensor, name: str) -> None:
    if d.dtype != torch.int32 or d.dim() != 2 or d.shape[1] != 8:
        raise ValueError(f"{name} must be int32 [N, 8], got {d.dtype} "
                         f"{tuple(d.shape)}")
    if not d.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _aligned(d: torch.Tensor) -> torch.Tensor:
    """The kernels read a descriptor as two 16-byte words: a view that
    starts off a 16-byte boundary is copied to fresh storage."""
    return d if d.data_ptr() % 16 == 0 else d.clone()


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError_t {err}")


def distance_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """[N1, 8] x [N2, 8] int32 -> [N1, N2] int32 Hamming distances."""
    _check_desc(d1, "d1")
    _check_desc(d2, "d2")
    if _on_cpu(d1, d2):
        return distance_matrix_plain(d1, d2)
    dev = _check_cuda(d1, d2)
    d1, d2 = _aligned(d1), _aligned(d2)
    out = torch.empty((d1.shape[0], d2.shape[0]), dtype=torch.int32,
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel_lib().hamming_distance_matrix(
        d1.data_ptr(), d2.data_ptr(), out.data_ptr(), d1.shape[0],
        d2.shape[0], stream)
    _raise_on(err, "hamming_distance_matrix")
    if out.numel():
        LAUNCHES["distance_matrix"] += 1
    return out


def masked_best_two(dq: torch.Tensor, dt: torch.Tensor, mask: torch.Tensor):
    """Fused distance matrix + masked best-two (see masked_best_two_plain);
    the [Q, N] distances never reach device memory on the CUDA path."""
    _check_desc(dq, "dq")
    _check_desc(dt, "dt")
    q, n = dq.shape[0], dt.shape[0]
    if n == 0:
        raise ValueError("masked_best_two needs at least one target")
    if mask.dtype != torch.bool or tuple(mask.shape) != (q, n):
        raise ValueError(f"mask must be bool [{q}, {n}], got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if _on_cpu(dq, dt, mask):
        return masked_best_two_plain(dq, dt, mask)
    dev = _check_cuda(dq, dt, mask)
    if n > MAX_TARGETS:
        raise ValueError(f"the masked_best_two kernel takes at most "
                         f"{MAX_TARGETS} targets, got {n}")
    dq, dt, mask = _aligned(dq), _aligned(dt), mask.contiguous()
    outs = torch.empty((4, q), dtype=torch.int32, device=dev)  # one alloc
    base = outs.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel_lib().hamming_masked_best_two(
        dq.data_ptr(), dt.data_ptr(), mask.data_ptr(),
        *(base + 4 * q * i for i in range(4)), q, n, stream)
    _raise_on(err, "hamming_masked_best_two")
    if q:
        LAUNCHES["masked_best_two"] += 1
    return tuple(outs.unbind(0))


def best_two(dist: torch.Tensor, valid: torch.Tensor | None = None,
             big: int = BIG):
    """Row-wise best and second-best of a given distance matrix [..., M]
    (M >= 2), entries outside ``valid`` counted as ``big``: (best, index
    of its first occurrence, second), where second equals best when the
    minimum repeats. A plain top-2 of a matrix already computed, not a
    kernel."""
    if valid is not None:
        dist = torch.where(valid, dist, big)
    best, idx = dist.min(-1)
    info = torch.finfo if dist.is_floating_point() else torch.iinfo
    cols = torch.arange(dist.shape[-1], device=dist.device)
    second = torch.where(cols == idx[..., None], info(dist.dtype).max,
                         dist).amin(-1)
    return best, idx.to(torch.int32), second
