"""Pose-only optimization (port of optim/pose_opt.py).

One SE3 pose per batch row against fixed landmarks: 4 rounds x 10 LM
iterations, Huber kernel in the first two rounds, chi2 inlier
reclassification between rounds, then one orthonormalization. The batch
axis carries the three independent solves of a tracking frame
(pipeline/steps.py track_frame_core) through one schedule.

``optimize_pose_plain`` is the plain PyTorch version. ``optimize_pose`` takes
it only for tensors on the CPU; for CUDA tensors it launches the
hand-written kernel of ``csrc/pose_lm.cu`` once, the whole schedule in one
launch, or raises, for any N (above 61,440 edges a pose through the
kernel's variants: a non-portable cluster of 16 blocks, then edges read
from global memory). ``LAUNCHES`` counts those launches;
``blocks_per_pose`` says how many thread blocks (one cluster) the kernel
gives a pose of N edges, ``streams`` whether it reads them from global
memory.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3
from ..ops import cuda_lib
from .residuals import (CHI2_MONO, CHI2_STEREO, HUBER_MONO, HUBER_STEREO,
                        CamParams, huber_weight, reproj_residual)


class PoseOptResult(NamedTuple):
    R: torch.Tensor  # [B, 3, 3]
    t: torch.Tensor  # [B, 3]
    inliers: torch.Tensor  # [B, N] bool
    n_inliers: torch.Tensor  # [B] int32
    chi2: torch.Tensor  # [B]


def _per_obs_chi2(cam, R, t, Xw, obs_uvr, inv_sigma2):
    e, _, _ = reproj_residual(cam, R[:, None], t[:, None], Xw, obs_uvr)
    return (e * e).sum(-1) * inv_sigma2


def _components(cam, R, t, Xw, obs_uvr, srow):
    """Residual [B, N, 3] and pose Jacobian [B, N, 3, 6] (left update)."""
    Xc = se3.transform(R[:, None], t[:, None], Xw)
    x, y = Xc[..., 0], Xc[..., 1]
    z = Xc[..., 2]
    z = torch.where(z.abs() < 1e-9, 1e-9, z)
    iz = 1.0 / z
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    e = torch.stack([obs_uvr[..., 0] - u, obs_uvr[..., 1] - v,
                     (obs_uvr[..., 2] - ur) * srow], -1)
    zero = torch.zeros_like(x)
    Jproj = torch.stack([
        torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1),
        torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1),
        torch.stack([(cam.fx * iz) * srow, zero,
                     (-cam.fx * x * iz2 + cam.bf * iz2) * srow], -1)], -2)
    Xc = torch.stack([x, y, z], -1)
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(Jproj.shape)
    return e, -(Jproj @ torch.cat([eye, -se3.hat(Xc)], -1))


def optimize_pose_plain(cam: CamParams, R0, t0, Xw, obs_uvr, inv_sigma2,
                        valid, rounds: int = 4,
                        iters_per_round: int = 10) -> PoseOptResult:
    """R0 [B,3,3], t0 [B,3]; Xw [B,N,3]; obs_uvr [N,3] or [B,N,3];
    inv_sigma2 [N] or [B,N]; valid [B,N] bool."""
    is_stereo = obs_uvr[..., 2] >= 0
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    delta = torch.where(is_stereo, HUBER_STEREO, HUBER_MONO)
    srow = is_stereo.to(obs_uvr.dtype)
    B, N = valid.shape
    dev = R0.device
    R, t = R0, t0
    lam = torch.full((B,), 1e-3, dtype=torch.float32, device=dev)
    inlier = torch.ones((B, N), dtype=torch.bool, device=dev)
    for rnd in range(rounds):
        robust = rnd < 2
        for _ in range(iters_per_round):
            e, Jp = _components(cam, R, t, Xw, obs_uvr, srow)
            chi2_i = (e * e).sum(-1) * inv_sigma2
            w_rob = huber_weight(chi2_i, delta) if robust else 1.0
            use = valid & inlier
            w = torch.where(use, inv_sigma2 * w_rob, 0.0)
            wJp = Jp * w[..., None, None]
            H = torch.einsum("bnri,bnrj->bij", wJp, Jp)
            b = torch.einsum("bnri,bnr->bi", wJp, e)
            D = torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)
                                 .clamp(min=1e-6))
            sol, _ = torch.linalg.solve_ex(H + lam[:, None, None] * D,
                                           b[..., None])
            delta_xi = -sol[..., 0]
            R_new, t_new = se3.retract(R, t, delta_xi)
            chi2_old = torch.where(use, chi2_i * w_rob, 0.0).sum(-1)
            chi2_new_i = _per_obs_chi2(cam, R_new, t_new, Xw, obs_uvr,
                                       inv_sigma2)
            w_rob_new = huber_weight(chi2_new_i, delta) if robust else 1.0
            chi2_new = torch.where(use, chi2_new_i * w_rob_new, 0.0).sum(-1)
            ok = (chi2_new < chi2_old) & torch.isfinite(delta_xi).all(-1)
            R = torch.where(ok[:, None, None], R_new, R)
            t = torch.where(ok[:, None], t_new, t)
            lam = torch.where(ok, lam * 0.5, lam * 4.0).clamp(1e-9, 1e6)
        inlier = _per_obs_chi2(cam, R, t, Xw, obs_uvr, inv_sigma2) <= chi2_th
    inlier = inlier & valid
    chi2_i = _per_obs_chi2(cam, R, t, Xw, obs_uvr, inv_sigma2)
    total = torch.where(inlier, chi2_i, 0.0).sum(-1)
    return PoseOptResult(se3.orthonormalize(R), t, inlier,
                         inlier.sum(-1, dtype=torch.int32), total)


LAUNCHES = {"pose_lm": 0}
# the launches, among LAUNCHES', of the kernel's variants above
# STAGED_EDGES edges a pose: a cluster of 16 staging them, or the edges
# read from global memory
VARIANT_LAUNCHES = {"pose_lm_cluster16": 0, "pose_lm_stream": 0}
# csrc/pose_lm.cu kMaxEdges: up to this many edges a pose, 8 blocks (a
# portable cluster) hold them in shared memory, 7680 edges of 29 bytes each
STAGED_EDGES = 61440
# the thresholds as the plain version's float32 tensors hold them
_THRESHOLDS = tuple(float(np.float32(v)) for v in (
    CHI2_MONO, CHI2_STEREO, HUBER_MONO, HUBER_STEREO))

_lib: ctypes.CDLL | None = None


def bind_solve(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Binds ``pose_lm_solve``, the C interface of csrc/pose_lm.cu and of
    csrc/pose_lm_v1.cu (the timing baseline)."""
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    lib.pose_lm_solve.argtypes = [p, p, p, p, ll, p, ll, p, f, f, f, f, f,
                                  f, f, f, f, i, i, i, i, p, p, p, p, p, p]
    lib.pose_lm_solve.restype = i
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    bind_solve(lib)
    for fn in (lib.pose_lm_blocks_per_pose, lib.pose_lm_streams):
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_int
    return lib


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _bind(cuda_lib.load("pose_lm"))
    return _lib


def blocks_per_pose(N: int) -> int:
    """The thread blocks, one cluster, that csrc/pose_lm.cu gives a pose
    of N edges on the current card (loads the kernel)."""
    return _kernel_lib().pose_lm_blocks_per_pose(N)


def streams(N: int) -> bool:
    """Whether csrc/pose_lm.cu reads a pose's N edges from global memory
    at every pass instead of staging them (loads the kernel)."""
    return bool(_kernel_lib().pose_lm_streams(N))


def empty_result(B: int, N: int, dev) -> PoseOptResult:
    """Uninitialized outputs of a solve of B poses against N edges."""
    return PoseOptResult(
        torch.empty((B, 3, 3), dtype=torch.float32, device=dev),
        torch.empty((B, 3), dtype=torch.float32, device=dev),
        torch.empty((B, N), dtype=torch.bool, device=dev),
        torch.empty((B,), dtype=torch.int32, device=dev),
        torch.empty((B,), dtype=torch.float32, device=dev))


def launch(lib: ctypes.CDLL, cam: CamParams, R0, t0, Xw, obs_uvr,
           inv_sigma2, valid, out: PoseOptResult, rounds: int = 4,
           iters_per_round: int = 10) -> int:
    """One launch of ``lib``'s pose_lm_solve on contiguous CUDA tensors
    into ``out`` (empty_result), on the current stream; returns its
    cudaError_t. The broadcast forms of obs_uvr and inv_sigma2 pass a
    batch stride of 0."""
    B, N = valid.shape
    return lib.pose_lm_solve(
        R0.data_ptr(), t0.data_ptr(), Xw.data_ptr(), obs_uvr.data_ptr(),
        3 * N if obs_uvr.dim() == 3 else 0, inv_sigma2.data_ptr(),
        N if inv_sigma2.dim() == 2 else 0, valid.data_ptr(),
        *(float(v) for v in cam), *_THRESHOLDS, rounds, iters_per_round, B,
        N, *(x.data_ptr() for x in out),
        torch.cuda.current_stream(R0.device).cuda_stream)


def _check_args(R0, t0, Xw, obs_uvr, inv_sigma2, valid) -> tuple[int, int]:
    """(B, N) of a call; raises on what the kernel does not take."""
    for name, x in (("R0", R0), ("t0", t0), ("Xw", Xw),
                    ("obs_uvr", obs_uvr), ("inv_sigma2", inv_sigma2)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
    if valid.dtype != torch.bool or valid.dim() != 2:
        raise ValueError(f"valid must be bool [B, N], got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    B, N = valid.shape
    if (tuple(R0.shape) != (B, 3, 3) or tuple(t0.shape) != (B, 3)
            or tuple(Xw.shape) != (B, N, 3)
            or tuple(obs_uvr.shape) not in ((N, 3), (B, N, 3))
            or tuple(inv_sigma2.shape) not in ((N,), (B, N))):
        got = [tuple(x.shape) for x in (R0, t0, Xw, obs_uvr, inv_sigma2)]
        raise ValueError(
            "expected R0 [B,3,3], t0 [B,3], Xw [B,N,3], obs_uvr [N,3] or "
            "[B,N,3], inv_sigma2 [N] or [B,N] for valid [B,N] = "
            f"{[B, N]}; got {got}")
    return B, N


def optimize_pose(cam: CamParams, R0, t0, Xw, obs_uvr, inv_sigma2, valid,
                  rounds: int = 4, iters_per_round: int = 10) -> PoseOptResult:
    """R0 [B,3,3], t0 [B,3]; Xw [B,N,3]; obs_uvr [N,3] or [B,N,3];
    inv_sigma2 [N] or [B,N]; valid [B,N] bool; all float32 but valid. On
    CUDA tensors one launch of csrc/pose_lm.cu, reading nothing back."""
    tensors = (R0, t0, Xw, obs_uvr, inv_sigma2, valid)
    B, N = _check_args(*tensors)
    if all(x.device.type == "cpu" for x in tensors):
        return optimize_pose_plain(cam, R0, t0, Xw, obs_uvr, inv_sigma2,
                                   valid, rounds, iters_per_round)
    dev = R0.device
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError("the pose LM kernel takes tensors on one CUDA "
                         f"device (got {[str(x.device) for x in tensors]})")
    out = empty_result(B, N, dev)
    err = launch(_kernel_lib(), cam, *(x.contiguous() for x in tensors), out,
                 rounds, iters_per_round)
    if err != 0:
        raise RuntimeError(f"pose_lm_solve launch failed: cudaError_t {err}")
    if B:
        LAUNCHES["pose_lm"] += 1
        if N > STAGED_EDGES:
            VARIANT_LAUNCHES["pose_lm_stream" if streams(N)
                             else "pose_lm_cluster16"] += 1
    return out
