"""Levenberg-Marquardt bundle adjustment on the Schur complement (port of
optim/ba.py: ba_solve and ba_solve_cg).

Fixed-shape landmark-major problem: P poses, L landmarks, D observation
slots per landmark. Each iteration builds residuals and Jacobians over the
[L, D] table and inverts the [L] 3x3 landmark blocks; ``ba_solve`` then
assembles the reduced camera system [6P, 6P] and solves it densely (fixed
poses get identity rows), ``ba_solve_cg`` solves it by preconditioned
conjugate gradients without assembling it. Steps are accepted only when
the robust-weighted chi2 decreases.

``ba_solve_plain`` is the dense solver's plain PyTorch version.
``ba_solve`` takes it only for tensors on the CPU; for CUDA tensors a
whole solve is one launch of the hand-written kernel of ``csrc/ba.cu``
(K4: every iteration's linearization, reduced camera system, its Cholesky
factorization and solve in float64, back-substitution, retract and accept
test), or raises. ``LAUNCHES`` counts those launches. ``ba_solve_cg``
stays plain.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3
from ..ops import cuda_lib
from .pcg import block_pcg
from .residuals import HUBER_MONO, HUBER_STEREO, CamParams, huber_weight


class BAProblem(NamedTuple):
    R: torch.Tensor  # [P, 3, 3]
    t: torch.Tensor  # [P, 3]
    X: torch.Tensor  # [L, 3]
    obs_pose: torch.Tensor  # [L, D] long pose index (0 where invalid)
    obs_uvr: torch.Tensor  # [L, D, 3]; u_r < 0 => mono
    obs_w: torch.Tensor  # [L, D] invSigma2; 0 => absent
    pose_fixed: torch.Tensor  # [P] bool
    point_valid: torch.Tensor  # [L] bool


class BAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    chi2: torch.Tensor  # total weighted chi2 at the result
    obs_chi2: torch.Tensor  # [L, D] per-observation chi2
    final_lambda: torch.Tensor  # LM damping to resume the next chunk with


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A, B, C = e * i - f * h, c * h - b * i, b * f - c * e
    Dd, E, F = f * g - d * i, a * i - c * g, c * d - a * f
    G, H, Ii = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A + b * Dd + c * G
    inv_det = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)
    adj = torch.stack([torch.stack([A, B, C], -1), torch.stack([Dd, E, F], -1),
                       torch.stack([G, H, Ii], -1)], -2)
    return adj * inv_det[..., None, None]


def _project(cam, Robs, tobs, X):
    """Camera-frame points [L, D, 3] of X [L, 3] under per-slot poses."""
    Xc = (Robs @ X[:, None, :, None])[..., 0] + tobs
    z = Xc[..., 2]
    return Xc[..., 0], Xc[..., 1], torch.where(z.abs() < 1e-9, 1e-9, z)


def _components(cam, prob: BAProblem, R, t, X):
    """e [L,D,3], J_pose [L,D,3,6], J_point [L,D,3,3]."""
    Robs, tobs = R[prob.obs_pose], t[prob.obs_pose]
    x, y, z = _project(cam, Robs, tobs, X)
    iz = 1.0 / z
    iz2 = iz * iz
    srow = (prob.obs_uvr[..., 2] >= 0).to(x.dtype)
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    obs = prob.obs_uvr
    e = torch.stack([obs[..., 0] - u, obs[..., 1] - v,
                     (obs[..., 2] - ur) * srow], -1)
    zero = torch.zeros_like(x)
    Jproj = torch.stack([
        torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1),
        torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1),
        torch.stack([(cam.fx * iz) * srow, zero,
                     (-cam.fx * x * iz2 + cam.bf * iz2) * srow], -1)], -2)
    Xc = torch.stack([x, y, z], -1)
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(Jproj.shape)
    Jp = -(Jproj @ torch.cat([eye, -se3.hat(Xc)], -1))
    Jl = -(Jproj @ Robs)
    return e, Jp, Jl


def _eval_chi2(cam, prob: BAProblem, w_active, R, t, X):
    """Per-observation weighted chi2 [L, D] (zero where inactive)."""
    x, y, z = _project(cam, R[prob.obs_pose], t[prob.obs_pose], X)
    iz = 1.0 / z
    obs = prob.obs_uvr
    srow = (obs[..., 2] >= 0).to(x.dtype)
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    e2 = ((obs[..., 0] - u) ** 2 + (obs[..., 1] - v) ** 2
          + ((obs[..., 2] - ur) * srow) ** 2)
    return e2 * w_active


class _Fixed(NamedTuple):
    """What a solve's iterations share: the Huber thresholds, the active
    observations and their weights, the free-pose mask per observation."""
    delta_h: torch.Tensor  # [L, D]
    active: torch.Tensor  # [L, D] bool
    w_active: torch.Tensor  # [L, D]
    free_obs: torch.Tensor  # [L, D] float


class _Lin(NamedTuple):
    """One iteration's linearization (plain version)."""
    e: torch.Tensor  # [L, D, 3]
    Jp: torch.Tensor  # [L, D, 3, 6], zero for fixed poses
    wJp: torch.Tensor  # [L, D, 3, 6]
    Y: torch.Tensor  # [L, D, 6, 3]
    Hll_inv: torch.Tensor  # [L, 3, 3]
    bl: torch.Tensor  # [L, 3]
    chi2_old: torch.Tensor  # () at the state


def _fixed(prob: BAProblem) -> _Fixed:
    active = (prob.obs_w > 0) & prob.point_valid[:, None]
    return _Fixed(
        torch.where(prob.obs_uvr[..., 2] >= 0, HUBER_STEREO, HUBER_MONO),
        active, torch.where(active, prob.obs_w, 0.0),
        (~prob.pose_fixed)[prob.obs_pose].to(prob.X.dtype))


def _linearize(cam, prob: BAProblem, k: _Fixed, R, t, X, lam,
               robust: bool) -> _Lin:
    """Residuals and Jacobians over the [L, D] table, the Huber weights,
    the landmark blocks with their damped inverses, bl and Y."""
    e, Jp, Jl = _components(cam, prob, R, t, X)
    chi2_i = (e * e).sum(-1) * prob.obs_w
    w_rob = huber_weight(chi2_i, k.delta_h) if robust else 1.0
    w = k.w_active * w_rob
    Jp = Jp * k.free_obs[..., None, None]
    wJp = Jp * w[..., None, None]
    wJl = Jl * w[..., None, None]
    Hll = torch.einsum("ldri,ldrj->lij", wJl, Jl)
    bl = torch.einsum("ldri,ldr->li", wJl, e)
    Y = torch.einsum("ldri,ldrj->ldij", wJp, Jl)  # [L, D, 6, 3]
    diag_ll = torch.diagonal(Hll, dim1=-2, dim2=-1).clamp(min=1e-6)
    Hll_d = Hll + lam * torch.diag_embed(diag_ll)
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    Hll_d = torch.where(prob.point_valid[:, None, None], Hll_d, eye3)
    chi2_old = torch.where(k.active, chi2_i, 0.0).sum()
    return _Lin(e, Jp, wJp, Y, _inv3x3(Hll_d), bl, chi2_old)


def _step(cam, prob: BAProblem, k: _Fixed, lin: _Lin, dxi, R, t, X, lam,
          accept_all: bool, trace: list | None):
    """Back-substitution of the landmarks, the candidate and its chi2, the
    accept test and the damping: the next (R, t, X, lam)."""
    # back-substitution: Hll dX = -(bl + sum_d Y^T dxi_pose)
    rhs_l = lin.bl + torch.einsum("ldij,ldi->lj", lin.Y, dxi[prob.obs_pose])
    dX = -(lin.Hll_inv @ rhs_l[..., None])[..., 0]
    dX = torch.where(prob.point_valid[:, None], dX, 0.0)
    R_new, t_new = se3.retract(R, t, dxi)
    X_new = X + dX
    chi2_new = _eval_chi2(cam, prob, k.w_active, R_new, t_new, X_new).sum()
    if accept_all:
        ok = torch.ones((), dtype=torch.bool, device=X.device)
    else:
        ok = ((chi2_new < lin.chi2_old) & torch.isfinite(dxi).all()
              & torch.isfinite(dX).all())
    if trace is not None:
        trace.append(torch.stack([lin.chi2_old, chi2_new, ok.to(X.dtype)]))
    if accept_all:
        return R_new, t_new, X_new, lam
    return (torch.where(ok, R_new, R), torch.where(ok, t_new, t),
            torch.where(ok, X_new, X),
            torch.where(ok, lam * 0.5, lam * 5.0).clamp(1e-9, 1e8))


def _init_lambda(init_lambda, like: torch.Tensor) -> torch.Tensor:
    if isinstance(init_lambda, torch.Tensor):
        return init_lambda.to(dtype=like.dtype, device=like.device).reshape(())
    return torch.full((), init_lambda, dtype=like.dtype, device=like.device)


def _lm_iterations(cam: CamParams, prob: BAProblem, iters: int, robust: bool,
                   init_lambda, reduced_step, accept_all: bool = False,
                   trace: list | None = None) -> BAResult:
    """The LM loop both solvers share: the linearization (_linearize), then
    ``reduced_step(wJp, Jp, e, Y, Hll_inv, bl, lam) -> dxi [P, 6]`` (the
    reduced camera system, dense or iterative), back-substitution of the
    landmarks and the accept/reject on the robust-weighted chi2 (_step).
    With ``accept_all`` every step is taken at a fixed damping (the
    schedule of parallel.dist_ba). ``trace``: a list that gets each
    iteration's (chi2_old, chi2_new, accepted)."""
    k = _fixed(prob)
    R, t, X = prob.R, prob.t, prob.X
    lam = _init_lambda(init_lambda, X)
    for _ in range(iters):
        lin = _linearize(cam, prob, k, R, t, X, lam, robust)
        dxi = reduced_step(lin.wJp, lin.Jp, lin.e, lin.Y, lin.Hll_inv,
                           lin.bl, lam)
        R, t, X, lam = _step(cam, prob, k, lin, dxi, R, t, X, lam,
                             accept_all, trace)
    R = se3.orthonormalize(R)
    obs_chi2 = _eval_chi2(cam, prob, k.w_active, R, t, X)
    return BAResult(R, t, X, obs_chi2.sum(), obs_chi2, lam)


def _dense_system(prob: BAProblem):
    """The dense reduced camera system as a function of one iteration's
    linearization: (wJp, Jp, e, Y, Hll_inv, bl, lam) -> (S [6P, 6P],
    b_s [6P]), fixed poses with identity blocks and a zero right-hand
    side."""
    P = prob.R.shape[0]
    dev, f32 = prob.X.device, prob.X.dtype
    free_pose = ~prob.pose_fixed
    G = torch.nn.functional.one_hot(prob.obs_pose, P).to(f32)  # [L, D, P]
    ar = torch.arange(P, device=dev)
    keep = (free_pose[:, None] & free_pose[None, :]).to(f32)
    fixed_blk = torch.where(prob.pose_fixed[:, None, None],
                            torch.eye(6, dtype=f32, device=dev), 0.0)

    def system(wJp, Jp, e, Y, Hll_inv, bl, lam):
        Hpp = torch.einsum("ldri,ldrj,ldp->pij", wJp, Jp, G)
        bp = torch.einsum("ldri,ldr,ldp->pi", wJp, e, G)
        # Schur: S[p,q] -= sum_l (sum_{d->p} Y H^-1)_l (sum_{c->q} Y)_l^T
        A = torch.einsum("ldp,ldik->lpik", G, Y @ Hll_inv[:, None])
        Bm = torch.einsum("ldp,ldjk->lpjk", G, Y)
        S_off = torch.einsum("lpik,lqjk->pqij", A, Bm)
        diag_pp = torch.diagonal(Hpp, dim1=-2, dim2=-1).clamp(min=1e-6)
        Hpp_d = Hpp + lam * torch.diag_embed(diag_pp)
        S = -S_off
        S[ar, ar] += Hpp_d
        b_s = bp - torch.einsum("lpik,lk->pi", A, bl)
        # fixed poses: identity row/column block, zero right-hand side
        S = S * keep[..., None, None]
        S[ar, ar] += fixed_blk
        b_s = torch.where(prob.pose_fixed[:, None], 0.0, b_s)
        return S.permute(0, 2, 1, 3).reshape(P * 6, P * 6), b_s.reshape(-1)

    return system


def ba_solve_plain(cam: CamParams, prob: BAProblem, iters: int = 10,
                   robust: bool = True, init_lambda=1e-4,
                   accept_all: bool = False,
                   trace: list | None = None) -> BAResult:
    """The plain PyTorch version of ba_solve: per iteration the
    linearization, the dense reduced camera system, its solve and the
    step, about a hundred eager launches. ``trace`` as _lm_iterations."""
    P = prob.R.shape[0]
    system = _dense_system(prob)

    def reduced_step(*lin):
        S, b_s = system(*lin)
        sol, _ = torch.linalg.solve_ex(S, b_s[:, None])
        return -sol.reshape(P, 6)

    return _lm_iterations(cam, prob, iters, robust, init_lambda, reduced_step,
                          accept_all, trace)


def first_system_plain(cam: CamParams, prob: BAProblem, robust: bool = True,
                       init_lambda=1e-4):
    """(S [6P, 6P], b_s [6P], chi2 at the start) of a solve's first
    iteration, plain: what KernelSolve.assemble writes."""
    lam = _init_lambda(init_lambda, prob.X)
    lin = _linearize(cam, prob, _fixed(prob), prob.R, prob.t, prob.X, lam,
                     robust)
    S, b_s = _dense_system(prob)(lin.wJp, lin.Jp, lin.e, lin.Y, lin.Hll_inv,
                                 lin.bl, lam)
    return S, b_s, lin.chi2_old


# ---------------------------------------------------------------------------
# K4: csrc/ba.cu, one launch a solve
# ---------------------------------------------------------------------------

LAUNCHES = {"ba_solve": 0}
# the launches, among LAUNCHES', of the kernel's wide variant (more than
# WIDE_SLOTS slots a landmark, or 2^31 pairs or more)
VARIANT_LAUNCHES = {"ba_solve_wide": 0}
MAX_POSES = 64  # csrc/ba.cu kMaxPoses: a landmark's free poses in a 64-bit mask
# csrc/ba.cu kMaxSlots: above this many slots a landmark (or at 2^31 pairs)
# the launch takes the kernel's wide variant
WIDE_SLOTS = 32
_MODE_ACCEPT_ALL, _MODE_ASSEMBLE = 1, 2
# csrc/ba.cu: an observation's record in floats, the pairs a chunk of a pair
# list, a chunk's float64 sums, the blocks of partial sums
REC_FLOATS, PAIR_CHUNK, PART_DOUBLES, MAX_GRID = 64, 40, 84, 1024
# csrc/ba.cu kMaxRanges: the most ranges of landmarks a pair list is built in
MAX_RANGES = 64
# csrc/ba.cu kSharedFree: up to this many free poses (and at most P) the
# reduced system is factorized in shared memory, above from global memory
SHARED_FREE = 28
# the Huber thresholds as the plain version's float32 tensors hold them
_HUBER = (float(np.float32(HUBER_MONO)), float(np.float32(HUBER_STEREO)))

_P = ctypes.c_void_p


class _BaArgs(ctypes.Structure):
    """csrc/ba.cu's BaArgs, field for field."""
    _fields_ = [(n, _P) for n in (
        "obs_uvr", "obs_w", "obs_pose", "pose_fixed", "point_valid", "R",
        "t", "X", "lam", "trace", "obs_chi2", "chi2", "step0", "S", "b",
        "S64", "b64", "chi2_old", "stamps", "rec", "hinv", "bl", "Xn",
        "spose", "mask", "pcounts", "plist", "counts", "done", "pairs",
        "part", "Sb", "bs", "x", "partial")] + [
        (n, ctypes.c_int) for n in ("P", "L", "D", "iters",
                                    "chunk_cap")] + [
        (n, ctypes.c_float) for n in ("fx", "fy", "cx", "cy", "bf",
                                      "huber_mono", "huber_stereo")] + [
        ("robust", ctypes.c_int), ("mode", ctypes.c_int)]


def scratch_sizes(P: int, L: int, D: int) -> dict:
    """The kernel's scratch for a problem of this shape: the observation
    pairs of every block of the reduced system (each landmark gives a block
    (p, q > p) the products of its observations of p and of q, and (p, p)
    the unordered pairs of its observations of p, each once: at most
    D (D + 1) / 2 a landmark), the blocks of S over the poses, and the
    chunks the pair lists are cut into (a list of n pairs in ceil(n /
    PAIR_CHUNK), so at most pairs // PAIR_CHUNK + blocks)."""
    pairs = L * D * (D + 1) // 2
    blocks = P * (P + 1) // 2
    return {"pairs": pairs, "blocks": blocks,
            "chunks": pairs // PAIR_CHUNK + blocks}


def phase_stamps(iters: int) -> int:
    """The stamps a timed launch writes (csrc/ba.cu kStampsFixed and
    kStampsIter): the start, the structure's end, 5 an iteration (after
    the linearization, the Schur sums, block 0's load of the system, the
    factorization, the update), the end."""
    return 3 + 5 * iters


_lib: ctypes.CDLL | None = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ba_args_bytes.argtypes = []
    lib.ba_args_bytes.restype = ctypes.c_int
    lib.ba_grid.argtypes = [_P]
    lib.ba_grid.restype = ctypes.c_int
    lib.ba_solve.argtypes = [_P, _P]
    lib.ba_solve.restype = ctypes.c_int
    return lib


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = bind(cuda_lib.load("ba"))
        got, want = lib.ba_args_bytes(), ctypes.sizeof(_BaArgs)
        if got != want:
            raise RuntimeError(f"csrc/ba.cu's BaArgs is {got} bytes, "
                               f"optim/ba.py's {want}")
        _lib = lib
    return _lib


def _check_problem(prob: BAProblem) -> bool:
    """True when every tensor lies on the CPU; raises on a wrong type or
    shape, on tensors on several devices, and on the card above MAX_POSES
    poses (the dense path's size: the solvers go to CG above it)."""
    for name in ("R", "t", "X", "obs_uvr", "obs_w"):
        x = getattr(prob, name)
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
    if prob.obs_pose.dtype != torch.int64:
        raise ValueError(f"obs_pose must be int64, got {prob.obs_pose.dtype}")
    for name in ("pose_fixed", "point_valid"):
        if getattr(prob, name).dtype != torch.bool:
            raise ValueError(f"{name} must be bool, got "
                             f"{getattr(prob, name).dtype}")
    P, L = prob.R.shape[0], prob.X.shape[0]
    D = prob.obs_w.shape[-1] if prob.obs_w.dim() == 2 else -1
    want = {"R": (P, 3, 3), "t": (P, 3), "X": (L, 3), "obs_pose": (L, D),
            "obs_uvr": (L, D, 3), "obs_w": (L, D), "pose_fixed": (P,),
            "point_valid": (L,)}
    got = {k: tuple(getattr(prob, k).shape) for k in want}
    if got != want:
        raise ValueError(f"expected the shapes {want}, got {got}")
    if all(x.device.type == "cpu" for x in prob):
        return True
    dev = prob.X.device
    if dev.type != "cuda" or any(x.device != dev for x in prob):
        raise ValueError("the BA kernel takes tensors on one CUDA device "
                         f"(got {[str(x.device) for x in prob]})")
    if not 1 <= P <= MAX_POSES:
        raise ValueError(f"the BA kernel takes 1 to {MAX_POSES} poses, "
                         f"got {P}")
    return False


class KernelSolve:
    """One dense LM solve through csrc/ba.cu on a checked CUDA problem: the
    state, the results and the scratch of the solve. ``run`` is the one
    launch of the whole solve; ``assemble`` a launch that stops after the
    first reduced camera system. ba_solve drives it; chip_smoke.py and the
    card tests also call assemble() and record_phases()."""

    def __init__(self, cam: CamParams, prob: BAProblem, iters: int,
                 robust: bool = True, init_lambda=1e-4,
                 accept_all: bool = False):
        self.lib = _kernel_lib()
        dev, f32, f64 = prob.X.device, torch.float32, torch.float64
        P, L = prob.R.shape[0], prob.X.shape[0]
        D = prob.obs_w.shape[1]
        self.prob = BAProblem(*(x.contiguous() for x in prob))
        self.iters, self.accept_all = iters, accept_all
        self.R = prob.R.clone().contiguous()
        self.t = prob.t.clone().contiguous()
        self.X = prob.X.clone().contiguous()
        self.lam = _init_lambda(init_lambda, prob.X).reshape(1).clone()
        self.stamps = None

        def empty(*shape, dtype=f32):
            return torch.empty(shape, dtype=dtype, device=dev)

        sizes = scratch_sizes(P, L, D)
        # csrc/ba.cu is_wide: the launch takes the wide variant
        self.wide = D > WIDE_SLOTS or sizes["pairs"] >= 2 ** 31
        self.trace = torch.zeros(max(iters, 1), 4, dtype=f32, device=dev)
        self.obs_chi2, self.chi2 = empty(L, D), empty(1)
        self.step0 = torch.zeros(6 * P, dtype=f64, device=dev)
        self.rec = empty(L * D, REC_FLOATS)
        self.hinv, self.bl, self.Xn = empty(L, 9), empty(L, 3), empty(L, 3)
        self.spose = empty(L * max(D, 8), dtype=torch.int8)
        self.mask = empty(L, dtype=torch.int64)
        self.pcounts = empty(P * MAX_RANGES, dtype=torch.int32)
        self.plist = empty(L * D, dtype=torch.int32)
        # int32 counts, or int64 in the wide variant: room for either
        self.counts = empty(sizes["blocks"] * MAX_RANGES, dtype=torch.int64)
        self.done = empty(sizes["blocks"], dtype=torch.int32)
        self.pairs = empty(sizes["pairs"], 2, dtype=torch.int32)
        self.part = empty(sizes["chunks"], PART_DOUBLES, dtype=f64)
        self.Sb = empty(sizes["blocks"], 36, dtype=f64)
        self.bs, self.x = empty(6 * P, dtype=f64), empty(6 * P, dtype=f64)
        self.partial = empty(3, MAX_GRID, dtype=f64)
        a = _BaArgs()
        for name in ("obs_uvr", "obs_w", "obs_pose", "pose_fixed",
                     "point_valid"):
            setattr(a, name, getattr(self.prob, name).data_ptr())
        for name in ("R", "t", "X", "lam", "trace", "obs_chi2", "chi2",
                     "step0", "rec", "hinv", "bl", "Xn", "spose", "mask",
                     "pcounts", "plist", "counts", "done", "pairs", "part",
                     "Sb", "bs", "x", "partial"):
            setattr(a, name, getattr(self, name).data_ptr())
        a.P, a.L, a.D, a.iters = P, L, D, iters
        a.chunk_cap = sizes["chunks"]
        a.fx, a.fy, a.cx, a.cy, a.bf = cam
        a.huber_mono, a.huber_stereo = _HUBER
        a.robust = int(robust)
        a.mode = _MODE_ACCEPT_ALL if accept_all else 0
        self.args = a

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.X.device).cuda_stream

    def _launch(self) -> None:
        """One launch on the current stream; raises on a launch error."""
        err = self.lib.ba_solve(ctypes.addressof(self.args), self._stream())
        if err != 0:
            raise RuntimeError(f"ba_solve launch failed: cudaError_t {err}")
        LAUNCHES["ba_solve"] += 1
        if self.wide:
            VARIANT_LAUNCHES["ba_solve_wide"] += 1

    def grid(self) -> int:
        """The blocks of threads a launch takes on this card."""
        return self.lib.ba_grid(ctypes.addressof(self.args))

    def record_phases(self) -> torch.Tensor:
        """Have each later launch write its phase stamps (phase_stamps;
        the card's globaltimer in ns, read by block 0 after each grid
        barrier, with one more barrier after the structure) into the
        returned tensor."""
        self.stamps = torch.zeros(phase_stamps(self.iters),
                                  dtype=torch.int64, device=self.X.device)
        self.args.stamps = self.stamps.data_ptr()
        return self.stamps

    def assemble(self):
        """A launch that stops after the first iteration's reduced camera
        system at the current state: (S [6P, 6P], b_s [6P]) in float32,
        fixed poses with identity rows and a zero right-hand side; its
        float64 values stay in ``S64`` and ``b64`` (the upper triangle the
        factorization reads, mirrored) and the chi2 at the state in
        ``chi2_old``."""
        if not hasattr(self, "S64"):
            P, dev = self.R.shape[0], self.X.device
            n6 = 6 * P
            self.S = torch.empty(n6, n6, dtype=torch.float32, device=dev)
            self.b = torch.empty(n6, dtype=torch.float32, device=dev)
            self.S64 = torch.empty(n6, n6, dtype=torch.float64, device=dev)
            self.b64 = torch.empty(n6, dtype=torch.float64, device=dev)
            self.chi2_old = torch.empty(1, dtype=torch.float32, device=dev)
            for name in ("S", "b", "S64", "b64", "chi2_old"):
                setattr(self.args, name, getattr(self, name).data_ptr())
        mode = self.args.mode
        self.args.mode = mode | _MODE_ASSEMBLE
        try:
            self._launch()
        finally:
            self.args.mode = mode
        return self.S, self.b

    def run(self) -> BAResult:
        """The solve's one launch: every iteration, then the orthonormalized
        poses and the per-observation chi2 (with 0 iterations only these);
        the first iteration's solution of S x = b_s stays in ``step0``."""
        self._launch()
        return self.result()

    def result(self) -> BAResult:
        return BAResult(self.R, self.t, self.X, self.chi2.reshape(()),
                        self.obs_chi2, self.lam.reshape(()))


def ba_solve(cam: CamParams, prob: BAProblem, iters: int = 10,
             robust: bool = True, init_lambda=1e-4,
             accept_all: bool = False) -> BAResult:
    """Run ``iters`` LM iterations with the dense Schur complement: the
    right trade at local-BA window sizes (P up to a few tens).
    ``accept_all``: take every step at the fixed damping ``init_lambda``.
    On the CPU ba_solve_plain; on CUDA tensors one launch of csrc/ba.cu for
    the whole solve, its reduced system factorized inside, reading nothing
    back (at most 64 poses; above 32 slots a landmark the kernel's wide
    variant)."""
    if _check_problem(prob):
        return ba_solve_plain(cam, prob, iters, robust, init_lambda,
                              accept_all)
    return KernelSolve(cam, prob, iters, robust, init_lambda,
                       accept_all).run()


def ba_solve_cg(cam: CamParams, prob: BAProblem, iters: int = 10,
                cg_iters: int = 40, robust: bool = True,
                init_lambda=1e-4) -> BAResult:
    """LM bundle adjustment for maps of many keyframes: the reduced camera
    system is never assembled. Per LM step the Schur product
    S v = Hpp v - Hpl Hll^-1 Hlp v goes through the landmark-major
    observation table (only the pose side needs segment sums), inside
    ``cg_iters`` iterations of conjugate gradients preconditioned by the
    inverse 6x6 pose blocks. Memory is O(L D) (reference:
    GlobalBundleAdjustemnt Optimizer.cc:41-255). The segment sums are
    float32 index_add: on a CUDA device their order, and so the last bits
    of the result, vary from run to run."""
    P = prob.R.shape[0]
    dev, f32 = prob.X.device, prob.X.dtype
    flat_pose = prob.obs_pose.reshape(-1)
    free = (~prob.pose_fixed)[:, None]
    eye6 = torch.eye(6, dtype=f32, device=dev)

    def to_poses(per_obs):  # [L, D, ...] -> [P, ...] summed by pose
        out = torch.zeros((P, *per_obs.shape[2:]), dtype=f32, device=dev)
        return out.index_add(0, flat_pose, per_obs.flatten(0, 1))

    def reduced_step(wJp, Jp, e, Y, Hll_inv, bl, lam):
        Hpp = to_poses(torch.einsum("ldri,ldrj->ldij", wJp, Jp))
        bp = to_poses(torch.einsum("ldri,ldr->ldi", wJp, e))
        diag_pp = torch.diagonal(Hpp, dim1=-2, dim2=-1).clamp(min=1e-6)
        Hpp_d = Hpp + lam * torch.diag_embed(diag_pp)
        Hpp_d = torch.where(free[..., None], Hpp_d, eye6)
        Minv = torch.linalg.inv(Hpp_d)  # block-Jacobi preconditioner

        def hpl_hll_inv(a):  # Hpl Hll^-1 a for a [L, 3]
            y = (Hll_inv @ a[..., None])[..., 0]
            return to_poses(torch.einsum("ldij,lj->ldi", Y, y))

        def S_mv(v):
            a = torch.einsum("ldij,ldi->lj", Y, v[prob.obs_pose])
            out = (Hpp_d @ v[..., None])[..., 0] - hpl_hll_inv(a)
            return torch.where(free, out, v)

        rhs = -torch.where(free, bp - hpl_hll_inv(bl), 0.0)
        x = block_pcg(S_mv, Minv, rhs, cg_iters)
        return torch.where(free, x, 0.0)

    return _lm_iterations(cam, prob, iters, robust, init_lambda, reduced_step)
