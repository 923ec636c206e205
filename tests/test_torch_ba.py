"""K4, the dense bundle adjustment (optim/ba.py), on the CPU:
``ba_solve_plain`` against the JAX package's ``ba_solve`` on the seeded
local-BA problems of dataio.synthetic.ba_problem, and the wrapper's
checks.

Cases: 24 poses (16 free, 8 fixed) with mixed mono and stereo rows and
10% outliers; 64 poses; every step taken at a fixed damping
(``accept_all``, against the JAX package's fixed schedule,
parallel/dist_ba.ba_solve_sharded, on a mesh of one device); no valid
landmark; mono rows only.

Tolerances, as tests/test_torch_optim.py holds the solver: the final
damping equal (the same accept sequence), R, t and X within 1e-3, chi2
within 1e-3 relative (the dense float32 Schur system is assembled in
another order).

Also the kernel's binding (csrc/ba.cu's BaArgs, limits and extern "C"
functions against optim/ba.py, and PR 13's csrc/ba_v1.cu against the
baseline driver in chip_smoke.py) and the scratch the wrapper sizes from
the shapes against a brute-force count of the pair lists.
"""
import ctypes
import math
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from orb_slam2_with_comment_tpu.optim import ba as jba
from orb_slam2_with_comment_tpu.optim.residuals import CamParams as JCam
from orb_slam2_with_comment_tpu.parallel import dist_ba as jdist_ba
from orb_slam2_with_comment_tpu_torch.dataio.synthetic import ba_problem
from orb_slam2_with_comment_tpu_torch.ops import cuda_lib
from orb_slam2_with_comment_tpu_torch.optim import ba
from orb_slam2_with_comment_tpu_torch.optim.residuals import CamParams

torch.set_num_threads(2)

CAM = CamParams.of(500.0, 500.0, 320.0, 240.0, 40.0)
JCAM = JCam(*[jnp.float32(v) for v in CAM])
FIELDS = ("R", "t", "X", "obs_pose", "obs_uvr", "obs_w", "pose_fixed",
          "point_valid")

# name: (case, seed, P, L, D, fixed poses, iterations)
CASES = {
    "24 poses, mixed, outliers": ("mixed", 0, 24, 600, 8, 8, 5),
    "64 poses": ("mixed", 1, 64, 1000, 8, 8, 3),
    "no valid landmark": ("all_invalid", 2, 24, 200, 8, 8, 3),
    "mono only": ("mono", 3, 12, 400, 6, 4, 5),
    # MapConfig(d_max=40): above the kernel's 32 slots (its wide variant),
    # the observations spread over all 40
    "40 slots": ("mixed", 7, 12, 300, 40, 4, 3),
}


def _problem(case, seed, P, L, D, n_fixed):
    p = ba_problem(case, seed, P=P, L=L, D=D, n_fixed=n_fixed,
                   spread=D > ba.WIDE_SLOTS)
    return (ba.BAProblem(*(torch.as_tensor(p[f]) for f in FIELDS)),
            jba.BAProblem(*(jnp.asarray(p[f].astype(np.int32)
                                        if f == "obs_pose" else p[f])
                            for f in FIELDS)))


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_ba_solve_plain_matches_jax(name):
    case, seed, P, L, D, n_fixed, iters = CASES[name]
    tprob, jprob = _problem(case, seed, P, L, D, n_fixed)
    trace = []
    got = ba.ba_solve_plain(CAM, tprob, iters=iters, robust=True,
                            init_lambda=1e-4, trace=trace)
    want = jba.ba_solve(JCAM, jprob, iters=iters, robust=True,
                        init_lambda=jnp.float32(1e-4))
    assert float(got.final_lambda) == float(want.final_lambda)
    for f in ("R", "t", "X"):
        _close(getattr(got, f), getattr(want, f), f)
    chi2_t, chi2_j = float(got.chi2), float(want.chi2)
    assert abs(chi2_t - chi2_j) <= 1e-3 * chi2_j + 1e-6
    accepted = [bool(r[2]) for r in trace]
    assert len(trace) == iters
    if case == "all_invalid":
        # nothing to move: every step rejected, the damping x5 each time
        assert chi2_t == 0.0 and not any(accepted)
        assert float(got.final_lambda) == pytest.approx(1e-4 * 5 ** iters)
    else:
        assert accepted[0] and chi2_t < float(trace[0][0])


def test_ba_solve_plain_accept_all_matches_jax_fixed_schedule():
    tprob, jprob = _problem("mixed", 4, 8, 300, 6, 1)
    mesh = Mesh(np.array(jax.devices()[:1]), ("lm",))
    jR, jt, jX, _ = jdist_ba.ba_solve_sharded(JCAM, jprob, mesh, iters=4,
                                              lam=1e-4, robust=True)
    trace = []
    got = ba.ba_solve_plain(CAM, tprob, iters=4, robust=True,
                            init_lambda=1e-4, accept_all=True, trace=trace)
    assert float(got.final_lambda) == np.float32(1e-4)
    assert all(bool(r[2]) for r in trace)
    for f, want in (("R", jR), ("t", jt), ("X", jX)):
        _close(getattr(got, f), want, f)


def test_first_system_plain_is_the_first_iteration():
    """first_system_plain's chi2 is the first iteration's chi2_old, its S
    symmetric within float32 rounding, identity blocks and a zero
    right-hand side on the fixed poses."""
    tprob, _ = _problem("mixed", 5, 10, 300, 6, 3)
    S, b_s, chi2 = ba.first_system_plain(CAM, tprob)
    trace = []
    ba.ba_solve_plain(CAM, tprob, iters=1, trace=trace)
    assert float(chi2) == float(trace[0][0])
    assert S.shape == (60, 60) and b_s.shape == (60,)
    scale = float(S.abs().max())
    assert float((S - S.T).abs().max()) <= 1e-5 * scale
    fixed = slice(42, 60)
    assert torch.equal(S[fixed, fixed], torch.eye(18))
    assert not S[fixed, :42].any() and not b_s[fixed].any()


def test_ba_solve_wrapper_takes_plain_on_cpu_and_checks():
    tprob, _ = _problem("mixed", 6, 6, 120, 4, 2)
    before = dict(ba.LAUNCHES)
    for iters in (0, 2):
        got = ba.ba_solve(CAM, tprob, iters=iters)
        want = ba.ba_solve_plain(CAM, tprob, iters=iters)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert ba.LAUNCHES == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="obs_pose must be int64"):
        ba.ba_solve(CAM, tprob._replace(obs_pose=tprob.obs_pose.int()))
    with pytest.raises(ValueError, match="X must be float32"):
        ba.ba_solve(CAM, tprob._replace(X=tprob.X.double()))
    with pytest.raises(ValueError, match="pose_fixed must be bool"):
        ba.ba_solve(CAM, tprob._replace(pose_fixed=tprob.pose_fixed.int()))
    with pytest.raises(ValueError, match="expected the shapes"):
        ba.ba_solve(CAM, tprob._replace(obs_w=tprob.obs_w[:, :3]))


def _source(name):
    with open(os.path.join(cuda_lib.CSRC_DIR, name)) as f:
        return f.read()


def _c_fields(src):
    """(C type, name) of each field of the source's BaArgs, in order."""
    body = re.search(r"struct BaArgs \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in body.split(";"):
        words = decl.replace("*", " * ").replace(",", " , ").split()
        if not words:
            continue
        names = " ".join(w for w in words if w not in (
            "const", "unsigned", "long", "signed", "*")).split(",")
        ctype = "ptr" if "*" in words else words[-2] if len(
            names) == 1 else words[0]
        for name in names:
            out.append((ctype, name.split()[-1]))
    return out


def _baseline_args():
    import chip_smoke
    return chip_smoke.BaselineBa.Args


# each kernel source and its ctypes mirror: the kernel's, and PR 13's
# kernels (the timing baseline) as chip_smoke.py binds them
MIRRORS = {"ba.cu": lambda: ba._BaArgs, "ba_v1.cu": _baseline_args}


@pytest.mark.parametrize("name", sorted(MIRRORS))
def test_args_match_the_source(name):
    """The ctypes mirror has BaArgs' fields in the source's order, a
    pointer for each pointer, int and float where the source has them."""
    fields = _c_fields(_source(name))
    mirror = MIRRORS[name]()
    assert [n for _, n in fields] == [f[0] for f in mirror._fields_]
    kinds = {"ptr": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    for (ctype, n), (_, ptype) in zip(fields, mirror._fields_):
        assert ptype is kinds[ctype], n


def test_binding_matches_the_extern_c_interface_and_the_limits():
    """The functions bind() binds are the source's extern "C" functions with
    the same parameter types, and the source's limits and sizes are the
    wrapper's."""
    src = _source("ba.cu")

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))

    assert const("kMaxPoses") == ba.MAX_POSES
    # above kMaxSlots slots the wrapper no longer refuses: the launch takes
    # the wide variant (ba_kernel<true>), chosen by the source's is_wide
    assert const("kMaxSlots") == ba.WIDE_SLOTS
    assert re.search(r"a->D > kMaxSlots \|\| pairs >= \(1ll << 31\)", src)
    tprob, _ = _problem("mixed", 8, 6, 40, ba.WIDE_SLOTS + 16, 2)
    assert ba._check_problem(tprob)  # a CPU problem: the plain version
    got = ba.ba_solve(CAM, tprob, iters=1)
    assert torch.isfinite(got.X).all() and float(got.chi2) > 0
    assert const("kRec") == ba.REC_FLOATS
    assert const("kPart") == ba.PART_DOUBLES
    assert const("kMaxGrid") == ba.MAX_GRID
    assert const("kMaxRanges") == ba.MAX_RANGES
    assert const("kSharedFree") == ba.SHARED_FREE
    assert re.search(r"constexpr int kChunk = kSteps \* kPairGroups;", src)
    assert const("kSteps") * const("kPairGroups") == ba.PAIR_CHUNK
    assert (const("kStampsFixed"), const("kStampsIter")) == (3, 5)
    assert ba.phase_stamps(4) == 3 + 5 * 4

    class Lib:
        pass

    extern = src[src.index('extern "C" {'):]
    fns = re.findall(r"\nint (\w+)\(([^)]*)\)", extern)
    for fn, _ in fns:
        setattr(Lib, fn, type("Fn", (), {})())
    lib = ba.bind(Lib())
    assert sorted(fn for fn, _ in fns) == ["ba_args_bytes", "ba_grid",
                                           "ba_solve"]
    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p}
    for fn, params in fns:
        want = [c_types[" ".join(p.split()[:-1])]
                for p in params.split(",") if p.strip()]
        assert getattr(lib, fn).argtypes == want, fn
        assert getattr(lib, fn).restype is ctypes.c_int


def _pair_lists(obs_pose, active, fixed):
    """The kernel's pair lists by brute force: for each block (p, q >= p)
    of the free poses, the observation pairs of the landmarks that both
    observe (p == q: the unordered pairs of p's observations, each once)."""
    P = fixed.shape[0]
    fidx = np.cumsum(~fixed) - 1
    L, D = obs_pose.shape
    lists = {}
    for l in range(L):
        f = [fidx[obs_pose[l, d]] if active[l, d] and not fixed[
            obs_pose[l, d]] else -1 for d in range(D)]
        for d in range(D):
            for c in range(D):
                if f[d] < 0 or f[c] < 0 or f[d] > f[c]:
                    continue
                if f[d] == f[c] and c < d:
                    continue
                lists.setdefault((f[d], f[c]), []).append((d, c))
    return lists, int((~fixed).sum()), P


@pytest.mark.parametrize("case", ["random", "repeated poses", "one pose"])
def test_scratch_sizes_hold_the_pair_lists(case):
    """The pairs and chunks the wrapper allocates from the shapes hold what
    a brute-force count of the pair lists finds, with landmarks that
    observe a pose in several slots too; where every slot of every
    landmark observes one free pose the pairs fill it exactly."""
    rng = np.random.RandomState({"random": 0, "repeated poses": 1,
                                 "one pose": 2}[case])
    P, L, D = 9, 400, 6
    fixed = np.zeros(P, bool)
    fixed[-2:] = True
    if case == "one pose":
        obs_pose = np.zeros((L, D), np.int64)
        active = np.ones((L, D), bool)
    else:
        high = 3 if case == "repeated poses" else P
        obs_pose = rng.randint(0, high, (L, D))
        active = rng.rand(L, D) < 0.8
    lists, nf, _ = _pair_lists(obs_pose, active, fixed)
    sizes = ba.scratch_sizes(P, L, D)
    n_pairs = sum(len(v) for v in lists.values())
    n_chunks = sum(math.ceil(len(v) / ba.PAIR_CHUNK) for v in lists.values())
    assert n_pairs <= sizes["pairs"] and n_chunks <= sizes["chunks"]
    assert len(lists) <= nf * (nf + 1) // 2 <= sizes["blocks"]
    if case == "one pose":
        assert n_pairs == sizes["pairs"] == L * D * (D + 1) // 2
