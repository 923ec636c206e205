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
"""
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
}


def _problem(case, seed, P, L, D, n_fixed):
    p = ba_problem(case, seed, P=P, L=L, D=D, n_fixed=n_fixed)
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
