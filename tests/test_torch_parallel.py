"""The port's sharded solvers over 2 and 4 gloo ranks on the CPU against
the JAX package's, which run on the conftest's 8-device CPU mesh, on the
same problems (tests/test_optim.py's build_ba_problem,
tests/test_dist_pose_graph.py's ring).

The ranks are separate processes that import no jax
(tests/torch_dist_worker.py, each run bounded at 110 s). Tolerances: R,
t, X (and the pose graph's s) within 1e-4; chi2 within 1e-4 relative, or
1e-6 where it has fallen to nothing (float32 sums in another order, a
closed-form 3x3 inverse against jnp.linalg.inv). The sharded results also
match the port's single-device solvers run with the same fixed schedule
(``accept_all``) within 1e-4. The global BA through LoopCloser.poll_gba's
process-group branch meets tests/test_parallel.py's gates and matches the
same schedule on one device within 1e-4.
"""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from orb_slam2_with_comment_tpu.parallel import dist_ba as jdist_ba
from orb_slam2_with_comment_tpu.parallel import (
    dist_pose_graph as jdist_pg)
from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu_torch.optim import ba, pose_graph
from orb_slam2_with_comment_tpu_torch.optim.pose_graph import (
    PoseGraphProblem)
from orb_slam2_with_comment_tpu_torch.optim.residuals import CamParams

from test_dist_pose_graph import build_ring_problem
from test_optim import CAM as JCAM, build_ba_problem

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
CAM = CamParams.of(500.0, 500.0, 320.0, 240.0, 40.0)
# (noise, iterations): tests/test_parallel.py's three cases
BA_CASES = [(0.0, 12), (0.5, 8), (0.3, 5)]
# (iterations, fix_scale): tests/test_dist_pose_graph.py's three cases
PG_CASES = [(20, False), (5, False), (10, True)]
WORLDS = (2, 4)


def _mesh(axis):
    devs = np.array(jax.devices()[:8])
    assert len(devs) == 8, "conftest must force an 8-device CPU platform"
    return Mesh(devs, (axis,))


def _frames():
    """tests/test_parallel.py's GBA scene at 320x240: six orbit keyframes
    of SyntheticWorld(seed=6), float depth in metres."""
    world = SyntheticWorld(seed=6)
    imgs, depths, Rs, ts = [], [], [], []
    for R, t in orbit_trajectory(n_frames=6):
        img, d = world.render(R, t, fx=250.0, fy=250.0, cx=160.0, cy=120.0,
                              width=320, height=240)
        imgs.append(img.astype(np.float32))
        depths.append(d.astype(np.float32))
        Rs.append(np.asarray(R, np.float32))
        ts.append(np.asarray(t, np.float32))
    return dict(gba_imgs=np.stack(imgs), gba_depths=np.stack(depths),
                gba_R=np.stack(Rs), gba_t=np.stack(ts))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The problems, the JAX package's results on its mesh, and the port's
    over 2 and 4 ranks."""
    data, jax_out, probs = {}, {}, {}
    mesh = _mesh("lm")
    for i, (noise, iters) in enumerate(BA_CASES):
        prob, *_ = build_ba_problem(n_poses=4, n_pts=128, noise=noise)
        probs[f"ba{i}"] = prob
        for f in prob._fields:
            data[f"ba{i}_{f}"] = np.asarray(getattr(prob, f))
        data[f"ba{i}_iters"] = np.int64(iters)
        _, _, _, chi2_0 = jdist_ba.ba_step_sharded(JCAM, prob, mesh)
        R, t, X, chi2 = jdist_ba.ba_solve_sharded(JCAM, prob, mesh,
                                                  iters=iters)
        jax_out[f"ba{i}"] = dict(R=R, t=t, X=X, chi2=chi2, chi2_0=chi2_0)
    mesh = _mesh("edge")
    for i, (iters, fix_scale) in enumerate(PG_CASES):
        prob, _ = build_ring_problem()
        probs[f"pg{i}"] = prob
        for f in prob._fields:
            data[f"pg{i}_{f}"] = np.asarray(getattr(prob, f))
        data[f"pg{i}_iters"] = np.int64(iters)
        data[f"pg{i}_fix_scale"] = np.bool_(fix_scale)
        jax_out[f"pg{i}"] = jdist_pg.optimize_pose_graph_sharded(
            prob, mesh, iters=iters, fix_scale=fix_scale)._asdict()
    jax_out = jax.device_get(jax_out)
    tmp = tmp_path_factory.mktemp("dist")
    port = {}
    for world in WORLDS:
        inp, out = tmp / f"in{world}.npz", tmp / f"out{world}.npz"
        extra = _frames() if world == 2 else {}
        np.savez(inp, **data, **extra)
        env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "torch_dist_worker.py"),
             str(inp), str(out), "--nprocs", str(world)],
            capture_output=True, text=True, timeout=120, env=env)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        port[world] = dict(np.load(out))
    return probs, jax_out, port


def _close(got, want, what, tol=1e-4):
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol,
                               err_msg=what)


def _chi2_close(got, want, what):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4, atol=1e-6,
                               err_msg=what)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", range(len(BA_CASES)))
def test_dist_ba_matches_jax(runs, world, case):
    probs, jax_out, port = runs
    got, want = port[world], jax_out[f"ba{case}"]
    for f in ("R", "t", "X"):
        _close(got[f"ba{case}_{f}"], want[f], f)
    for f in ("chi2", "chi2_0"):
        _chi2_close(got[f"ba{case}_{f}"], want[f], f)


@pytest.mark.parametrize("world", WORLDS)
def test_dist_ba_matches_the_single_device_schedule(runs, world):
    probs, _, port = runs
    for case, (_, iters) in enumerate(BA_CASES):
        p = probs[f"ba{case}"]
        prob = ba.BAProblem(*(torch.as_tensor(np.asarray(a)) for a in p))
        prob = prob._replace(obs_pose=prob.obs_pose.long())
        ref = ba.ba_solve(CAM, prob, iters=iters, robust=True,
                          accept_all=True)
        for f in ("R", "t", "X"):
            _close(port[world][f"ba{case}_{f}"], getattr(ref, f).numpy(), f)


@pytest.mark.parametrize("world", WORLDS)
def test_dist_ba_fixed_pose_and_chi2(runs, world):
    """tests/test_parallel.py's gates: the fixed pose unmoved, chi2 falls
    on the noisy problem, the noise-free one reaches the truth."""
    probs, _, port = runs
    got = port[world]
    p = probs["ba2"]
    np.testing.assert_allclose(got["ba2_R"][0], np.asarray(p.R[0]), atol=1e-7)
    np.testing.assert_allclose(got["ba2_t"][0], np.asarray(p.t[0]), atol=1e-7)
    assert float(got["ba1_chi2"]) < float(got["ba1_chi2_0"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", range(len(PG_CASES)))
def test_dist_pose_graph_matches_jax(runs, world, case):
    probs, jax_out, port = runs
    got, want = port[world], jax_out[f"pg{case}"]
    for f in ("R", "t", "s"):
        _close(got[f"pg{case}_{f}"], want[f], f)
    _chi2_close(got[f"pg{case}_chi2"], want["chi2"], "chi2")
    ref = pose_graph.optimize_pose_graph(
        PoseGraphProblem(*(torch.as_tensor(np.asarray(a))
                           for a in probs[f"pg{case}"]))._replace(
            e_i=torch.as_tensor(np.asarray(probs[f"pg{case}"].e_i)).long(),
            e_j=torch.as_tensor(np.asarray(probs[f"pg{case}"].e_j)).long()),
        iters=PG_CASES[case][0], fix_scale=PG_CASES[case][1],
        accept_all=True)
    for f in ("R", "t", "s"):
        _close(got[f"pg{case}_{f}"], getattr(ref, f).numpy(), f)


@pytest.mark.parametrize("world", WORLDS)
def test_dist_pose_graph_fixed_vertex_and_scale(runs, world):
    probs, _, port = runs
    got = port[world]
    assert float(got["pg0_chi2"]) < 1e-4
    np.testing.assert_allclose(got["pg1_t"][0], np.asarray(probs["pg1"].t[0]),
                               atol=1e-7)
    np.testing.assert_allclose(got["pg2_s"], np.ones(got["pg2_s"].shape),
                               atol=1e-6)


def test_poll_gba_through_the_group(runs):
    """The process-group branch over 2 ranks: the landmark rows divide,
    the GBA completes in its 5 chunks, stays finite and near the truth the
    map was built from (tests/test_parallel.py's gates), and equals the
    same fixed schedule on one device."""
    got = runs[2][2]
    assert int(got["gba_Lp"]) % 2 == 0 and int(got["gba_polls"]) == 5
    assert np.isfinite(got["gba_kf_t"]).all()
    assert np.isfinite(got["gba_lm_pw"]).all()
    dt = np.linalg.norm(got["gba_kf_t"][:6] - got["gba_kf_t0"][:6], axis=1)
    assert dt.max() < 0.05, dt
    for f in ("kf_t", "kf_R", "lm_pw"):
        _close(got[f"gba_{f}"], got[f"gba_ref_{f}"], f)
