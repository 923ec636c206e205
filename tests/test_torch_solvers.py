"""Sim(3) geometry, the Horn/Sim3/EPnP solvers and the Sim3 and pose-graph
optimizers of the PyTorch port against the JAX package, on the CPU.

The RANSAC solvers are fed the JAX package's own samples, drawn in the
test by the same jax.random calls its solvers make (categorical for the
Sim3 triplets, Gumbel top-k for the EPnP quadruples), so the winning
hypothesis and its inlier mask must be identical; the winning pose agrees
within 1e-4 (float32 SVD/eigh in another library). Tolerances:

- sim3 exp/log/compose/inverse: 1e-5 absolute (float32 arithmetic);
- Horn: 1e-5 on R, t and s;
- optimize_sim3: 1e-4 on R, t and s after 10 LM iterations, inlier mask
  exact;
- pose graph: edge Jacobians, H and b within 1e-4 relative to their
  largest entry; the optimized poses within 1e-4 after 20 iterations.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_with_comment_tpu.geometry import sim3 as jsim3
from orb_slam2_with_comment_tpu.optim import pose_graph as jpg
from orb_slam2_with_comment_tpu.optim import sim3_opt as jso
from orb_slam2_with_comment_tpu.solvers import horn as jhorn
from orb_slam2_with_comment_tpu.solvers import pnp as jpnp
from orb_slam2_with_comment_tpu.solvers import sim3solver as jss
from orb_slam2_with_comment_tpu_torch.geometry import se3, sim3
from orb_slam2_with_comment_tpu_torch.optim import pose_graph, sim3_opt
from orb_slam2_with_comment_tpu_torch.solvers import horn, pnp, sim3solver

torch.set_num_threads(2)
K = (500.0, 500.0, 320.0, 240.0)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _rot(rng, scale=1.0):
    w = rng.normal(size=3).astype(np.float32) * scale
    return se3.exp_so3(torch.as_tensor(w)).numpy()


def _random_sim3(rng, n):
    xi = rng.normal(size=(n, 7)).astype(np.float32) * 0.5
    xi[:, 6] *= 0.6
    return xi


def test_sim3_exp_log_compose_match_jax():
    rng = np.random.RandomState(0)
    xi = _random_sim3(rng, 64)
    xi[:4, 3:6] = 0.0  # zero rotation
    xi[4:8, 6] = 0.0  # unit scale
    xi[8:10, 3:7] = 1e-7  # both tiny
    got = sim3.exp(_t(xi))
    want = jsim3.exp(jnp.asarray(xi))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    np.testing.assert_allclose(sim3.log(*got).numpy(),
                               np.asarray(jsim3.log(*want)), atol=1e-5)
    a, b = sim3.exp(_t(xi)), sim3.exp(_t(xi[::-1].copy()))
    ja, jb = jsim3.exp(jnp.asarray(xi)), jsim3.exp(jnp.asarray(xi[::-1]))
    for g, w in zip(sim3.compose(*a, *b), jsim3.compose(*ja, *jb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    for g, w in zip(sim3.inverse(*a), jsim3.inverse(*ja)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    X = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        sim3.transform(*a, _t(X)).numpy(),
        np.asarray(jsim3.transform(*ja, jnp.asarray(X))), atol=1e-5)


@pytest.mark.parametrize("with_scale", [True, False])
def test_horn_matches_jax(with_scale):
    rng = np.random.RandomState(1)
    P2 = rng.normal(size=(32, 6, 3)).astype(np.float32)
    R = np.stack([_rot(rng) for _ in range(32)])
    P1 = (1.7 * np.einsum("bij,bnj->bni", R, P2) + 0.3).astype(np.float32)
    P1 += rng.normal(size=P1.shape).astype(np.float32) * 0.01
    w = np.ones((32, 6), np.float32)
    w[np.arange(32), rng.randint(0, 6, 32)] = 0.0  # >= 5 points per set
    for ww in (None, w):
        got = horn.solve(_t(P1), _t(P2), with_scale,
                         None if ww is None else _t(ww))
        want = jhorn.solve(jnp.asarray(P1), jnp.asarray(P2), with_scale,
                           None if ww is None else jnp.asarray(ww))
        for g, v in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(v), atol=1e-5)


def test_horn_nan_sample_is_nan_not_an_error():
    P = torch.zeros((2, 3, 3))
    P[0, 0, 0] = float("nan")
    R, t, s = horn.solve(P, P)
    assert torch.isnan(R[0]).all() and torch.isfinite(R[1]).all()


def _sim3_problem(rng, N=300, outliers=0.3, s12=1.15):
    X2 = np.stack([rng.uniform(-1.5, 1.5, N), rng.uniform(-1, 1, N),
                   rng.uniform(2, 6, N)], -1).astype(np.float32)
    R12 = _rot(rng, 0.1)
    t12 = np.float32([0.2, -0.1, 0.3])
    s12 = np.float32(s12)
    X1 = (s12 * X2 @ R12.T + t12).astype(np.float32)

    def proj(X):
        return np.stack([K[0] * X[:, 0] / X[:, 2] + K[2],
                         K[1] * X[:, 1] / X[:, 2] + K[3]], -1)

    uv1 = (proj(X1) + rng.normal(size=(N, 2)) * 0.5).astype(np.float32)
    uv2 = (proj(X2) + rng.normal(size=(N, 2)) * 0.5).astype(np.float32)
    bad = rng.uniform(size=N) < outliers
    X1[bad] += rng.normal(size=(int(bad.sum()), 3)).astype(np.float32)
    s2 = rng.choice([1.0, 1.44, 2.0736], N).astype(np.float32)
    valid = rng.uniform(size=N) > 0.1
    return X1, X2, uv1, uv2, s2, valid


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_from_jax_samples(fix_scale):
    rng = np.random.RandomState(2)
    X1, X2, uv1, uv2, s2, valid = _sim3_problem(
        rng, s12=1.0 if fix_scale else 1.15)
    key = jax.random.PRNGKey(3)
    T = 300
    # the draw jss.solve_ransac makes from ``key``
    probs = valid.astype(np.float32) / max(valid.sum(), 1)
    idx = np.asarray(jax.random.categorical(
        key, jnp.log(jnp.clip(jnp.asarray(probs), 1e-12, None))[None, :]
        .repeat(T * 3, 0)).reshape(T, 3))
    want = jss.solve_ransac(key, K, K, X1, X2, uv1, uv2, s2, s2, valid,
                            max_iters=T, fix_scale=fix_scale)
    got = sim3solver.solve_from_samples(
        torch.as_tensor(idx).long(), K, K, _t(X1), _t(X2), _t(uv1), _t(uv2),
        _t(s2), _t(s2), _t(valid), fix_scale=fix_scale)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) > 100
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_sim3_sampler_draws_valid_slots_with_replacement():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 7, 11]] = True
    gen = torch.Generator().manual_seed(0)
    idx = sim3solver.sample_triplets(gen, valid, 400)
    assert idx.shape == (400, 3)
    assert set(idx.unique().tolist()) == {3, 7, 11}
    assert (idx[:, 0] == idx[:, 1]).any()  # with replacement


def _pnp_problem(rng, N=200, outliers=0.3, noise=0.5):
    Xc = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                   rng.uniform(3, 8, N)], -1).astype(np.float32)
    R = _rot(rng, 0.2)
    t = np.float32([0.3, -0.2, 0.5])
    Xw = ((Xc - t) @ R).astype(np.float32)  # Xc = R Xw + t
    uv = np.stack([K[0] * Xc[:, 0] / Xc[:, 2] + K[2],
                   K[1] * Xc[:, 1] / Xc[:, 2] + K[3]], -1).astype(np.float32)
    uv += rng.normal(size=uv.shape).astype(np.float32) * noise
    bad = rng.uniform(size=N) < outliers
    uv[bad] += rng.uniform(-80, 80, (int(bad.sum()), 2)).astype(np.float32)
    s2 = rng.choice([1.0, 1.44, 2.0736], N).astype(np.float32)
    valid = rng.uniform(size=N) > 0.1
    return Xw, uv, s2, valid, R, t


def _jax_quads(key, valid, T, S=4):
    g = jax.random.gumbel(key, (T, valid.shape[0]))
    g = jnp.where(jnp.asarray(valid)[None, :], g, -jnp.inf)
    return np.asarray(jax.lax.top_k(g, S)[1])


def test_epnp_ransac_from_jax_samples():
    rng = np.random.RandomState(4)
    Xw, uv, s2, valid, R, t = _pnp_problem(rng)
    key = jax.random.PRNGKey(5)
    idx = _jax_quads(key, valid, 300)
    want = jpnp.solve_ransac(key, K, *(jnp.asarray(a) for a in (
        Xw, uv, s2, valid)), max_iters=300)
    got = pnp.solve_from_samples(torch.as_tensor(idx).long(), K, _t(Xw),
                                 _t(uv), _t(s2), _t(valid))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) > 100
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), t, atol=0.05)


def test_epnp_refine_matches_jax():
    """The weighted all-inlier EPnP of the Refine pass, on noisy data with
    outliers weighted out: pose within 1e-4 and error within 1e-3 px^2 of
    the JAX package's."""
    rng = np.random.RandomState(6)
    Xw, uv, _, valid, _, _ = _pnp_problem(rng, outliers=0.2)
    w = valid.astype(np.float32)
    Rj, tj, ej = jpnp._epnp_core(jnp.asarray(Xw), jnp.asarray(uv),
                                 jnp.asarray(w), K)
    R, t, err = pnp.epnp(_t(Xw)[None], _t(uv)[None], _t(w)[None], K)
    np.testing.assert_allclose(R[0].numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(t[0].numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(err[0].item(), float(ej), atol=1e-3)


def test_epnp_degenerate_samples_do_not_raise():
    """A collinear sample scores +inf or keeps finite numbers, never
    raises; with fewer than 4 valid points the sampler fills the set with
    invalid slots, lowest first (the reference's fault, copied) and the
    solve returns no inliers, as the JAX package does."""
    rng = np.random.RandomState(8)
    Xw, uv, s2, valid, _, _ = _pnp_problem(rng)
    line = np.float32([[0, 0, 4], [1, 0, 5], [2, 0, 6], [3, 0, 7]])
    R, t, err = pnp.epnp(_t(line)[None], _t(uv[:4])[None], torch.ones(1, 4), K)
    assert torch.isfinite(R).all() and torch.isfinite(t).all()
    few = np.zeros_like(valid)
    few[[5, 9]] = True
    gen = torch.Generator().manual_seed(0)
    idx = pnp.sample_quads(gen, _t(few), 8)
    assert (idx[:, 2:] == torch.tensor([0, 1])).all()
    assert set(idx[:, :2].reshape(-1).tolist()) == {5, 9}
    got = pnp.solve_ransac(gen, K, _t(Xw), _t(uv), _t(s2), _t(few),
                           max_iters=8)
    want = jpnp.solve_ransac(jax.random.PRNGKey(0), K, *(
        jnp.asarray(a) for a in (Xw, uv, s2, few)), max_iters=8)
    assert int(got.n_inliers) == int(want.n_inliers) == 0


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_matches_jax(fix_scale):
    rng = np.random.RandomState(9)
    X1, X2, uv1, uv2, s2, valid = _sim3_problem(rng, N=200, outliers=0.2)
    R0 = (_rot(rng, 0.02) @ jss.solve_ransac(
        jax.random.PRNGKey(1), K, K, X1, X2, uv1, uv2, s2, s2,
        valid).R).astype(np.float32)
    t0 = np.float32([0.21, -0.08, 0.31])
    s0 = np.float32(1.0 if fix_scale else 1.12)
    inv = (1.0 / s2).astype(np.float32)
    want = jso.optimize_sim3(K, K, R0, t0, s0, X1, X2, uv1, uv2, inv, inv,
                             valid, fix_scale=fix_scale)
    got = sim3_opt.optimize_sim3(K, K, _t(R0), _t(t0), _t(s0), _t(X1),
                                 _t(X2), _t(uv1), _t(uv2), _t(inv), _t(inv),
                                 _t(valid), fix_scale=fix_scale)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def _graph(rng, N=8, fix_scale=True):
    """A chain of N Sim3 vertices plus a loop edge and a skip edge, with
    measurements from the true poses and the vertices perturbed."""
    xi = _random_sim3(rng, N) * 0.5
    if fix_scale:
        xi[:, 6] = 0.0
    R, t, s = (np.asarray(a) for a in jsim3.exp(jnp.asarray(xi)))
    e_i = np.int32(list(range(N - 1)) + [0, 2])
    e_j = np.int32(list(range(1, N)) + [N - 1, 5])
    iR, it, is_ = jsim3.inverse(R[e_i], t[e_i], s[e_i])
    mR, mt, ms = (np.asarray(a) for a in jsim3.compose(
        R[e_j], t[e_j], s[e_j], iR, it, is_))
    noise = _random_sim3(rng, N) * 0.05
    if fix_scale:
        noise[:, 6] = 0.0
    R0, t0, s0 = (np.asarray(a) for a in jsim3.retract(
        R, t, s, jnp.asarray(noise)))
    e_valid = np.ones(len(e_i), bool)
    e_valid[-1] = False
    fixed = np.zeros(N, bool)
    fixed[0] = True
    return (R0, t0, s0, e_i, e_j, mR, mt, ms, e_valid, fixed)


def test_pose_graph_jacobians_match_jax():
    rng = np.random.RandomState(10)
    R0, t0, s0, e_i, e_j, mR, mt, ms, _, _ = _graph(rng, fix_scale=False)
    args = (R0[e_i], t0[e_i], s0[e_i], R0[e_j], t0[e_j], s0[e_j], mR, mt, ms)

    def res(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, mR_, mt_, ms_):
        return jpg._edge_residual(*jsim3.retract(Ri, ti, si, xi_i),
                                  *jsim3.retract(Rj, tj, sj, xi_j),
                                  mR_, mt_, ms_)

    z = jnp.zeros((len(e_i), 7))
    Ji_w, Jj_w = jax.vmap(jax.jacfwd(res, argnums=(0, 1)))(z, z, *args)
    e_w = jax.vmap(jpg._edge_residual)(*args)
    e, Ji, Jj = pose_graph.edge_jacobians(*(_t(a) for a in args))
    np.testing.assert_allclose(e.numpy(), np.asarray(e_w), atol=1e-5)
    for g, w in ((Ji, Ji_w), (Jj, Jj_w)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max())
    H = np.einsum("eri,erj->ij", Ji.numpy(), Jj.numpy())
    H_w = np.einsum("eri,erj->ij", np.asarray(Ji_w), np.asarray(Jj_w))
    np.testing.assert_allclose(H, H_w, atol=1e-4 * np.abs(H_w).max())
    b = np.einsum("eri,er->i", Ji.numpy(), e.numpy())
    b_w = np.einsum("eri,er->i", np.asarray(Ji_w), np.asarray(e_w))
    np.testing.assert_allclose(b, b_w, atol=1e-4 * np.abs(b_w).max())


@pytest.mark.parametrize("fix_scale", [True, False])
def test_pose_graph_matches_jax(fix_scale):
    rng = np.random.RandomState(11)
    prob = _graph(rng, fix_scale=fix_scale)
    want = jpg.optimize_pose_graph(
        jpg.PoseGraphProblem(*(jnp.asarray(a) for a in prob)), iters=20,
        fix_scale=fix_scale)
    got = pose_graph.optimize_pose_graph(
        pose_graph.PoseGraphProblem(*(_t(a) for a in prob)), iters=20,
        fix_scale=fix_scale)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    assert float(got.chi2) < 1e-3 and float(want.chi2) < 1e-3
