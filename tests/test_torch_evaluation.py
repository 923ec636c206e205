"""The evaluation metrics (RPE, KITTI segment drift, ATE) and the small API
gaps closed beside them (``se3.log_se3``, ``se3.quat_to_matrix``,
``map.observation_matrix``) of the PyTorch port against the JAX package's.

- ``rpe`` and ``kitti_segment_drift`` on the cases of
  tests/test_evaluation.py and on seeded random trajectories: every
  number of the port's result within 1e-9 of the JAX package's (both are
  the same float64 numpy code), and the cases' own assertions on the port.
- ``log_se3`` and ``quat_to_matrix`` within 1e-6 of each output's scale
  (float32 on both sides; as tests/test_torch_geometry.py), and their
  round trips as tests/test_geometry.py checks them.
- ``observation_matrix`` of a random map identical to the JAX package's.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_with_comment_tpu.evaluation import (
    kitti_segment_drift as jax_drift, rpe as jax_rpe)
from orb_slam2_with_comment_tpu.geometry import se3 as jse3
from orb_slam2_with_comment_tpu.mapstate import map as jmap
from orb_slam2_with_comment_tpu_torch import convert
from orb_slam2_with_comment_tpu_torch.evaluation import (
    align_umeyama, ate_rmse, kitti_segment_drift, rpe)
from orb_slam2_with_comment_tpu_torch.geometry import se3
from orb_slam2_with_comment_tpu_torch.mapstate import map as tmap

torch.set_num_threads(2)


def _traj(n=120, seed=0):
    """tests/test_evaluation.py's smooth trajectory, world->camera."""
    ang = np.linspace(0, np.pi / 3, n)
    Rs, ts = [], []
    for a in ang:
        c, s = np.cos(a), np.sin(a)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        C = np.array([10 * np.sin(a), 0.5 * a, 10 * (1 - np.cos(a))])
        Rs.append(R)
        ts.append(-R @ C)
    return np.stack(Rs), np.stack(ts)


def _rot(axis, a):
    c, s = np.cos(a), np.sin(a)
    i, j = [k for k in range(3) if k != axis]
    R = np.eye(3)
    R[i, i], R[i, j], R[j, i], R[j, j] = c, -s, s, c
    return R


def _random_traj(seed, n=80):
    """A seeded random walk of poses and a noisy estimate of it."""
    rng = np.random.RandomState(seed)
    R, C = [np.eye(3)], [np.zeros(3)]
    for _ in range(n - 1):
        d = _rot(0, rng.normal(0, 0.05)) @ _rot(1, rng.normal(0, 0.1))
        R.append(d @ R[-1])
        C.append(C[-1] + rng.normal(0, 0.3, 3))
    R, C = np.stack(R), np.stack(C)
    t = -np.einsum("nij,nj->ni", R, C)
    Re = np.stack([_rot(2, rng.normal(0, 0.01)) @ r for r in R])
    te = t + rng.normal(0, 0.02, t.shape)
    return Re, te, R, t


def _close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - want[k]) <= 1e-9, (k, got[k], want[k])


def _rigid_offset():
    R, t = _traj()
    Rg = _rot(2, 0.7)
    tg = np.array([3.0, -2.0, 1.0])
    R2 = np.einsum("nij,jk->nik", R, Rg.T)
    return R2, t - np.einsum("nij,j->ni", R2, tg), R, t


def _drift():
    R, t = _traj()
    drift = np.cumsum(np.full((len(t), 1), 0.01), axis=0)
    return R, t + np.concatenate([drift, np.zeros((len(t), 2))], 1), R, t


def _rotation():
    R, t = _traj()
    R2 = np.stack([_rot(2, 0.002 * i) @ R[i] for i in range(len(R))])
    return R2, t, R, t


RPE_CASES = {
    # name: (est_R, est_t, gt_R, gt_t), delta, check on the port's result
    "zero_error_on_identical": (lambda: (*_traj(), *_traj()), 1, lambda o: (
        o["trans_rmse"] < 1e-9 and o["rot_rmse"] < 1e-6
        and o["n_pairs"] == 119)),
    "rigid_offset_is_invisible": (_rigid_offset, 5, lambda o: (
        o["trans_rmse"] < 1e-9 and o["rot_rmse"] < 1e-6)),
    "detects_drift": (_drift, 1, lambda o: 0.005 < o["trans_rmse"] < 0.05),
    "rotation_error_measured": (_rotation, 1, lambda o: (
        abs(o["rot_mean"] - 0.002) < 0.002 * 0.2)),
    "random_seed_3": (lambda: _random_traj(3), 1,
                      lambda o: o["n_pairs"] == 79),
    "random_seed_4_delta_7": (lambda: _random_traj(4), 7,
                              lambda o: o["n_pairs"] == 73),
}


@pytest.mark.parametrize("name", sorted(RPE_CASES))
def test_rpe_matches_jax(name):
    make, delta, check = RPE_CASES[name]
    args = make()
    got = rpe(*args, delta=delta)
    _close(got, jax_rpe(*args, delta=delta))
    assert check(got)


def test_rpe_refuses_short_trajectory():
    R, t = _traj(n=3)
    with pytest.raises(ValueError):
        rpe(R, t, R, t, delta=3)


DRIFT_CASES = {
    "zero_on_identical": (lambda: (*_traj(400), *_traj(400)), (2, 4),
                          lambda o: o["n_segments"] > 0
                          and o["trans_pct"] < 1e-7),
    "scale_error_shows_as_translation_drift": (
        lambda: (_traj(400)[0], 1.05 * _traj(400)[1], *_traj(400)), (2, 4),
        lambda o: 2.0 < o["trans_pct"] < 9.0),
    "random_seed_5": (lambda: _random_traj(5, 300), (5, 10, 20),
                      lambda o: o["n_segments"] > 0),
    "too_short_for_any_segment": (lambda: _random_traj(6, 20), (100,),
                                  lambda o: o["n_segments"] == 0),
}


@pytest.mark.parametrize("name", sorted(DRIFT_CASES))
def test_kitti_segment_drift_matches_jax(name):
    make, lengths, check = DRIFT_CASES[name]
    args = make()
    got = kitti_segment_drift(*args, lengths=lengths)
    _close(got, jax_drift(*args, lengths=lengths))
    assert check(got)


def test_ate_scale_alignment():
    R, t = _traj()
    C = -np.einsum("nij,ni->nj", R, t)
    s, _, _ = align_umeyama(0.5 * C, C, with_scale=True)
    assert abs(s - 2.0) < 1e-6
    assert ate_rmse(0.5 * C, C, with_scale=True) < 1e-9


def _scaled_close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= 1e-6 * scale


def test_log_se3_matches_jax():
    rng = np.random.RandomState(7)
    xi = rng.randn(32, 6).astype(np.float32)
    xi[:2, 3:] = [[0, 0, 0], [1e-6, 0, 0]]
    R, t = (np.array(a) for a in jse3.exp_se3(jnp.asarray(xi)))
    got = se3.log_se3(torch.as_tensor(R), torch.as_tensor(t))
    _scaled_close(got.numpy(), np.asarray(jse3.log_se3(jnp.asarray(R),
                                                       jnp.asarray(t))))
    R2, t2 = se3.exp_se3(got)  # tests/test_geometry.py's round trip
    np.testing.assert_allclose(R2.numpy(), R, atol=2e-5)
    np.testing.assert_allclose(t2.numpy(), t, atol=2e-4)


def test_quat_to_matrix_matches_jax():
    rng = np.random.RandomState(8)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    got = se3.quat_to_matrix(torch.as_tensor(q)).numpy()
    _scaled_close(got, np.asarray(jse3.quat_to_matrix(jnp.asarray(q))))
    back = se3.quat_to_matrix(se3.matrix_to_quat(torch.as_tensor(got)))
    np.testing.assert_allclose(back.numpy(), got, atol=1e-5)


def test_observation_matrix_matches_jax():
    rng = np.random.RandomState(9)
    m = convert.map_to_numpy(tmap.empty_map(tmap.MapConfig(10, 20, 300, 4),
                                            "cpu"))
    m["lm_valid"][:250] = rng.uniform(size=250) < 0.8
    m["lm_obs_kf"][:250] = rng.randint(-1, 10, (250, 4))
    m["lm_obs_kf"][:250, 1] = m["lm_obs_kf"][:250, 0]  # repeated observers
    got = tmap.observation_matrix(convert.map_from_numpy(m, "cpu")).numpy()
    want = np.asarray(jmap.observation_matrix(jmap.MapState(
        **{f: jnp.asarray(v) for f, v in m.items()})))
    assert got.dtype == want.dtype == np.float32 and got.shape == (300, 10)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < 250 * 4
