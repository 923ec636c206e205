"""Hamming matcher of the PyTorch port against the JAX package.

The plain PyTorch versions (what the CPU runs) are held bit-exact against
the JAX package's XLA distance matrix, its Pallas kernel in interpret mode,
and matching/core.masked_best_two. The CUDA kernels are held against the
plain versions on a card in test_torch_cuda.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_with_comment_tpu.matching import core as jcore
from orb_slam2_with_comment_tpu.ops import hamming as jhamming
from orb_slam2_with_comment_tpu.ops.hamming_pallas import distance_matrix_pallas
from orb_slam2_with_comment_tpu_torch.ops import hamming

torch.set_num_threads(2)


def _desc(rng, n):
    return rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _t(d):
    return torch.as_tensor(d.view(np.int32))


def _pallas_cases():
    rng = np.random.RandomState(0)
    d = _desc(np.random.RandomState(1), 64)
    bit = np.zeros((1, 8), np.uint32)
    bit[0, 3] = 1 << 17
    return [("random", _desc(rng, 300), _desc(rng, 257)),
            ("identity", d, d),
            ("single_bit", np.zeros((1, 8), np.uint32), bit)]


@pytest.mark.parametrize("name,d1,d2", _pallas_cases(),
                         ids=[c[0] for c in _pallas_cases()])
def test_distance_matrix_matches_xla_and_pallas(name, d1, d2):
    out = hamming.distance_matrix(_t(d1), _t(d2)).numpy()
    xla = np.asarray(jhamming._distance_matrix_xla(jnp.asarray(d1),
                                                   jnp.asarray(d2)))
    pallas = np.asarray(distance_matrix_pallas(
        jnp.asarray(d1), jnp.asarray(d2), interpret=True))
    np.testing.assert_array_equal(out, xla)
    np.testing.assert_array_equal(out, pallas)


def _mask_cases():
    rng = np.random.RandomState(7)
    cases = []
    for q, n in ((300, 257), (64, 64), (20, 1), (1, 9)):
        dq, dt = _desc(rng, q), _desc(rng, n)
        if n > 4:
            dt[1::4] = dt[0::4][:dt[1::4].shape[0]]  # repeated minima: ties
            dq[:min(q, n) // 2] = dt[:min(q, n) // 2]
        mask = rng.rand(q, n) < 0.3
        mask[0] = False  # an all-masked row
        if q > 1:
            mask[1] = True
        cases.append((f"{q}x{n}", dq, dt, mask))
    return cases


@pytest.mark.parametrize("name,dq,dt,mask", _mask_cases(),
                         ids=[c[0] for c in _mask_cases()])
def test_masked_best_two_matches_core(name, dq, dt, mask):
    best, idx, second, idx2 = hamming.masked_best_two(
        _t(dq), _t(dt), torch.as_tensor(mask))
    dist = jhamming._distance_matrix_xla(jnp.asarray(dq), jnp.asarray(dt))
    jb, ji, js = (np.asarray(a) for a in jcore.masked_best_two(
        dist, jnp.asarray(mask)))
    np.testing.assert_array_equal(best.numpy(), jb)
    np.testing.assert_array_equal(idx.numpy(), ji)
    np.testing.assert_array_equal(second.numpy(), js)
    # idx2 is the first column attaining ``second`` among the others
    d = np.where(mask, np.asarray(dist), hamming.BIG)
    rows = np.arange(d.shape[0])
    if d.shape[1] > 1:
        np.testing.assert_array_equal(d[rows, idx2.numpy()], js)
        assert (idx2.numpy() != ji).all()
    assert best[0] == hamming.BIG and idx[0] == 0 and second[0] == hamming.BIG


def test_wrapper_refuses_mixed_devices():
    d = _t(_desc(np.random.RandomState(4), 4))
    with pytest.raises(ValueError):
        hamming.masked_best_two(d, d, torch.ones((4, 4), dtype=torch.bool)
                                .to("meta"))


def test_wrappers_check_inputs_and_count_no_cpu_launch():
    """The wrappers refuse what the kernel does not take, and a CPU call
    (plain version) adds nothing to the launch counts."""
    d = _t(_desc(np.random.RandomState(5), 6))
    mask = torch.ones((6, 6), dtype=torch.bool)
    before = dict(hamming.LAUNCHES)
    hamming.masked_best_two(d, d, mask)
    hamming.distance_matrix(d, d)
    assert hamming.LAUNCHES == before
    with pytest.raises(ValueError):
        hamming.distance_matrix(d.long(), d.long())
    with pytest.raises(ValueError):
        hamming.distance_matrix(d[:, :4], d[:, :4])
    with pytest.raises(ValueError):
        hamming.distance_matrix(d.t().contiguous().t(), d)
    with pytest.raises(ValueError):
        hamming.masked_best_two(d, d, mask[:5])
    with pytest.raises(ValueError):
        hamming.masked_best_two(d, d, mask.int())
    with pytest.raises(ValueError):
        hamming.masked_best_two(d, d[:0], mask[:, :0])
