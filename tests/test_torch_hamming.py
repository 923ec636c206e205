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


def _structured_cases():
    """The masks the fused kernel's head, tail and skip paths meet on the
    card: sparse row bands, odd row lengths (unaligned row starts), more
    than one 1024-column tile, all-false and all-true masks, and rows with
    exactly one admissible column."""
    rng = np.random.RandomState(11)
    cases = []
    for name, q, n in (("band_200x200", 200, 200), ("band_97x1241", 97, 1241),
                       ("band_60x999", 60, 999), ("tiles_40x2500", 40, 2500)):
        dq, dt = _desc(rng, q), _desc(rng, n)
        dt[1::4] = dt[0::4][:dt[1::4].shape[0]]
        dq[:min(q, n) // 2] = dt[:min(q, n) // 2]
        # a row band: columns whose "row" lies within 2 of the query's
        vq, vt = rng.uniform(0, 480, q), rng.uniform(0, 480, n)
        mask = np.abs(vq[:, None] - vt[None, :]) <= 2.0
        cases.append((name, dq, dt, mask))
    for name, fill in (("all_false_33x77", False), ("all_true_33x77", True)):
        dq, dt = _desc(rng, 33), _desc(rng, 77)
        cases.append((name, dq, dt, np.full((33, 77), fill)))
    dq, dt = _desc(rng, 70), _desc(rng, 70)
    cases.append(("one_admissible_70x70", dq, dt, np.eye(70, dtype=bool)))
    return cases


def _numpy_best_two(d):
    """Lexicographic (distance, column) top-2 of each row of d."""
    order = np.lexsort((np.broadcast_to(np.arange(d.shape[1]), d.shape), d),
                       axis=1)
    rows = np.arange(d.shape[0])
    i1, i2 = order[:, 0], order[:, 1]
    return d[rows, i1], i1, d[rows, i2], i2


@pytest.mark.parametrize("name,dq,dt,mask", _structured_cases(),
                         ids=[c[0] for c in _structured_cases()])
def test_masked_best_two_structured_masks(name, dq, dt, mask):
    got = [a.numpy() for a in hamming.masked_best_two(
        _t(dq), _t(dt), torch.as_tensor(mask))]
    dist = jhamming._distance_matrix_xla(jnp.asarray(dq), jnp.asarray(dt))
    jb, ji, js = (np.asarray(a) for a in jcore.masked_best_two(
        dist, jnp.asarray(mask)))
    for g, w in zip(got[:3], (jb, ji, js)):
        np.testing.assert_array_equal(g, w)
    # all four outputs against an independent numpy top-2, a masked
    # candidate counting as (BIG, its column)
    want = _numpy_best_two(np.where(mask, np.asarray(dist), hamming.BIG))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if not mask.any():
        assert (got[0] == hamming.BIG).all() and (got[1] == 0).all()
        assert (got[2] == hamming.BIG).all() and (got[3] == 1).all()


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
