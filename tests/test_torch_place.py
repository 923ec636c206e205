"""The BoW vocabulary of the PyTorch port against the JAX package's, on
the CPU, with the packaged vocabulary (98,411 nodes, k=10, 5 levels,
88,570 words) read by both.

- transform: word ids bit-exact (integer descent, first minimum wins);
- bow_sparse: word ids exact, weights within 1e-6 (float32 sums of the
  L1 normalization in another order);
- score_l1_sparse: scores within 1e-6.

Descriptors: ORB descriptors of a rendered synthetic frame (the
distribution the tracker feeds the tree) and uniformly random ones, with
invalid rows and repeated descriptors (tf > 1).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_with_comment_tpu.place import vocabulary as JV
from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu_torch.frontend.extractor import OrbExtractor
from orb_slam2_with_comment_tpu_torch.place import vocabulary as V

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def vocs():
    return V.load_default_vocabulary("cpu"), JV.load_default_vocabulary(
        as_numpy=True)


@pytest.fixture(scope="module")
def descriptors():
    """[4, 500, 8] uint32: two rendered frames and two random sets."""
    world = SyntheticWorld(seed=1)
    ext = OrbExtractor(n_features=500)
    out = []
    for R, t in orbit_trajectory(12)[::6]:
        img, _ = world.render(R, t, fx=250.0, fy=250.0, cx=160.0, cy=120.0,
                              width=320, height=240)
        f = ext._extract(torch.as_tensor(np.clip(img, 0, 255).astype(
            np.uint8)))
        out.append(f.desc.numpy().view(np.uint32))
    rng = np.random.RandomState(0)
    for _ in range(2):
        d = rng.randint(0, 2 ** 32, (500, 8), dtype=np.uint64).astype(
            np.uint32)
        d[100:140] = d[0]  # one descriptor 41 times
        out.append(d)
    valid = np.ones((4, 500), bool)
    valid[:, 450:] = False
    valid[1, ::7] = False
    return np.stack(out), valid


def test_vocabulary_loads_as_packaged(vocs):
    voc, jvoc = vocs
    assert (voc.k, voc.levels, voc.n_words) == (jvoc.k, jvoc.levels,
                                                jvoc.n_words) == (10, 5, 88570)
    assert voc.node_desc.shape == (98411, 8)
    np.testing.assert_array_equal(voc.node_desc.numpy().view(np.uint32),
                                  jvoc.node_desc)


def _words(vocs, desc, valid):
    voc, jvoc = vocs
    got = V.transform(voc, torch.as_tensor(desc.view(np.int32)),
                      torch.as_tensor(valid))
    want = JV.transform(jvoc, jnp.asarray(desc), jnp.asarray(valid))
    return got, np.asarray(want)


@pytest.mark.parametrize("row", range(4))
def test_transform_words_bit_exact(vocs, descriptors, row):
    desc, valid = descriptors
    got, want = _words(vocs, desc[row], valid[row])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[valid[row]] >= 0).all() and (want[~valid[row]] == -1).all()


@pytest.mark.parametrize("cap", [500, 600, 64])
def test_bow_sparse_matches_jax(vocs, descriptors, cap):
    voc, jvoc = vocs
    desc, valid = descriptors
    for row in range(4):
        words, jwords = _words(vocs, desc[row], valid[row])
        idx, w = V.bow_sparse(voc, words, torch.as_tensor(valid[row]), cap)
        jidx, jw = JV.bow_sparse(jvoc, jnp.asarray(jwords),
                                 jnp.asarray(valid[row]), cap)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-6)
    assert w.shape == (cap,)


def test_score_l1_sparse_matches_jax(vocs, descriptors):
    voc, jvoc = vocs
    desc, valid = descriptors
    rows, jrows = [], []
    for row in range(4):
        words, jwords = _words(vocs, desc[row], valid[row])
        rows.append(V.bow_sparse(voc, words, torch.as_tensor(valid[row]),
                                 500))
        jrows.append(JV.bow_sparse(jvoc, jnp.asarray(jwords),
                                   jnp.asarray(valid[row]), 500))
    db_idx = torch.stack([r[0] for r in rows] + [torch.full((500,), -1,
                                                            dtype=torch.int32)])
    db_w = torch.stack([r[1] for r in rows] + [torch.zeros(500)])
    for q in range(4):
        got = V.score_l1_sparse(rows[q][0], rows[q][1], db_idx, db_w,
                                voc.n_words)
        want = JV.score_l1_sparse(jrows[q][0], jrows[q][1],
                                  jnp.asarray(db_idx.numpy()),
                                  jnp.asarray(db_w.numpy()), jvoc.n_words)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
        assert abs(got[q].item() - 1.0) < 1e-5 and got[4].item() == 0.0
