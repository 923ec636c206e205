"""The BoW vocabulary of the PyTorch port against the JAX package's, on
the CPU, with the packaged vocabulary (98,411 nodes, k=10, 5 levels,
88,570 words) read by both.

- transform: word ids bit-exact (integer descent, first minimum wins);
- bow_sparse: word ids exact, weights within 1e-6 (float32 sums of the
  L1 normalization in another order);
- score_l1_sparse: scores within 1e-6;
- train_vocabulary: from the same descriptors and seed, the identical tree
  (node descriptors, children, leaf words, idf weights; k = 8, 2 and 3
  levels, seeds 0-4, tests/test_place.py's cases); save_vocabulary's files
  load in the other package, both ways, to the same arrays;
- bow_vectors and score_l1 (dense): within 1e-6 (float32 sums in another
  order; the port sums the norms in float64).

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


def _random_descs(seed: int, n: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 2 ** 32, (n, 8),
                                               dtype=np.uint32)


def _assert_same_tree(voc, jvoc):
    np.testing.assert_array_equal(voc.node_desc.numpy().view(np.uint32),
                                  np.asarray(jvoc.node_desc))
    for f in ("children", "leaf_word", "word_weight"):
        np.testing.assert_array_equal(getattr(voc, f).numpy(),
                                      np.asarray(getattr(jvoc, f)), err_msg=f)
    assert (voc.k, voc.levels, voc.n_words) == (
        jvoc.k, jvoc.levels, jvoc.n_words)


@pytest.mark.parametrize("levels", [2, 3])
@pytest.mark.parametrize("seed", range(5))
def test_train_vocabulary_identical_tree(levels, seed):
    descs = _random_descs(9 + seed, 2000)
    voc = V.train_vocabulary(descs, k=8, levels=levels, seed=seed,
                             device="cpu")
    _assert_same_tree(voc, JV.train_vocabulary(descs, k=8, levels=levels,
                                               seed=seed))
    # int32 descriptors (the port's layout) train the same tree
    again = V.train_vocabulary(torch.as_tensor(descs.view(np.int32)), k=8,
                               levels=levels, seed=seed, device="cpu")
    for a, b in zip(voc[:4], again[:4]):
        assert torch.equal(a, b)


def test_saved_vocabularies_load_both_ways(tmp_path):
    descs = _random_descs(11, 3000)
    voc = V.train_vocabulary(descs, k=8, levels=3, seed=3, device="cpu")
    jvoc = JV.train_vocabulary(descs, k=8, levels=3, seed=3)
    V.save_vocabulary(voc, str(tmp_path / "port"))
    JV.save_vocabulary(jvoc, str(tmp_path / "jax.npz"))
    _assert_same_tree(voc, JV.load_vocabulary(str(tmp_path / "port.npz"),
                                              as_numpy=True))
    _assert_same_tree(V.load_vocabulary(str(tmp_path / "jax.npz"), "cpu"),
                      jvoc)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype, f


@pytest.fixture(scope="module")
def small_vocs():
    descs = _random_descs(12, 3000)
    return (V.train_vocabulary(descs, k=8, levels=3, seed=1, device="cpu"),
            JV.train_vocabulary(descs, k=8, levels=3, seed=1), descs)


def test_bow_vectors_and_score_l1_match_jax(small_vocs):
    voc, jvoc, descs = small_vocs
    rng = np.random.RandomState(5)
    # five "images": rows of the training set, one noisy copy, one random,
    # invalid features and repeated descriptors among them
    rows = [descs[:300], descs[:300] ^ (rng.rand(300, 8) < 0.02).astype(
        np.uint32), _random_descs(13, 300), descs[300:600], descs[:300]]
    rows[3][:50] = rows[3][50:100]
    d = np.stack(rows)
    valid = rng.rand(5, 300) < 0.9
    valid[4] = valid[0]
    td = torch.as_tensor(d.view(np.int32))
    words = torch.stack([V.transform(voc, td[i], torch.as_tensor(valid[i]))
                         for i in range(5)])
    jwords = jnp.stack([JV.transform(jvoc, jnp.asarray(d[i]),
                                     jnp.asarray(valid[i]))
                        for i in range(5)])
    np.testing.assert_array_equal(words.numpy(), np.asarray(jwords))
    vv = V.bow_vectors(voc, words, torch.as_tensor(valid))
    jv = JV.bow_vectors(jvoc, jwords, jnp.asarray(valid))
    assert vv.shape == (5, voc.n_words)
    np.testing.assert_allclose(vv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    np.testing.assert_allclose(vv.sum(-1).numpy(), 1.0, atol=1e-5)
    s = V.score_l1(vv[0], vv)
    js = JV.score_l1(jv[0], jv)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    assert float(s[0]) == pytest.approx(1.0, abs=1e-6)
    assert float(s[4]) == float(s[0])  # the same image again
    assert float(s[1]) > float(s[2])  # the noisy copy beats a random set


def test_train_vocab_entry_point(tmp_path):
    """examples/train_vocab.py at a tiny size: it harvests the port
    extractor's descriptors, and its file holds the tree that
    train_vocabulary builds from them, readable by both packages."""
    from orb_slam2_with_comment_tpu_torch.examples import train_vocab
    out = str(tmp_path / "voc.npz")
    assert train_vocab.main(["--worlds", "1", "--frames", "2", "--k", "4",
                             "--levels", "2", "--out", out,
                             "--device", "cpu"]) == 0
    descs = train_vocab.harvest(1, 2, torch.device("cpu"), log=lambda m: None)
    assert descs.dtype == np.uint32 and len(descs) > 500
    want = V.train_vocabulary(descs, k=4, levels=2, seed=0, device="cpu")
    _assert_same_tree(want, JV.load_vocabulary(out, as_numpy=True))
