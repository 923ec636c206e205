"""The map writes of the PyTorch port without a host wait, on the CPU.

- ``set_last`` against its earlier form, which picked the winning writes
  with a boolean index (a wait on the card): duplicate-heavy index sets,
  1-D and tuple indices, row and broadcast values, bool, int and float
  tables; exact.
- ``steps.insert_keyframe`` and ``steps.merge_duplicate_landmarks`` against
  the JAX package's, on maps the JAX package built from a synthetic scene
  seen from four poses (depth landmarks at each keyframe, so each new
  keyframe's landmarks duplicate older ones): every table exact, with the
  duplicate sweep's window at the start of the table, inside it and at
  its end.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_with_comment_tpu.mapstate import map as jmap
from orb_slam2_with_comment_tpu.matching.search import FeatureSet as JFeats
from orb_slam2_with_comment_tpu.optim.residuals import CamParams as JCam
from orb_slam2_with_comment_tpu.pipeline import steps as jsteps
from orb_slam2_with_comment_tpu_torch import convert
from orb_slam2_with_comment_tpu_torch.mapstate.map import set_last
from orb_slam2_with_comment_tpu_torch.matching.search import FeatureSet
from orb_slam2_with_comment_tpu_torch.pipeline import steps

torch.set_num_threads(2)


def set_last_by_mask(dst, index, values):
    """The earlier form of set_last: the winners through a boolean index."""
    if not isinstance(index, tuple):
        index = (index,)
    index = tuple(i.long() for i in index)
    flat = index[0]
    for dim, i in zip(dst.shape[1:len(index)], index[1:]):
        flat = flat * dim + i
    B = flat.shape[0]
    order = torch.arange(B)
    n = int(np.prod(dst.shape[:len(index)]))
    winner = torch.full((n,), -1, dtype=torch.long).scatter_reduce(
        0, flat, order, "amax")
    last = winner[flat] == order
    values = torch.as_tensor(values, dtype=dst.dtype).expand(
        B, *dst.shape[len(index):])
    out = dst.clone()
    out[tuple(i[last] for i in index)] = values[last]
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("case", ["vector", "rows", "tuple", "broadcast",
                                  "bool", "empty", "all_one_slot"])
def test_set_last_matches_the_boolean_index_form(case, seed):
    rng = np.random.RandomState(seed)
    B = 300
    if case == "vector":
        dst = torch.as_tensor(rng.randn(50).astype(np.float32))
        idx = torch.as_tensor(rng.randint(0, 50, B), dtype=torch.int32)
        vals = torch.as_tensor(rng.randn(B).astype(np.float32))
    elif case == "rows":
        dst = torch.as_tensor(rng.randn(40, 3, 3).astype(np.float32))
        idx = torch.as_tensor(rng.randint(0, 40, B))
        vals = torch.as_tensor(rng.randn(B, 3, 3).astype(np.float32))
    elif case == "tuple":
        dst = torch.as_tensor(rng.randint(-1, 9, (30, 6)), dtype=torch.int32)
        idx = (torch.as_tensor(rng.randint(0, 30, B), dtype=torch.int32),
               torch.as_tensor(rng.randint(0, 6, B), dtype=torch.int32))
        vals = torch.as_tensor(rng.randint(0, 1000, B), dtype=torch.int32)
    elif case == "broadcast":
        dst = torch.as_tensor(rng.randint(0, 5, (20, 8)), dtype=torch.int32)
        idx = torch.as_tensor(rng.randint(0, 20, B))
        vals = 7
    elif case == "bool":
        dst = torch.as_tensor(rng.rand(64) < 0.5)
        idx = torch.as_tensor(rng.randint(0, 64, B))
        vals = torch.as_tensor(rng.rand(B) < 0.5)
    elif case == "empty":
        dst = torch.as_tensor(rng.randn(10, 2).astype(np.float32))
        idx = torch.zeros(0, dtype=torch.long)
        vals = torch.zeros((0, 2))
    else:  # every write to one element: the last one wins
        dst = torch.zeros(5, dtype=torch.int32)
        idx = torch.full((B,), 3)
        vals = torch.as_tensor(rng.permutation(B), dtype=torch.int32)
    got = set_last(dst, idx, vals)
    want = set_last_by_mask(dst, idx, vals)
    assert got.dtype == dst.dtype and got.shape == dst.shape
    assert torch.equal(got, want)
    if case == "all_one_slot":
        assert int(got[3]) == int(vals[-1])


CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, bf=20.0)
MAP = jmap.MapConfig(k_max=6, n_feat=200, l_max=1024, d_max=6)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _frames(rng, n_kf=4, n_pts=400, N=200):
    """A point cloud with a descriptor per point, seen from n_kf poses: per
    keyframe N features (the visible points' projections, their
    descriptors with a few flipped bits, their depth)."""
    P = np.stack([rng.uniform(-1.5, 1.5, n_pts), rng.uniform(-1.0, 1.0, n_pts),
                  rng.uniform(2.0, 4.0, n_pts)], 1).astype(np.float32)
    desc = rng.randint(0, 2 ** 32, (n_pts, 8), dtype=np.uint64).astype(
        np.uint32)
    out = []
    for k in range(n_kf):
        R = _rot_y(0.02 * k)
        t = np.float32([-0.05 * k, 0.0, 0.0])
        Xc = P @ R.T + t
        u = CAM["fx"] * Xc[:, 0] / Xc[:, 2] + CAM["cx"]
        v = CAM["fy"] * Xc[:, 1] / Xc[:, 2] + CAM["cy"]
        seen = np.where((u > 0) & (u < 320) & (v > 0) & (v < 240))[0]
        pick = rng.permutation(seen)[:N]
        d = desc[pick].copy()
        flips = rng.randint(0, 256, (len(pick), 3))
        for j in range(3):
            d[np.arange(len(pick)), flips[:, j] // 32] ^= (
                np.uint32(1) << (flips[:, j] % 32).astype(np.uint32))
        n = len(pick)
        xy = np.zeros((N, 2), np.float32)
        xy[:n] = np.stack([u[pick], v[pick]], 1)
        depth = np.full(N, -1.0, np.float32)
        depth[:n] = Xc[pick, 2]
        dd = np.zeros((N, 8), np.uint32)
        dd[:n] = d
        valid = np.arange(N) < n
        octave = rng.randint(0, 4, N).astype(np.int32)
        ur = np.where(depth > 0,
                      xy[:, 0] - CAM["bf"] / np.maximum(depth, 1e-6),
                      -1.0).astype(np.float32)
        out.append((R, t, xy, ur, octave, rng.uniform(-3, 3, N).astype(
            np.float32), dd, valid, depth))
    return out


def _jobs(f, lm):
    R, t, xy, ur, octave, angle, desc, valid, depth = f
    return jsteps.FrameObs(JFeats(*(jnp.asarray(a) for a in (
        xy, ur, octave, angle, desc, valid))), jnp.asarray(depth),
        jnp.asarray(lm))


def _tobs(f, lm):
    R, t, xy, ur, octave, angle, desc, valid, depth = f
    return steps.FrameObs(FeatureSet(
        torch.as_tensor(xy), torch.as_tensor(ur), torch.as_tensor(octave),
        torch.as_tensor(angle), torch.as_tensor(desc.view(np.int32)),
        torch.as_tensor(valid)), torch.as_tensor(depth),
        torch.as_tensor(lm, dtype=torch.int32))


def _assert_same(m, jm):
    got = convert.map_to_numpy(m)
    want = jax.device_get(jm)
    for f in got:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.fixture(scope="module")
def maps():
    """Per keyframe, the JAX map before the insert, the frame and its
    landmark matches, and the JAX map after insert + depth landmarks."""
    rng = np.random.RandomState(3)
    jcam = JCam(*[jnp.float32(v) for v in CAM.values()])
    jm = jmap.empty_map(MAP)
    out = []
    for k, f in enumerate(_frames(rng)):
        n_lm = int(jm.n_lm)
        lm = np.where(rng.rand(MAP.n_feat) < 0.5,
                      rng.randint(0, max(n_lm, 1), MAP.n_feat), -1)
        lm = np.where(n_lm > 0, lm, -1).astype(np.int32)
        before = jax.device_get(jm)
        jm = jsteps.insert_keyframe(jm, jcam, _jobs(f, lm), jnp.asarray(f[0]),
                                    jnp.asarray(f[1]), jnp.int32(10 + k))
        inserted = jax.device_get(jm)
        jm = jsteps.create_depth_landmarks(jm, jcam, jnp.int32(k),
                                           jnp.float32(3.0))
        out.append((before, f, lm, inserted, jax.device_get(jm)))
    return out


@pytest.mark.parametrize("k", range(4))
def test_insert_keyframe_matches_jax(maps, k):
    before, f, lm, inserted, _ = maps[k]
    m = convert.map_from_numpy(before, "cpu")
    got = steps.insert_keyframe(m, _tobs(f, lm), torch.as_tensor(f[0]),
                                torch.as_tensor(f[1]), 10 + k)
    _assert_same(got, inserted)
    assert int(got.n_kf) == k + 1


@pytest.mark.parametrize("k", range(1, 4))
@pytest.mark.parametrize("block", [1024, 256, 160])
def test_merge_duplicate_landmarks_matches_jax(maps, k, block):
    """block 1024 is the whole table, the fresh landmarks' window starts at
    the table's start; 256 and 160 start it inside the table."""
    jm = maps[k][4]
    want = jsteps.merge_duplicate_landmarks(jm, jnp.int32(k), block=block)
    got = steps.merge_duplicate_landmarks(convert.map_from_numpy(jm, "cpu"), k,
                                          block=block)
    _assert_same(got, want)
    merged = int((np.asarray(jm.lm_valid) & ~convert.map_to_numpy(got)[
        "lm_valid"]).sum())
    assert merged > 0  # the fresh landmarks duplicate older ones


def test_merge_window_at_the_end_of_the_table(maps):
    """n_lm at capacity: the window is clamped to the table's last rows."""
    jm = maps[3][4]
    L = MAP.l_max
    full = jm._replace(n_lm=np.int32(L))
    got = steps.merge_duplicate_landmarks(
        convert.map_from_numpy(full, "cpu"), 3, block=128)
    want = jsteps.merge_duplicate_landmarks(full, jnp.int32(3), block=128)
    _assert_same(got, want)
