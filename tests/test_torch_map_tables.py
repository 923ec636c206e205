"""The map's table-wide passes against their plain reference
(slambench/reference/mapping.py, written from ORB-SLAM2), and a drive that
gives the same result at two table sizes, on the CPU.

- ``covisibility_weights``, ``covisibility_matrix``,
  ``local_landmark_mask`` and the BoW scores of ``detect``
  (``score_l1_sparse``) on seeded random maps with K 8-64, N 64-256, L
  1,000-8,000 and D 12, filled to a fraction of L: culled keyframes and
  landmarks, empty observation slots anywhere in a row, features that hold
  a landmark whose registered observation is another feature of theirs.
  Weights and local landmarks compare exactly, as integers and sets. The
  BoW weights are multiples of 2^-10, so every float32 partial sum of the
  scores is exact whatever its order, and the scores compare exactly too.
- A stereo ``AutoTracker`` drive down the benchmark's street at a third of
  KITTI's resolution, at two table sizes: a 16-slot table, which fills, and
  a 24-slot one. Both have 16 keyframe slots and 8,192 landmark slots or
  more, so the searches and local BA gather windows of the same size
  (local BA's 16 free and 8 fixed poses; a smaller table cuts the window to
  its size, and the solve then rounds differently). Until the small table
  fills, every frame gives the same trajectory, statistics, keyframe count
  and keyframe and landmark slot contents, bit for bit.
- The same drive with ``whole_cycle``, as the ``--auto`` drivers run it: the
  frame after each insert runs the whole maintenance cycle, local BA and
  loop detection included.
- ``rebuild_observations`` keeps the observations of the last landmark
  slot, which the references it drops once overwrote.
"""
import numpy as np
import pytest
import torch

from orb_slam2_with_comment_tpu_torch import spans
from orb_slam2_with_comment_tpu_torch.mapstate.map import (
    MapConfig, covisibility_matrix, covisibility_weights, empty_map,
    rebuild_observations)
from orb_slam2_with_comment_tpu_torch.pipeline import steps
from orb_slam2_with_comment_tpu_torch.pipeline.auto import (
    AutoTracker, AutoTrackerConfig)
from orb_slam2_with_comment_tpu_torch.pipeline.tracking import TrackerConfig
from orb_slam2_with_comment_tpu_torch.place import vocabulary as V
from slambench import worlds
from slambench.reference import mapping as ref

torch.set_num_threads(2)

TABLES = ("kf_valid", "kf_lm", "kf_feat_valid", "lm_valid", "lm_obs_kf",
          "lm_obs_feat")
N_WORDS = 300


def random_map(seed: int, K: int, N: int, L: int, D: int = 12):
    """A map state filled to a fraction of its landmark slots, and its BoW
    rows [K, N] (word ids -1 padded, weights in multiples of 2^-10)."""
    rng = np.random.default_rng(seed)
    n_kf = int(rng.integers(K // 2, K + 1))
    fill = L // int(rng.integers(5, 12))
    kf_valid = np.zeros(K, bool)
    kf_valid[:n_kf] = True
    kf_valid[rng.choice(n_kf, max(1, n_kf // 6), replace=False)] = False
    feat_valid = np.zeros((K, N), bool)
    feat_valid[:n_kf] = rng.random((n_kf, N)) < 0.9
    kf_lm = np.full((K, N), -1, np.int32)
    obs_kf = np.full((L, D), -1, np.int32)
    obs_feat = np.zeros((L, D), np.int32)
    for lm in range(fill):
        kfs = rng.choice(n_kf, int(rng.integers(1, min(D, n_kf) + 1)),
                         replace=False)
        slots = rng.choice(D, len(kfs), replace=False)  # holes anywhere
        for k, d in zip(kfs, slots):
            free = np.flatnonzero(feat_valid[k] & (kf_lm[k] < 0))
            if not len(free):
                continue
            f = rng.choice(free)
            kf_lm[k, f] = lm
            obs_kf[lm, d], obs_feat[lm, d] = k, f
        # a second feature of an observing keyframe that holds the
        # landmark without being its registered observation
        if rng.random() < 0.08 and (obs_kf[lm] >= 0).any():
            k = obs_kf[lm][obs_kf[lm] >= 0][0]
            free = np.flatnonzero(feat_valid[k] & (kf_lm[k] < 0))
            if len(free):
                kf_lm[k, rng.choice(free)] = lm
    lm_valid = np.zeros(L, bool)
    lm_valid[:fill] = rng.random(fill) < 0.9
    m = empty_map(MapConfig(K, N, L, D), "cpu")
    m = m._replace(
        kf_valid=torch.as_tensor(kf_valid), kf_lm=torch.as_tensor(kf_lm),
        kf_feat_valid=torch.as_tensor(feat_valid),
        lm_valid=torch.as_tensor(lm_valid), lm_obs_kf=torch.as_tensor(obs_kf),
        lm_obs_feat=torch.as_tensor(obs_feat),
        n_kf=torch.tensor(n_kf, dtype=torch.int32),
        n_lm=torch.tensor(fill, dtype=torch.int32))
    bow_idx = np.full((K, N), -1, np.int32)
    bow_w = np.zeros((K, N), np.float32)
    for k in range(n_kf):
        n = int(rng.integers(1, min(N, 60)))
        bow_idx[k, :n] = np.sort(rng.choice(N_WORDS, n, replace=False))
        bow_w[k, :n] = rng.integers(1, 65, n) / 1024.0
    return m, torch.as_tensor(bow_idx), torch.as_tensor(bow_w)


@pytest.mark.parametrize("seed,K,N,L", [
    (0, 8, 64, 1000), (1, 16, 128, 2000), (2, 24, 96, 3000),
    (3, 32, 200, 4000), (4, 48, 160, 6000), (5, 64, 256, 8000)])
def test_table_passes_equal_the_reference(seed, K, N, L):
    m, bow_idx, bow_w = random_map(seed, K, N, L)
    t = {k: getattr(m, k) for k in TABLES}
    live = torch.nonzero(m.kf_valid)[:, 0].tolist()
    assert m.kf_valid.sum() < m.n_kf  # culled keyframes among the filled
    assert int(m.n_lm) * 4 < L and not m.lm_valid[:int(m.n_lm)].all()
    assert ((m.lm_obs_kf[:, :-1] < 0) & (m.lm_obs_kf[:, 1:] >= 0)).any()
    for kf in live:
        assert torch.equal(covisibility_weights(m, kf).long(),
                           ref.covisibility_weights(t, kf)), kf
        got = torch.nonzero(steps.local_landmark_mask(m, kf))[:, 0]
        assert torch.equal(got, ref.local_landmarks(t, kf)), kf
        s = V.score_l1_sparse(bow_idx[kf], bow_w[kf], bow_idx, bow_w,
                              N_WORDS)
        ids, score = ref.loop_candidate_scores(bow_idx, bow_w, kf)
        hits = torch.nonzero(s > 0)[:, 0]
        assert torch.equal(hits[hits != kf], ids), kf
        assert torch.equal(s[ids].double(), score), kf
    assert torch.equal(covisibility_matrix(m).long(),
                       ref.covisibility_matrix(t))
    # the registered-observation rule decides some weights: counting every
    # feature that holds a landmark would give more
    doubled = (m.kf_lm[:, :, None] == m.kf_lm[:, None, :]) & (
        m.kf_lm[:, :, None] >= 0)
    assert doubled.sum() > (m.kf_lm >= 0).sum()


# the street of slambench/traffic/long_drive.json, at a third of the
# KITTI 00-02 camera's resolution
SCALE = 416 / 1241
CAM = {"fx": 718.856 * SCALE, "fy": 718.856 * SCALE,
       "cx": 607.1928 * SCALE, "cy": 185.2157 * SCALE, "width": 416,
       "height": 126}
BF = 386.1448 * SCALE
N_FEAT, SPACING, FRAMES = 600, 0.5, 28
SMALL, LARGE = (16, 8192), (24, 16384)
MAP_STATE = ("kf_R", "kf_t", "kf_valid", "kf_frame_id", "kf_xy", "kf_ur",
             "kf_depth", "kf_octave", "kf_angle", "kf_desc", "kf_feat_valid",
             "kf_lm", "lm_pw", "lm_valid", "lm_desc", "lm_normal", "lm_dmin",
             "lm_dmax", "lm_visible", "lm_found", "lm_first_kf", "lm_ref_kf",
             "lm_obs_kf", "lm_obs_feat")


@pytest.fixture(scope="module")
def pairs():
    return _street_pairs(FRAMES)


def _street_pairs(n: int):
    street = worlds.StreetCanyon(19, range(6), n * SPACING)
    poses = street.poses(n, SPACING)
    shift = np.array([BF / CAM["fx"], 0, 0], np.float32)
    left, _ = worlds.render_frames(street.planes, poses, CAM, "cpu", False)
    right, _ = worlds.render_frames(
        street.planes, [(R, t - shift) for R, t in poses], CAM, "cpu", False)
    return left, right


def _tracker(k_max: int, l_max: int) -> AutoTracker:
    cfg = TrackerConfig(
        sensor="stereo", fx=CAM["fx"], fy=CAM["fy"], cx=CAM["cx"],
        cy=CAM["cy"], bf=BF, width=CAM["width"], height=CAM["height"],
        n_features=N_FEAT, th_depth=35.0, fps=10.0, min_init_features=150,
        map_cfg=MapConfig(k_max, N_FEAT, l_max, 12))
    return AutoTracker(cfg, AutoTrackerConfig(whole_cycle=True),
                       device="cpu")


def test_drive_is_the_same_at_two_table_sizes(pairs):
    left, right = pairs
    small, large = _tracker(*SMALL), _tracker(*LARGE)
    compared = 0
    for i in range(FRAMES):
        small.process_stereo(left[i], right[i])
        large.process_stereo(left[i], right[i])
        a, b = small.state, large.state
        assert (a.frame_idx, a.ref_kf, a.maint_kf, a.maint_phase) == (
            b.frame_idx, b.ref_kf, b.maint_kf, b.maint_phase), i
        assert a.maint_neighbors == b.maint_neighbors, i
        assert int(a.map.n_kf) == int(b.map.n_kf), i
        assert int(a.map.n_lm) == int(b.map.n_lm), i
        k, n_lm = int(a.map.n_kf), SMALL[1]
        for name in MAP_STATE:
            x, y = getattr(a.map, name), getattr(b.map, name)
            rows = k if name.startswith("kf_") else n_lm
            assert torch.equal(x[:rows], y[:rows]), (i, name)
        assert torch.equal(a.loop.bow_idx, b.loop.bow_idx[:SMALL[0]]), i
        compared += 1
        if k >= SMALL[0]:
            break  # the small table is full: its next insert is refused
    out_s, out_l = small.finalize(), large.finalize()
    n = compared
    for key in ("R", "t", "Rcr", "tcr", "ref_kf", "valid", "stats"):
        np.testing.assert_array_equal(out_s[key][:n], out_l[key][:n],
                                      err_msg=key)
    assert compared >= 8 and out_s["valid"][:n].all()
    assert int(small.state.map.n_kf) == SMALL[0]  # the small table filled
    assert out_s["stats"][:n, 6].sum() >= SMALL[0] - 1  # inserts compared


def test_whole_cycle_runs_after_each_insert(pairs):
    left, right = pairs
    tr = _tracker(8, 8192)
    spans.enable()
    try:
        for i in range(5):
            tr.process_stereo(left[i], right[i])
        recs = list(spans.FRAMES)
    finally:
        spans.disable()
        spans.FRAMES.clear()
    cycle = ["ph_fuse_in", "ph_fuse_out", "ph_merge", "ph_refresh_cull",
             "ph_ba1", "ph_ba2", "ph_loop"]
    inserts = tr.finalize()["stats"][:5, 6]
    after = [i + 1 for i in range(4)
             if inserts[i] == 1 and inserts[i + 1] == 0]
    assert len(after) >= 2
    for i in after:
        names = [sp.name for sp in recs[i].spans if sp.name in cycle]
        assert names == cycle, i
    assert tr.state.maint_kf == -1 or inserts[4] == 1


def test_rebuild_keeps_the_last_landmark_slot():
    m, _, _ = random_map(7, 8, 64, 1000)
    L = m.lm_pw.shape[0]
    k, f = 0, int(torch.nonzero(m.kf_feat_valid[0] & (m.kf_lm[0] < 0))[0])
    m = m._replace(kf_valid=m.kf_valid.clone().fill_(True),
                   kf_lm=m.kf_lm.clone(), lm_valid=m.lm_valid.clone())
    m.kf_lm[k, f] = L - 1
    m.lm_valid[L - 1] = True
    got = rebuild_observations(m)
    assert got.lm_obs_kf[L - 1].tolist() == [k] + [-1] * 11
    assert got.lm_obs_feat[L - 1, 0] == f
    # every other row as the back-references give it
    again = rebuild_observations(got)
    assert torch.equal(again.lm_obs_kf, got.lm_obs_kf)
