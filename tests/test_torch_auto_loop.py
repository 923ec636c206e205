"""The default RGB-D tracker of the PyTorch port (loop closing and
relocalization on) against the JAX package's AutoTracker, on the CPU, at a
reduced size: 320x240, 500 features, MapConfig(k_max=8, n_feat=500,
l_max=1500, d_max=8), a 48-frame orbit, 3 black frames, then frames 2-4
again. The small landmark capacity makes both trackers recycle landmark
slots once (landmark compaction before an insert).

- Whole run: the keyframe-insertion frames, the relocalization frame, the
  valid flags, the loss, n_loops and the compaction counts are identical
  (taken from the JAX run). The per-frame statistics are identical except
  on the relocalization frame, whose inlier counts follow the RANSAC
  draws (another generator). Every frame's translation agrees within
  1e-3 m and rotation within 1e-3 rad (measured: 4.5e-05 m, and 1.2e-06
  m on the relocalization frame).
- The loop tables after the run: BoW word ids, groups and counts exact,
  BoW weights within 1e-6 (measured: 9.3e-10).
- One step from a shared state across the landmark compaction: the JAX
  state before that frame is converted with convert.py, both take the
  same frame, and every integer table and counter after it is identical,
  the keyframe poses within 1e-4.
- One step across a keyframe compaction, from the JAX state before the
  run's last insert with one keyframe culled and the keyframe slots cut to
  those in use (no run this short culls a keyframe by itself): the same
  tables and counters, the loop tables and every remapped slot id
  identical, the keyframe poses within 1e-4.
"""
import numpy as np
import jax
import pytest
import torch

from orb_slam2_with_comment_tpu.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu.mapstate.map import MapConfig as JaxMapConfig
from orb_slam2_with_comment_tpu.pipeline import (
    AutoTracker as JaxAutoTracker, TrackerConfig as JaxTrackerConfig)
from orb_slam2_with_comment_tpu_torch import convert
from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig
from orb_slam2_with_comment_tpu_torch.pipeline.auto import AutoTracker
from orb_slam2_with_comment_tpu_torch.pipeline.tracking import TrackerConfig

torch.set_num_threads(2)

N_BUILD = 48
CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
KW = dict(CAM, bf=20.0, n_features=500, min_init_features=100, fps=30,
          depth_factor=1.0 / 5000.0)
MAP = dict(k_max=8, n_feat=500, l_max=1500, d_max=8)
INT_TABLES = ("kf_valid", "kf_frame_id", "kf_octave", "kf_desc",
              "kf_feat_valid", "kf_lm", "lm_valid", "lm_desc", "lm_visible",
              "lm_found", "lm_first_kf", "lm_ref_kf", "lm_obs_kf",
              "lm_obs_feat", "n_kf", "n_lm", "n_obs_drop")


def _sequence():
    world = SyntheticWorld(seed=1)
    poses = orbit_trajectory(N_BUILD)
    frames = []
    for R, t in poses:
        img, depth = world.render(R, t, **CAM)
        frames.append((np.clip(img, 0, 255).astype(np.uint8),
                       np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)))
    black = (np.zeros((240, 320), np.uint8), np.zeros((240, 320), np.uint16))
    return (frames + [black] * 3 + frames[2:5],
            poses + [None] * 3 + poses[2:5])


@pytest.fixture(scope="module")
def runs():
    frames, poses = _sequence()
    jt = JaxAutoTracker(JaxTrackerConfig(map_cfg=JaxMapConfig(**MAP), **KW))
    snaps = []  # JAX state before each frame, then after the last
    for img, depth in frames:
        snaps.append(jax.device_get(jt.state))
        jt.process_rgbd(img, depth)
    snaps.append(jax.device_get(jt.state))
    tt = AutoTracker(TrackerConfig(map_cfg=MapConfig(**MAP), **KW),
                     device="cpu")
    for img, depth in frames:
        tt.process_rgbd(img, depth)
    return frames, poses, snaps, jt.finalize(), tt


def test_whole_run_matches_jax(runs):
    _, poses, snaps, jout, tt = runs
    tout = tt.finalize()
    np.testing.assert_array_equal(tout["valid"], jout["valid"])
    np.testing.assert_array_equal(tout["stats"][:, 6], jout["stats"][:, 6])
    ins = np.nonzero(jout["stats"][:, 6] == 1)[0]
    assert len(ins) >= 6 and ins[-1] > N_BUILD  # an insert after recovery
    for k in ("lost_at", "n_keyframes", "n_loops_closed", "n_compact_lm",
              "n_compact_kf"):
        assert tout[k] == jout[k], k
    assert tout["n_compact_lm"] == 1 and tout["lost_at"] == -1
    same = jout["stats"][:, 6] != 2
    np.testing.assert_array_equal(tout["stats"][same], jout["stats"][same])
    np.testing.assert_allclose(tout["t"], jout["t"], rtol=0, atol=1e-3)
    for Rt, Rj in zip(tout["R"], jout["R"]):
        cos = (np.trace(Rt @ Rj.T) - 1) / 2
        assert np.arccos(np.clip(cos, -1, 1)) < 1e-3


def test_kidnap_relocalizes_like_jax(runs):
    _, poses, _, jout, tt = runs
    tout = tt.finalize()
    r = N_BUILD + 3
    assert not tout["valid"][N_BUILD:r].any()
    assert tout["stats"][r, 6] == jout["stats"][r, 6] == 2
    assert tout["valid"][r:].all()
    np.testing.assert_allclose(tout["t"][r], jout["t"][r], atol=1e-3)
    assert np.linalg.norm(tout["t"][r] - poses[r][1]) < 0.05


def test_loop_tables_match_jax(runs):
    _, _, snaps, _, tt = runs
    got = convert.loop_to_numpy(tt.state.loop)
    want = snaps[-1].loop
    for f in ("bow_idx", "prev_groups", "prev_counts", "loop_edges",
              "last_loop_kf", "n_loops"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got["bow_w"], want.bow_w, rtol=0, atol=1e-6)
    assert (got["bow_idx"][:int(snaps[-1].map.n_kf), 0] >= 0).all()


def test_step_across_landmark_compaction(runs):
    frames, _, snaps, _, _ = runs
    k = next(i for i in range(len(frames))
             if int(snaps[i + 1].n_compact_lm) > int(snaps[i].n_compact_lm))
    tt = AutoTracker(TrackerConfig(map_cfg=MapConfig(**MAP), **KW),
                     device="cpu")
    tt.state = convert.auto_state_from_numpy(snaps[k], "cpu")
    tt.frame_count = k
    tt.process_rgbd(*frames[k])
    got = convert.auto_state_to_numpy(tt.state)
    want = snaps[k + 1]
    assert want.traj_stats[k, 6] == 1  # the compaction made room for an insert
    for f in ("n_compact_lm", "n_compact_kf", "ref_kf", "maint_kf",
              "maint_phase", "frame_idx"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got["prev"]["lm"], want.prev.lm)
    for f in INT_TABLES:
        np.testing.assert_array_equal(got["map"][f],
                                      np.asarray(getattr(want.map, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got["loop"]["bow_idx"], want.loop.bow_idx)
    for f in ("kf_R", "kf_t"):
        np.testing.assert_allclose(got["map"][f],
                                   np.asarray(getattr(want.map, f)),
                                   rtol=0, atol=1e-4, err_msg=f)


def _cut_and_cull(snap, k_max: int, culled: int):
    """The JAX state ``snap`` with its keyframe tables cut to ``k_max``
    slots and slot ``culled`` culled as cull_keyframes leaves it: dead,
    its observations cleared and the observation rows repacked."""
    from orb_slam2_with_comment_tpu.pipeline.steps import repack_obs_rows
    m = snap.map._replace(**{f: np.asarray(getattr(snap.map, f))[:k_max]
                             for f in snap.map._fields if f.startswith("kf_")})
    kf_valid = m.kf_valid.copy()
    kf_valid[culled] = False
    obs = np.where(m.lm_obs_kf == culled, -1, m.lm_obs_kf)
    m = jax.device_get(repack_obs_rows(m._replace(kf_valid=kf_valid,
                                                  lm_obs_kf=obs)))
    lp = snap.loop
    loop = lp._replace(bow_idx=lp.bow_idx[:k_max], bow_w=lp.bow_w[:k_max],
                       prev_groups=lp.prev_groups[:, :k_max],
                       loop_edges=lp.loop_edges[:k_max, :k_max])
    return snap._replace(map=m, loop=loop)


def test_step_across_keyframe_compaction(runs):
    """One step from a shared state across a keyframe compaction: the JAX
    state before the last insert of the run, cut to as many keyframe slots
    as it uses, with one keyframe culled, so the insert must compact. The
    slot remaps of the map, the loop tables, the reference and maintained
    keyframes, the maintenance window and the trajectory's reference rows
    are identical, the keyframe poses within 1e-4."""
    frames, _, snaps, _, _ = runs
    k = max(i for i in range(len(frames))
            if snaps[i + 1].traj_stats[i, 6] == 1 and int(snaps[i].lost) < 0)
    n_kf, ref = int(snaps[k].map.n_kf), int(snaps[k].ref_kf)
    # cull the keyframe sharing the fewest landmarks with the reference
    # keyframe, so the tracking statistics still ask for the insert
    obs = np.asarray(snaps[k].map.lm_obs_kf)
    shared = {c: int(((obs == c).any(1) & (obs == ref).any(1)).sum())
              for c in range(1, n_kf) if c != ref}
    culled = min(shared, key=shared.get)
    state = _cut_and_cull(snaps[k], n_kf, culled)
    map_cfg = dict(MAP, k_max=n_kf)
    jt = JaxAutoTracker(JaxTrackerConfig(map_cfg=JaxMapConfig(**map_cfg),
                                         **KW))
    jt.state = jax.tree_util.tree_map(jax.numpy.asarray, state)
    jt.process_rgbd(*frames[k])
    want = jax.device_get(jt.state)
    tt = AutoTracker(TrackerConfig(map_cfg=MapConfig(**map_cfg), **KW),
                     device="cpu")
    tt.state = convert.auto_state_from_numpy(state, "cpu")
    tt.frame_count = k
    tt.process_rgbd(*frames[k])
    got = convert.auto_state_to_numpy(tt.state)
    assert int(want.n_compact_kf) == int(snaps[k].n_compact_kf) + 1
    assert want.traj_stats[k, 6] == 1  # the compaction made room
    for f in ("n_compact_lm", "n_compact_kf", "ref_kf", "maint_kf",
              "maint_phase", "maint_neighbors", "traj_ref", "traj_stats",
              "traj_valid"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got["prev"]["lm"], want.prev.lm)
    # this frame's descriptors differ in one BRIEF bit of one octave-4
    # feature: the IC angles of levels >= 1 differ by float32 ulps
    # (ROADMAP.md, Queue 3); that feature's keyframe and landmark
    # descriptors are left out of the exact comparison
    bad = np.nonzero((got["prev"]["feats"]["desc"]
                      != want.prev.feats.desc).any(1))[0]
    assert len(bad) <= 1
    new = int(want.ref_kf)  # the inserted keyframe
    keep = {"kf_desc": np.ones(want.map.kf_desc.shape[:2], bool),
            "lm_desc": np.ones(want.map.lm_desc.shape[0], bool)}
    keep["kf_desc"][new, bad] = False
    lm_bad = want.map.kf_lm[new, bad]
    keep["lm_desc"][lm_bad[lm_bad >= 0]] = False
    for f in INT_TABLES:
        a, b = got["map"][f], np.asarray(getattr(want.map, f))
        if f in keep:
            a, b = a[keep[f]], b[keep[f]]
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("bow_idx", "prev_groups", "prev_counts", "loop_edges",
              "last_loop_kf", "n_loops"):
        np.testing.assert_array_equal(got["loop"][f],
                                      np.asarray(getattr(want.loop, f)),
                                      err_msg=f)
    for f in ("kf_R", "kf_t"):
        np.testing.assert_allclose(got["map"][f],
                                   np.asarray(getattr(want.map, f)),
                                   rtol=0, atol=1e-4, err_msg=f)
