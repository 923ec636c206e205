"""Loop closing of the PyTorch port against the JAX package, on the CPU.

The JAX package builds the controlled loop of tests/test_auto_loop.py at a
reduced size (320x240, 500 features, MapConfig(20, 500, 5000, 8)): a
14-keyframe lap plus one revisit keyframe, the map told drifted poses for
keyframes 8-13, keyframe_step then close_loop_step per keyframe. It closes
its loop at keyframe 14. On its snapshots:

- the map and loop tables (covisibility_matrix, compact_landmarks,
  compact_keyframes, permute_loop_carry) are exact;
- detect gives the same candidate, groups and counts at every keyframe;
- search_by_sim3 and search_by_scw_projection, given the JAX package's
  Sim3, give the same integer outputs;
- close_loop_step at keyframe 14 passes the same gates (a loop closes)
  and its corrected map agrees: keyframe poses within 5e-4 (measured
  7.1e-05 m and 2.9e-05 on R), landmark tables exact, landmark positions
  within 1e-2 (measured 1.3e-03 m). The Sim3 RANSAC draws from another
  generator, and the refinement, pose graph and global BA run in float32
  in another order.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_with_comment_tpu.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu.frontend import OrbExtractor as JaxExtractor
from orb_slam2_with_comment_tpu.mapstate import map as jmap
from orb_slam2_with_comment_tpu.matching import search as jsearch
from orb_slam2_with_comment_tpu.pipeline import TrackerConfig as JaxConfig
from orb_slam2_with_comment_tpu.pipeline import auto_loop as jloop
from orb_slam2_with_comment_tpu.pipeline import steps as jsteps
from orb_slam2_with_comment_tpu.place.vocabulary import (
    load_default_vocabulary as jax_vocabulary)
from orb_slam2_with_comment_tpu_torch import convert
from orb_slam2_with_comment_tpu_torch.mapstate import map as tmap
from orb_slam2_with_comment_tpu_torch.matching import search as tsearch
from orb_slam2_with_comment_tpu_torch.pipeline import auto_loop as tloop
from orb_slam2_with_comment_tpu_torch.pipeline.tracking import TrackerConfig
from orb_slam2_with_comment_tpu_torch.place import vocabulary as V

torch.set_num_threads(2)

CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
KW = dict(CAM, bf=20.0, n_features=500, min_init_features=100, fps=30,
          depth_factor=1.0)
MAP = (20, 500, 5000, 8)
DRIFT_STEP = np.array([0.015, 0.0, 0.008], np.float32)
N_KF = 15
FIRE = 14


def _cfg():
    return TrackerConfig(map_cfg=tmap.MapConfig(*MAP), **KW)


@pytest.fixture(scope="module")
def jax_run():
    """JAX snapshots (map, loop) before each close_loop_step, the state
    after the last one, and the ground-truth poses."""
    cfg = JaxConfig(map_cfg=jmap.MapConfig(*MAP), **KW)
    world = SyntheticWorld(seed=1)
    lap = orbit_trajectory(n_frames=14)
    poses = (lap + lap[:4])[:N_KF]
    ext = JaxExtractor(n_features=500)
    voc = jax_vocabulary(as_numpy=True)
    cam = cfg.cam
    m = jmap.empty_map(cfg.map_cfg)
    loop = jloop.empty_loop_carry(MAP[0], 500)
    step = jax.jit(lambda lp, mm, kk: jloop.close_loop_step(
        lp, mm, cam, kk, voc, fix_scale=True, width=320, height=240))
    drift = np.zeros(3, np.float32)
    snaps = []
    for k, (R, t) in enumerate(poses):
        img, depth = world.render(R, t, **CAM)
        feats, d = jsteps.extract_rgbd_features(
            ext, cam, jnp.asarray(np.clip(img, 0, 255).astype(np.float32)),
            jnp.asarray(depth), jnp.float32(1.0), 320, 240)
        if 8 <= k < 14:
            drift = drift + DRIFT_STEP
        m = jsteps.keyframe_step(
            m, cam, jsteps.FrameObs(feats, d, jnp.full(500, -1, jnp.int32)),
            jnp.asarray(R), jnp.asarray(t + drift), jnp.int32(k),
            jnp.float32(cfg.depth_threshold), 320, 240)
        snaps.append(jax.device_get((m, loop)))
        m, loop = step(loop, m, jnp.int32(k))
    return snaps, jax.device_get((m, loop)), poses, voc, cam


@pytest.fixture(scope="module")
def voc():
    return V.load_default_vocabulary("cpu")


def test_jax_closes_the_loop_at_the_revisit(jax_run):
    snaps, (m, loop), poses, _, _ = jax_run
    assert int(snaps[FIRE][1].n_loops) == 0 and int(loop.n_loops) == 1


def test_covisibility_matrix_exact(jax_run):
    snaps, _, _, _, _ = jax_run
    jm = snaps[FIRE][0]
    got = tmap.covisibility_matrix(convert.map_from_numpy(jm, "cpu"))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jmap.covisibility_matrix(jm)))
    assert got.sum() > 0


def _thinned(jm):
    """The snapshot map with keyframes 3 and 7 and every 5th landmark
    marked dead, as culling leaves it."""
    kv = np.asarray(jm.kf_valid).copy()
    kv[[3, 7]] = False
    lv = np.asarray(jm.lm_valid).copy()
    lv[::5] = False
    return jm._replace(kf_valid=kv, lm_valid=lv)


def _assert_maps_equal(got, want):
    for f, a in convert.map_to_numpy(got).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_compact_landmarks_exact(jax_run):
    jm = _thinned(jax_run[0][FIRE][0])
    got = tmap.compact_landmarks(convert.map_from_numpy(jm, "cpu"))
    _assert_maps_equal(got, jax.device_get(jmap.compact_landmarks(jm)))
    np.testing.assert_array_equal(
        tmap.landmark_compaction_order(torch.as_tensor(jm.lm_valid)).numpy(),
        np.asarray(jmap.landmark_compaction_order(jm.lm_valid)))


def test_compact_keyframes_exact(jax_run):
    jm = _thinned(jax_run[0][FIRE][0])
    got = tmap.compact_keyframes(convert.map_from_numpy(jm, "cpu"))
    want = jax.device_get(jmap.compact_keyframes(jm))
    _assert_maps_equal(got, want)
    assert int(want.n_kf) == N_KF - 2


@pytest.mark.parametrize("culled", [False, True])
def test_permute_loop_carry_exact(jax_run, culled):
    _, (_, jl), _, _, _ = jax_run
    valid = np.zeros(MAP[0], bool)
    valid[:N_KF] = True
    valid[[3, 7]] = False
    if culled:
        valid[FIRE] = False  # the last loop keyframe is culled
    order = np.argsort(~valid, kind="stable").astype(np.int32)
    rank = (np.cumsum(valid) - valid).astype(np.int32)
    want = jax.device_get(jloop.permute_loop_carry(
        jl, jnp.asarray(order), jnp.asarray(rank), jnp.asarray(valid)))
    got = tloop.permute_loop_carry(
        convert.loop_from_numpy(jl, "cpu"), torch.as_tensor(order).long(),
        torch.as_tensor(rank), torch.as_tensor(valid))
    for f, a in convert.loop_to_numpy(got).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.last_loop_kf == (-tloop.MIN_GAP if culled else FIRE - 2)


def test_detect_exact_at_every_keyframe(jax_run, voc):
    snaps, _, _, jvoc, _ = jax_run
    cands = []
    for k, (jm, jl) in enumerate(snaps):
        jl = jax.tree_util.tree_map(jnp.asarray, jl)
        jl = jloop.add_keyframe_bow(jl, jvoc, jnp.int32(k), jm.kf_desc[k],
                                    jm.kf_feat_valid[k])
        jc, jl2 = jloop.detect(jl, jm, jnp.int32(k), int(jvoc.n_words))
        m = convert.map_from_numpy(jm, "cpu")
        loop = convert.loop_from_numpy(jax.device_get(jl), "cpu")
        c, loop2 = tloop.detect(loop, m, k, voc.n_words)
        assert c == int(jc), k
        np.testing.assert_array_equal(loop2.prev_groups.numpy(),
                                      np.asarray(jl2.prev_groups))
        np.testing.assert_array_equal(loop2.prev_counts.numpy(),
                                      np.asarray(jl2.prev_counts))
        cands.append(c)
    assert cands[FIRE] >= 0 and max(cands[:10]) == -1


def test_sim3_searches_exact(jax_run):
    """Both Sim3 search modes, given the JAX package's own RANSAC Sim3
    between keyframe 14 and its loop candidate."""
    snaps, _, _, jvoc, cam = jax_run
    jm, jl = snaps[FIRE]
    jl = jloop.add_keyframe_bow(jax.tree_util.tree_map(jnp.asarray, jl), jvoc, jnp.int32(FIRE), jm.kf_desc[FIRE],
                                jm.kf_feat_valid[FIRE])
    cand = int(jloop.detect(jl, jm, jnp.int32(FIRE), int(jvoc.n_words))[0])
    sm = jloop._sim3_solve(jl, jm, cam, jnp.int32(FIRE), jnp.int32(cand),
                           True)
    R12, t12, s12 = (np.asarray(a) for a in sm[1:4])
    m = convert.map_from_numpy(jm, "cpu")
    tcam = _cfg().cam
    lm1, _ = tloop._kf_landmark_set(m, FIRE)
    lm2, _ = tloop._kf_landmark_set(m, cand)
    jlm1, _ = jloop._kf_landmark_set(jm, FIRE)
    jlm2, _ = jloop._kf_landmark_set(jm, cand)

    def feats(mm, k, mod):
        return mod.FeatureSet(mm.kf_xy[k], mm.kf_ur[k], mm.kf_octave[k],
                              mm.kf_angle[k], mm.kf_desc[k],
                              mm.kf_feat_valid[k])

    pose = (FIRE, cand)
    idx, mutual = tsearch.search_by_sim3(
        tcam, torch.as_tensor(R12), torch.as_tensor(t12),
        torch.as_tensor(s12), *(a for k in pose for a in (m.kf_R[k],
                                                          m.kf_t[k])),
        lm1, lm2, feats(m, FIRE, tsearch), feats(m, cand, tsearch))
    jidx, jmutual = jsearch.search_by_sim3(
        cam, R12, t12, s12, *(a for k in pose for a in (jm.kf_R[k],
                                                       jm.kf_t[k])),
        jlm1, jlm2, feats(jm, FIRE, jsearch), feats(jm, cand, jsearch),
        None, None)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(mutual.numpy(), np.asarray(jmutual))
    assert int(mutual.sum()) >= 20

    already = np.asarray(sm[8])
    K = MAP[0]
    w_cand = np.asarray(jmap.covisibility_weights(jm, cand))
    loop_gm = (w_cand > 0) | (np.arange(K) == cand)
    obs = np.asarray(jm.lm_obs_kf)
    sel = np.nonzero((loop_gm[np.clip(obs, 0, None)] & (obs >= 0)).any(1)
                     & np.asarray(jm.lm_valid))[0]
    Rcw, tcw, scw = (np.asarray(a) for a in jloop.sim3.compose(
        R12, t12, s12, jm.kf_R[cand], jm.kf_t[cand], jnp.ones(())))
    jlms = jsearch.LandmarkSet(*(np.asarray(getattr(jm, f))[sel] for f in (
        "lm_pw", "lm_normal", "lm_dmin", "lm_dmax", "lm_desc")),
        np.ones(len(sel), bool))
    jidx, jok = jsearch.search_by_scw_projection(
        cam, Rcw, tcw, scw, jlms, feats(jm, FIRE, jsearch), already, 320,
        240)
    tlms = tsearch.LandmarkSet(*(getattr(m, f)[torch.as_tensor(sel)] for f in (
        "lm_pw", "lm_normal", "lm_dmin", "lm_dmax", "lm_desc")),
        torch.ones(len(sel), dtype=torch.bool))
    idx, ok = tsearch.search_by_scw_projection(
        tcam, torch.as_tensor(Rcw), torch.as_tensor(tcw),
        torch.as_tensor(scw), tlms, feats(m, FIRE, tsearch),
        torch.as_tensor(already), 320, 240)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert int(ok.sum()) > 0


def test_close_loop_step_matches_jax(jax_run, voc):
    snaps, (jm2, jl2), poses, _, _ = jax_run
    jm, jl = snaps[FIRE]
    m, loop = tloop.close_loop_step(
        convert.loop_from_numpy(jl, "cpu"), convert.map_from_numpy(jm, "cpu"),
        _cfg().cam, FIRE, voc, fix_scale=True, width=320, height=240)
    assert loop.n_loops == int(jl2.n_loops) == 1
    assert loop.last_loop_kf == int(jl2.last_loop_kf) == FIRE
    np.testing.assert_array_equal(loop.loop_edges.numpy(),
                                  np.asarray(jl2.loop_edges))
    got = convert.map_to_numpy(m)
    for f in ("kf_valid", "kf_lm", "lm_valid", "lm_obs_kf", "lm_obs_feat",
              "n_lm", "n_kf"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jm2, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got["kf_t"], np.asarray(jm2.kf_t), atol=5e-4)
    np.testing.assert_allclose(got["kf_R"], np.asarray(jm2.kf_R), atol=5e-4)
    live = np.asarray(jm2.lm_valid)
    np.testing.assert_allclose(got["lm_pw"][live],
                               np.asarray(jm2.lm_pw)[live], atol=1e-2)
    err_before = np.linalg.norm(np.asarray(jm.kf_t[FIRE]) - poses[FIRE][1])
    err_after = np.linalg.norm(got["kf_t"][FIRE] - poses[FIRE][1])
    assert err_before > 0.05 and err_after < 0.35 * err_before
