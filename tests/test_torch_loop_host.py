"""The host loop closer (LoopCloser, KeyFrameDatabase) of the PyTorch
port against the JAX package's, on the CPU, at a reduced size of
tests/test_loop_host.py's controlled loop: 320x240, 500 features,
MapConfig(20, 500, 5000, 8), the 14-frame lap plus 4 frames, drift in the
poses the map is told for keyframes 8-13, min_gap=1.

The JAX package builds the map with keyframe_step and runs
KeyFrameDatabase.add and LoopCloser.process per keyframe; the port takes
the JAX map before each keyframe's process (converted) and runs its own
database and closer beside it, its Sim3 RANSAC fed the JAX closer's own
3-point sets (the PRNGKey(7) split chain). Tolerances:

- the loop candidates and the relocalization candidates at every
  keyframe: identical lists; the BoW scores within 1e-6 (measured 4.2e-7);
- compute_sim3 at every call: the same acceptance, the transform within
  1e-4 (measured 9.0e-7) and the supporting pairs identical;
- the corrected map after each closed loop: keyframe poses within 1e-4 m
  and 1e-4 in rotation entries (measured 8.2e-5 and 3.3e-5: the pose graph
  and the global BA in float32 in another order), landmark tables exact;
- the chunked global BA: ceil(10 / 2) polls, a second start mid-run bumps
  the generation and restarts the count, remap_slots aborts it, and
  _apply_gba on a map with a keyframe inserted during the run agrees with
  the JAX package's within 1e-4 on poses (measured 8.9e-7) and 1e-3 m on
  landmarks (measured 1.0e-5).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jax_draws import jax_samples, key_chain
from orb_slam2_with_comment_tpu.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu.frontend import OrbExtractor as JaxExtractor
from orb_slam2_with_comment_tpu.mapstate import map as jmap
from orb_slam2_with_comment_tpu.pipeline import TrackerConfig as JaxConfig
from orb_slam2_with_comment_tpu.pipeline import steps as jsteps
from orb_slam2_with_comment_tpu.pipeline.loop_closing import (
    LoopCloser as JaxLoopCloser)
from orb_slam2_with_comment_tpu.place.database import (
    KeyFrameDatabase as JaxDatabase)
from orb_slam2_with_comment_tpu.place.vocabulary import (
    load_default_vocabulary as jax_vocabulary)
from orb_slam2_with_comment_tpu_torch import convert
from orb_slam2_with_comment_tpu_torch.pipeline.loop_closing import LoopCloser
from orb_slam2_with_comment_tpu_torch.pipeline.tracking import TrackerConfig
from orb_slam2_with_comment_tpu_torch.place import vocabulary as V
from orb_slam2_with_comment_tpu_torch.place.database import KeyFrameDatabase

torch.set_num_threads(2)

CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
KW = dict(CAM, bf=20.0, n_features=500, min_init_features=100, fps=30,
          depth_factor=1.0)
MAP = (20, 500, 5000, 8)
DRIFT_STEP = np.array([0.015, 0.0, 0.008], np.float32)
INT_TABLES = ("kf_valid", "kf_lm", "lm_valid", "lm_obs_kf", "lm_obs_feat",
              "n_kf", "n_lm")


def _t(a):
    return torch.tensor(np.asarray(a))


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def lockstep():
    """Both closers, keyframe by keyframe, on the JAX package's maps.
    Returns per keyframe: (map before process, JAX loop candidates, port
    loop candidates, JAX and port reloc candidates, scores of both, the
    maps after process of both), the compute_sim3 results of both, and
    the closers."""
    cfg = JaxConfig(map_cfg=jmap.MapConfig(*MAP), **KW)
    cam, tcam = cfg.cam, TrackerConfig(**KW).cam
    world = SyntheticWorld(seed=1)
    lap = orbit_trajectory(n_frames=14)
    ext = JaxExtractor(n_features=500)
    jdb = JaxDatabase(jax_vocabulary(as_numpy=True), MAP[0])
    tdb = KeyFrameDatabase(V.load_default_vocabulary("cpu"), MAP[0])
    jcl = JaxLoopCloser(cam, jdb, fix_scale=True, min_gap=1, width=320,
                        height=240)
    tcl = LoopCloser(tcam, tdb, fix_scale=True, min_gap=1, width=320,
                     height=240)
    sims = {"jax": [], "port": []}
    for name, cl in (("jax", jcl), ("port", tcl)):
        fn = cl.compute_sim3
        cl.compute_sim3 = (lambda fn, out: lambda m, k, c: out.append(
            (k, c, fn(m, k, c))) or out[-1][2])(fn, sims[name])
    m = jmap.empty_map(cfg.map_cfg)
    drift = np.zeros(3, np.float32)
    rows = []
    chain = key_chain(7)
    with jax_samples(triplet_keys=chain):
        for k, (R, t) in enumerate(lap + lap[:4]):
            img, depth = world.render(R, t, **CAM)
            feats, d = jsteps.extract_rgbd_features(
                ext, cam, jnp.asarray(np.clip(img, 0, 255).astype(
                    np.float32)), jnp.asarray(depth), jnp.float32(1.0), 320,
                240)
            if 8 <= k < 14:
                drift = drift + DRIFT_STEP
            m = jsteps.keyframe_step(
                m, cam, jsteps.FrameObs(feats, d, jnp.full(500, -1,
                                                           jnp.int32)),
                jnp.asarray(R), jnp.asarray(t + drift), jnp.int32(k),
                jnp.float32(cfg.depth_threshold), 320, 240)
            before = jax.device_get(m)
            tm = convert.map_from_numpy(before, "cpu")
            jdb.add(k, feats.desc, feats.valid)
            tdb.add(k, _t(np.asarray(feats.desc).view(np.int32)),
                    _t(feats.valid))
            row = dict(k=k, before=before)
            row["cand"] = (jdb.detect_loop_candidates(m, k, 0.0),
                           tdb.detect_loop_candidates(tm, k, 0.0))
            q = (feats.desc, feats.valid)
            row["reloc"] = (jdb.detect_reloc_candidates(m, *q),
                            tdb.detect_reloc_candidates(
                                tm, _t(np.asarray(q[0]).view(np.int32)),
                                _t(q[1])))
            row["scores"] = (
                np.asarray(jdb.scores((jdb.bow_idx[k], jdb.bow_w[k]),
                                      m.kf_valid)),
                tdb.scores((tdb.bow_idx[k], tdb.bow_w[k]),
                           tm.kf_valid).numpy())
            n_before = jcl.n_loops_closed
            m = jcl.process(m, k)
            tm = tcl.process(tm, k)
            row["closed"] = (jcl.n_loops_closed - n_before,
                             tcl.n_loops_closed - n_before)
            row["after"] = (jax.device_get(m), convert.map_to_numpy(tm))
            rows.append(row)
    return rows, sims, jcl, tcl


def test_candidate_lists_identical(lockstep):
    rows = lockstep[0]
    assert sum(len(r["cand"][0]) for r in rows) > 0
    for r in rows:
        assert r["cand"][1] == r["cand"][0], r["k"]
        assert r["reloc"][1] == r["reloc"][0], r["k"]
        np.testing.assert_allclose(r["scores"][1], r["scores"][0], atol=1e-6)


def test_compute_sim3_accepts_the_same_way(lockstep):
    _, sims, _, _ = lockstep
    assert len(sims["port"]) == len(sims["jax"]) >= 1
    n_ok = 0
    for (jk, jc, js), (tk, tc, ts) in zip(sims["jax"], sims["port"]):
        assert (tk, tc) == (jk, jc)
        assert (ts is None) == (js is None), (jk, jc)
        if js is None:
            continue
        n_ok += 1
        for a, b in ((ts.R, js.R), (ts.t, js.t)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
        assert abs(float(ts.s) - float(js.s)) < 1e-4
        np.testing.assert_array_equal(ts.lm_cur.numpy(),
                                      np.asarray(js.lm_cur))
        np.testing.assert_array_equal(ts.lm_cand.numpy(),
                                      np.asarray(js.lm_cand))
    assert n_ok >= 1


def test_corrected_maps_agree(lockstep):
    rows, _, jcl, tcl = lockstep
    fired = [r for r in rows if r["closed"][0]]
    assert fired and all(r["closed"][1] == r["closed"][0] for r in rows)
    assert tcl.loop_edges == jcl.loop_edges
    assert tcl.last_loop_kf == jcl.last_loop_kf
    for r in fired:
        want, got = r["after"]
        for f in INT_TABLES:
            np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                          err_msg=f)
        np.testing.assert_allclose(got["kf_t"], np.asarray(want.kf_t),
                                   atol=1e-4)
        np.testing.assert_allclose(got["kf_R"], np.asarray(want.kf_R),
                                   atol=1e-4)


def _closers(voc_rows=20):
    cam, tcam = JaxConfig(**KW).cam, TrackerConfig(**KW).cam
    jcl = JaxLoopCloser(cam, JaxDatabase(jax_vocabulary(as_numpy=True),
                                         voc_rows), width=320, height=240)
    tcl = LoopCloser(tcam, KeyFrameDatabase(V.load_default_vocabulary("cpu"),
                                            voc_rows), width=320, height=240)
    return jcl, tcl


def test_chunked_gba_polls_and_aborts(lockstep):
    rows = lockstep[0]
    tm = convert.map_from_numpy(rows[8]["before"], "cpu")
    _, tcl = _closers()
    tcl._start_gba(tm)
    polls, out = 0, None
    while out is None and polls < 20:
        out = tcl.poll_gba(tm)
        polls += 1
    assert polls == -(-tcl.gba_total_iters // tcl.gba_chunk_iters) == 5
    assert not tcl.gba_running() and torch.isfinite(out.kf_t).all()
    tcl._start_gba(tm)
    gen = tcl.gba_generation
    tcl.poll_gba(tm)
    tcl._start_gba(tm)  # a newer loop
    assert tcl.gba_generation == gen + 1
    assert tcl._gba["left"] == tcl.gba_total_iters
    valid = tm.kf_valid.numpy()
    tcl.remap_slots(np.arange(MAP[0]), valid)  # a compaction
    assert not tcl.gba_running()


def test_apply_gba_with_a_keyframe_inserted_during_the_run(lockstep):
    """The GBA starts on the map of keyframes 0-8 (its snapshot); the map
    of keyframes 0-9 is what it reconciles with at its last poll."""
    rows = lockstep[0]
    m8, m9 = rows[8]["before"], rows[9]["before"]
    jcl, tcl = _closers()
    jcl._start_gba(_jax(m8))
    tcl._start_gba(convert.map_from_numpy(m8, "cpu"))
    assert jcl._gba["n_kf"] == tcl._gba["n_kf"] == 9
    jout = tout = None
    for _ in range(5):
        jout = jcl.poll_gba(_jax(m9))
        tout = tcl.poll_gba(convert.map_from_numpy(m9, "cpu"))
    assert jout is not None and tout is not None
    np.testing.assert_allclose(tout.kf_t.numpy(), np.asarray(jout.kf_t),
                               atol=1e-4)
    np.testing.assert_allclose(tout.kf_R.numpy(), np.asarray(jout.kf_R),
                               atol=1e-4)
    live = np.asarray(m9.lm_valid)
    np.testing.assert_allclose(tout.lm_pw.numpy()[live],
                               np.asarray(jout.lm_pw)[live], atol=1e-3)
    # keyframe 9 followed keyframe 8's correction
    moved = np.abs(np.asarray(jout.kf_t[9]) - np.asarray(m9.kf_t[9])).max()
    assert moved > 0
