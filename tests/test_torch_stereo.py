"""The stereo front end and the stereo tracker of the PyTorch port against
the JAX package, on the CPU: SyntheticWorld pairs rendered at a true
horizontal baseline, 320x240 with 500 features (and one 1241x376 frame with
2000 features, the KITTI 00-02 camera).

Tolerances and their reasons:
- ``_sad_refine_block`` from the same pyramids, keypoints and coarse
  matches: ``ok`` exact, the refined right u within 1e-3 px and the best
  SAD within 1e-3 relative. The 121-term float32 sums of non-integer
  pixels are added in another order on levels >= 1 (measured: u 0 px, SAD
  <= 2.4e-7 relative at 320x240).
- ``match_stereo`` from the JAX package's features and pyramids: the set
  of features with depth identical, depth within 1e-4 relative and the
  right u within 1e-3 px (measured 1.2e-7 and 0).
- ``OrbExtractor.stereo`` end to end, each side on its own pyramid:
  octaves, valid flags and descriptors identical, the matched set
  identical, depth within 1e-3 relative and the right u within 5e-3 px: the
  coarser pyramid levels differ by a few float32 ulps of 255 and the
  subpixel positions by <= 1.5e-3 px (tests/test_torch_frontend.py), which
  the SAD parabola and bf / disparity pass on (measured 1.2e-5 and 3.1e-5).
- At 1241x376 with 2000 features: octaves, valid flags and descriptors
  identical; positions of valid features within 5e-3 px (measured 3.5e-4).
  Slots without a keypoint carry an arbitrary cell position on both sides
  and are compared nowhere.
- A 10-frame ``process_stereo`` run (loop closing off): the per-frame
  statistics, and with them the keyframe decisions, identical; translations
  within 1e-3 m, rotations within 1e-3 rad (float32 sums in another order
  through tracking and local BA).
- ``build_rectify_map`` exact (the same numpy arithmetic);
  ``remap_bilinear`` within 1e-4 of 255-range pixels (four-term float32
  blend, fused differently by XLA).
- ``trajectory_kitti``: the JAX run's final state, converted, prints the
  same lines.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_with_comment_tpu.dataio import rectify as jrectify
from orb_slam2_with_comment_tpu.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu.frontend import OrbExtractor as JaxExtractor
from orb_slam2_with_comment_tpu.frontend import stereo as jstereo
from orb_slam2_with_comment_tpu.mapstate.map import MapConfig as JaxMapConfig
from orb_slam2_with_comment_tpu.ops import image as jimage
from orb_slam2_with_comment_tpu.pipeline import (
    AutoTracker as JaxAutoTracker, AutoTrackerConfig as JaxAutoTrackerConfig,
    TrackerConfig as JaxTrackerConfig)
from orb_slam2_with_comment_tpu_torch import convert
from orb_slam2_with_comment_tpu_torch.dataio import rectify
from orb_slam2_with_comment_tpu_torch.frontend import stereo
from orb_slam2_with_comment_tpu_torch.frontend.extractor import (
    FrameFeatures, OrbExtractor, level_budgets)
from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig
from orb_slam2_with_comment_tpu_torch.pipeline.auto import (
    AutoTracker, AutoTrackerConfig)
from orb_slam2_with_comment_tpu_torch.pipeline.tracking import TrackerConfig

torch.set_num_threads(2)

CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
BF, N_FEAT, N_FRAMES = 20.0, 500, 10
KW = dict(CAM, sensor="stereo", bf=BF, n_features=N_FEAT,
          min_init_features=100, fps=30)
MAP = dict(k_max=8, n_feat=N_FEAT, l_max=3000, d_max=8)
KITTI = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, width=1241,
             height=376)


def _pair(world, R, t, cam, bf):
    t_r = np.asarray(t, np.float32) - np.array([bf / cam["fx"], 0, 0],
                                               np.float32)
    return tuple(np.clip(world.render(R, tt, **cam)[0], 0, 255).astype(
        np.uint8) for tt in (t, t_r))


def _to_torch(f) -> FrameFeatures:
    def t(a):
        return torch.as_tensor(np.array(a))

    return FrameFeatures(t(f.xy), t(f.response), t(f.octave), t(f.angle),
                         t(np.asarray(f.desc).view(np.int32)), t(f.valid))


@pytest.fixture(scope="module")
def shared():
    """One pair, the JAX package's pyramids and features of both views."""
    img_l, img_r = _pair(SyntheticWorld(seed=1), *orbit_trajectory(16)[5],
                         CAM, BF)
    jx = JaxExtractor(n_features=N_FEAT)
    pyramid = jax.jit(jimage.build_pyramid)
    extract = jax.jit(jx._extract_from_pyramid)
    jpyr = [pyramid(jnp.asarray(im, jnp.float32)) for im in (img_l, img_r)]
    jfeats = [extract(p) for p in jpyr]
    tpyr = [[torch.as_tensor(np.array(a)) for a in p] for p in jpyr]
    tfeats = [_to_torch(f) for f in jfeats]
    return img_l, img_r, jx, jpyr, jfeats, tpyr, tfeats


def test_sad_refine_block_per_level(shared):
    _, _, jx, jpyr, jfeats, tpyr, tfeats = shared
    fx = float(np.float32(CAM["fx"]))
    mask = stereo.association_mask(tfeats[0], tfeats[1], jx.scales, fx)
    assert 0.001 < float(mask.float().mean()) < 0.05  # a sparse row band
    _, best_j, _, _ = stereo.hamming.masked_best_two(
        tfeats[0].desc, tfeats[1].desc, mask)
    u_r0 = tfeats[1].xy[best_j.long(), 0]
    off, n_ok = 0, 0
    for lvl, budget in enumerate(jx.budgets):
        sl = slice(off, off + budget)
        off += budget
        inv = 1.0 / jx.scales[lvl]
        ju, jsad, jok = (np.asarray(a) for a in jax.jit(
            lambda pl, pr, xy, u0, inv=inv: jstereo._sad_refine_block(
                pl, pr, inv, xy, u0))(
            jpyr[0][lvl], jpyr[1][lvl], jfeats[0].xy[sl],
            jnp.asarray(u_r0[sl].numpy())))
        tu, tsad, tok = (a.numpy() for a in stereo._sad_refine_block(
            tpyr[0][lvl], tpyr[1][lvl], inv, tfeats[0].xy[sl], u_r0[sl]))
        np.testing.assert_array_equal(tok, jok, err_msg=f"level {lvl}")
        np.testing.assert_allclose(tsad, jsad, rtol=1e-3, atol=0)
        np.testing.assert_allclose(tu[jok], ju[jok], rtol=0, atol=1e-3)
        n_ok += int(jok.sum())
    assert off == N_FEAT and n_ok > 100


def _assert_depth_agrees(tsd, jsd, rtol, u_atol, min_matched):
    jd, td = np.asarray(jsd.depth), tsd.depth.numpy()
    np.testing.assert_array_equal(td > 0, jd > 0)
    has = jd > 0
    assert int(has.sum()) > min_matched
    np.testing.assert_allclose(td[has], jd[has], rtol=rtol, atol=0)
    np.testing.assert_allclose(tsd.u_right.numpy()[has],
                               np.asarray(jsd.u_right)[has], rtol=0,
                               atol=u_atol)
    np.testing.assert_array_equal(td[~has], -1.0)
    np.testing.assert_array_equal(tsd.u_right.numpy()[~has], -1.0)


def test_match_stereo_from_jax_features(shared):
    _, _, jx, jpyr, jfeats, tpyr, tfeats = shared
    jsd = jax.jit(lambda fl, fr, pl, pr: jstereo.match_stereo(
        fl, fr, pl, pr, jx.budgets, jnp.float32(BF),
        jnp.float32(CAM["fx"])))(jfeats[0], jfeats[1], jpyr[0], jpyr[1])
    tsd = stereo.match_stereo(tfeats[0], tfeats[1], tpyr[0], tpyr[1],
                              jx.budgets, BF, CAM["fx"])
    _assert_depth_agrees(tsd, jsd, rtol=1e-4, u_atol=1e-3, min_matched=150)


def test_extractor_stereo_end_to_end(shared):
    img_l, img_r, jx, _, _, _, _ = shared
    jf, jsd = jx.stereo(jnp.asarray(img_l), jnp.asarray(img_r), BF,
                        CAM["fx"])
    tf, tsd = OrbExtractor(n_features=N_FEAT).stereo(
        torch.as_tensor(img_l), torch.as_tensor(img_r), BF, CAM["fx"])
    np.testing.assert_array_equal(tf.octave.numpy(), np.asarray(jf.octave))
    np.testing.assert_array_equal(tf.valid.numpy(), np.asarray(jf.valid))
    np.testing.assert_array_equal(tf.desc.numpy(),
                                  np.asarray(jf.desc).view(np.int32))
    _assert_depth_agrees(tsd, jsd, rtol=1e-3, u_atol=5e-3, min_matched=150)


def test_features_identical_at_kitti_shape():
    """1241x376 (an odd width, other resize ratios than 4:3), 2000
    features."""
    img, _ = SyntheticWorld(seed=1).render(*orbit_trajectory(16)[5], **KITTI)
    img = np.clip(img, 0, 255).astype(np.uint8)
    jf = JaxExtractor(n_features=2000)(jnp.asarray(img))
    tx = OrbExtractor(n_features=2000)
    tf = tx(torch.as_tensor(img))
    # the per-level blocks are not those of 1000 features, doubled
    assert sum(tx.budgets) == 2000
    assert tx.budgets != [2 * b for b in level_budgets(1000)]
    valid = np.asarray(jf.valid)
    assert valid.sum() > 500
    np.testing.assert_array_equal(tf.valid.numpy(), valid)
    np.testing.assert_array_equal(tf.octave.numpy(), np.asarray(jf.octave))
    np.testing.assert_array_equal(tf.desc.numpy(),
                                  np.asarray(jf.desc).view(np.int32))
    np.testing.assert_allclose(tf.xy.numpy()[valid], np.asarray(jf.xy)[valid],
                               rtol=0, atol=5e-3)


@pytest.fixture(scope="module")
def runs():
    world = SyntheticWorld(seed=1)
    frames = [_pair(world, R, t, CAM, BF)
              for R, t in orbit_trajectory(N_FRAMES)]
    jt = JaxAutoTracker(JaxTrackerConfig(map_cfg=JaxMapConfig(**MAP), **KW),
                        JaxAutoTrackerConfig(loop_closing=False))
    tt = _torch_tracker()
    for left, right in frames:
        jt.process_stereo(left, right)
        tt.process_stereo(left, right)
    return jt, tt


def _torch_tracker():
    return AutoTracker(TrackerConfig(map_cfg=MapConfig(**MAP), **KW),
                       AutoTrackerConfig(loop_closing=False), device="cpu")


def test_stereo_run_matches_jax(runs):
    jt, tt = runs
    jout, tout = jt.finalize(), tt.finalize()
    inserts = np.nonzero(jout["stats"][:, 6])[0]
    assert len(inserts) >= 2 and jout["valid"].all()
    assert tout["initialized"] and tout["lost_at"] == jout["lost_at"] == -1
    assert tout["n_keyframes"] == jout["n_keyframes"]
    np.testing.assert_array_equal(tout["valid"], jout["valid"])
    np.testing.assert_array_equal(tout["stats"], jout["stats"])
    np.testing.assert_allclose(tout["t"], jout["t"], rtol=0, atol=1e-3)
    for Rt, Rj in zip(tout["R"], jout["R"]):
        cos = (np.trace(Rt @ Rj.T) - 1) / 2
        assert np.arccos(np.clip(cos, -1, 1)) < 1e-3
    errs = [np.linalg.norm(tout["t"][i] - t)
            for i, (_, t) in enumerate(orbit_trajectory(N_FRAMES))]
    assert np.median(errs) < 0.03  # tests/test_auto.py's stereo gate


def test_stereo_state_converts_both_ways_and_prints_kitti(runs):
    """The JAX run's final state, converted: the same state back, and the
    same KITTI lines, one per valid frame."""
    jt, _ = runs
    snap = jax.device_get(jt.state)
    tt = _torch_tracker()
    tt.state = convert.auto_state_from_numpy(snap, "cpu")
    tt.frame_count = jt.frame_count
    tt.timestamps = list(jt.timestamps)
    back = convert.auto_state_to_numpy(tt.state)
    for f in ("traj_R", "traj_t", "traj_valid", "traj_stats", "last_R",
              "last_t", "ref_kf", "frame_idx"):
        np.testing.assert_array_equal(back[f], np.asarray(getattr(snap, f)))
    for f in ("kf_lm", "kf_desc", "kf_xy", "lm_pw", "lm_valid", "n_kf"):
        np.testing.assert_array_equal(back["map"][f],
                                      np.asarray(getattr(snap.map, f)))
    np.testing.assert_array_equal(back["prev"]["feats"]["ur"],
                                  np.asarray(snap.prev.feats.ur))
    lines = tt.trajectory_kitti()
    assert lines == jt.trajectory_kitti()
    assert len(lines) == N_FRAMES and all(len(ln.split()) == 12
                                          for ln in lines)
    # an invalid frame is left out, as the JAX package leaves it out
    tt.state = tt.state._replace(traj_valid=tt.state.traj_valid.clone())
    tt.state.traj_valid[3] = False
    assert tt.trajectory_kitti() == lines[:3] + lines[4:]


def test_tracker_refuses_what_is_not_ported():
    mono = AutoTracker(TrackerConfig(map_cfg=MapConfig(**MAP),
                                     **dict(KW, sensor="mono")), device="cpu")
    assert mono._step.is_mono  # ported: tests/test_torch_mono.py drives it
    with pytest.raises(ValueError):
        AutoTracker(TrackerConfig(map_cfg=MapConfig(**MAP),
                                  **dict(KW, sensor="lidar")), device="cpu")
    with pytest.raises(NotImplementedError):
        AutoTracker(TrackerConfig(map_cfg=MapConfig(**MAP),
                                  dist=(0.1, 0, 0, 0, 0), **KW), device="cpu")


def _euroc_like(rng):
    """A radtan camera pair in the EuRoC settings' layout; the rectified
    focal length is short enough for the borders to fall outside the
    source images."""
    out = []
    for side in range(2):
        K = np.array([[458.0 + side, 0, 367.2], [0, 457.3, 248.4 - side],
                      [0, 0, 1]])
        D = np.array([-0.28, 0.074, 2e-4, 2e-5, 0.0]) * (1 + 0.1 * side)
        w = rng.normal(0, 0.01, 3)
        th = np.linalg.norm(w)
        k = w / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
        P = np.array([[320.0, 0, 367.4, -35.2 * side], [0, 320.0, 252.2, 0],
                      [0, 0, 1, 0]])
        out.append(dict(K=K, D=D, R=R, P=P))
    return out


def test_rectify_map_and_remap():
    rng = np.random.default_rng(0)
    left, right = _euroc_like(rng)
    w, h = 188, 120
    for side in (left, right):
        for s in ("K", "P"):
            side[s] = side[s] / 4.0
            side[s][2, 2] = 1.0
    img_l, img_r = (rng.uniform(0, 255, (h, w)).astype(np.float32)
                    for _ in range(2))
    jr = jrectify.StereoRectifier(left, right, w, h)
    tr = rectify.StereoRectifier(left, right, w, h, device="cpu")
    for tm, jm in ((tr.map_l, jr.map_l), (tr.map_r, jr.map_r)):
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    outside = (tr.map_l[..., 0] < 0) | (tr.map_l[..., 0] > w - 1)
    assert 0 < int(outside.sum()) < outside.numel() // 2
    for t_out, j_out in zip(tr(img_l, img_r), jr(img_l, img_r)):
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0,
                                   atol=1e-4)
    assert float(tr(img_l, img_r)[0][outside].abs().max()) == 0.0
