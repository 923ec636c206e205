"""What the JAX package does on scenarios of chip_smoke.py, on the CPU: the
outcomes that the script's monocular, free-scale loop and driver gates are
set from.

    JAX_PLATFORMS=cpu python3 scripts/jax_reference_runs.py mono [X_AMP]
    JAX_PLATFORMS=cpu python3 scripts/jax_reference_runs.py loop K_MAX FIX_SCALE SEQ
    JAX_PLATFORMS=cpu python3 scripts/jax_reference_runs.py drivers
    JAX_PLATFORMS=cpu python3 scripts/jax_reference_runs.py street FRAMES KMAX [ROOT]
    JAX_PLATFORMS=cpu python3 scripts/jax_reference_runs.py vocab

``mono`` runs the JAX AutoTracker at chip_smoke's monocular configuration
(640x480, 2000 features, MapConfig(24, 2000, 8000, 8)) twice over the
60-frame orbit and prints the bootstrap frame, the keyframe inserts and
the similarity-aligned ATE of either pass (about 5 minutes). ``loop`` runs
chip_smoke's controlled loop (``run_controlled_loop``: the same frames,
drift and, with FIX_SCALE=0, scale injection) through the JAX
keyframe_step and close_loop_step in a map of K_MAX slots, on the sequence
SEQ ("loop18" or "loop18_shifted"), and prints the position error and the
landmark scale of the firing keyframe before and after (about 2 minutes).
``drivers`` writes chip_smoke's phase-14 fixtures (tum_fixture 60 frames,
kitti_fixture and euroc_fixture 30) with scripts/make_fixture_dataset.py's
functions, runs the JAX drivers' main (examples/*.py) on them as
chip_smoke's phases 14b-f run the port's, and prints each run's outcome as
chip_smoke.driver_outcome scores it: frames tracked, first tracked frame,
keyframes, ATE and RPE (about 8 minutes).
``street`` runs the JAX stereo_kitti driver with --auto --kmax KMAX on the
street circuit of FRAMES frames (kitti_street_fixture, 1241x376, 2000
features), as chip_smoke's phase 16c runs the port's, and prints what
examples/eval_street.py scores: frames tracked, keyframes, compactions,
loops closed, ATE, drift and path length. The fixture is ROOT's
kitti_street_fixture when it exists, else the port's writer renders it
in 7 processes (the same bytes as scripts/make_fixture_dataset.py's: 1000
numpy views at about 12 s a view, 30 minutes); the run then takes about
35 minutes at 500 frames. ``vocab`` runs scripts/eval_vocab.py's protocol
(its own functions) and prints, per vocabulary, the table row, the 24
same-place and 24 different-place scores in world order, the recall and
the separation: phase 16d's gates (about 4 minutes).

This is the one script of the port's tooling that imports the JAX
package; it takes the pose lists and the scoring from chip_smoke.py.
"""
import concurrent.futures
import importlib
import importlib.util
import multiprocessing
import os
import sys
import tempfile
import time

import numpy as np
import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from orb_slam2_with_comment_tpu.dataio.synthetic import (  # noqa: E402
    SyntheticWorld)
from orb_slam2_with_comment_tpu.evaluation.ate import (  # noqa: E402
    ate_rmse, camera_centers)
from orb_slam2_with_comment_tpu.frontend import OrbExtractor  # noqa: E402
from orb_slam2_with_comment_tpu.mapstate.map import (  # noqa: E402
    MapConfig, empty_map)
from orb_slam2_with_comment_tpu.pipeline import (  # noqa: E402
    AutoTracker, AutoTrackerConfig, TrackerConfig, auto_loop, steps)
from orb_slam2_with_comment_tpu.place.vocabulary import (  # noqa: E402
    load_default_vocabulary)


def run_mono(x_amp=None):
    cfg = TrackerConfig(sensor="mono", n_features=2000, min_init_features=200,
                        min_init_matches=60, fps=30,
                        map_cfg=MapConfig(24, 2000, 8000, 8))
    world = SyntheticWorld(seed=1)
    poses = chip_smoke.sequences()[chip_smoke.MONO_SEQ][1]
    if x_amp is not None:
        poses = chip_smoke.orbit_trajectory(n_frames=60, x_amp=x_amp)
    imgs = [np.clip(world.render(R, t)[0], 0, 255).astype(np.uint8)
            for R, t in poses]
    n = len(imgs)
    tracker = AutoTracker(cfg, AutoTrackerConfig())
    t0 = time.time()
    for p in range(2):
        for img in imgs:
            tracker.process_mono(img)
        out = tracker.finalize()
        print(f"pass {p + 1}: {time.time() - t0:.1f} s, initialized "
              f"{out['initialized']}, lost_at {out['lost_at']}, keyframes "
              f"{out['n_keyframes']}, valid {int(out['valid'].sum())}, "
              f"bootstrap frame {int(np.argmax(out['valid']))}, loops "
              f"{out['n_loops_closed']}", flush=True)
    print("inserted at", np.nonzero(out["stats"][:, 6] == 1)[0].tolist())
    print("invalid frames", np.nonzero(~out["valid"])[0].tolist())
    gt_R = np.stack([p[0] for p in poses])
    gt_t = np.stack([p[1] for p in poses])
    for p in range(2):
        sel = out["valid"][p * n:(p + 1) * n]
        est = camera_centers(out["R"][p * n:(p + 1) * n][sel],
                             out["t"][p * n:(p + 1) * n][sel])
        print(f"pass {p + 1}: similarity-aligned ATE",
              ate_rmse(est, camera_centers(gt_R[sel], gt_t[sel]),
                       with_scale=True))


def run_loop(k_max, fix_scale, seq):
    cfg = TrackerConfig(n_features=1000, min_init_features=200, fps=30,
                        map_cfg=MapConfig(k_max, 1000, 10000, 8),
                        depth_factor=1.0)
    world = SyntheticWorld(seed=1)
    poses = chip_smoke.sequences()[seq][1]
    ext = OrbExtractor(n_features=1000)
    voc = load_default_vocabulary(as_numpy=True)
    cam = cfg.cam
    m = empty_map(cfg.map_cfg)
    loop = auto_loop.empty_loop_carry(k_max, 1000)
    step = jax.jit(lambda lp, mm, kk: auto_loop.close_loop_step(
        lp, mm, cam, kk, voc, fix_scale=fix_scale))
    drift = np.zeros(3, np.float32)
    scale, scales, center, center_told = 1.0, [], None, None

    def kf_scale(m, k):
        lm = np.asarray(m.kf_lm[k])
        safe = np.clip(lm, 0, None)
        d = np.asarray(m.kf_depth[k])
        has = (lm >= 0) & np.asarray(m.lm_valid)[safe] & (d > 0)
        z = (np.asarray(m.lm_pw)[safe] @ np.asarray(m.kf_R[k])[2]
             + np.asarray(m.kf_t[k])[2])
        return float(np.median((z / (d / scales[k]))[has]))

    t0 = time.time()
    for k, (R, t) in enumerate(poses):
        img, depth = world.render(R, t)
        feats, d = steps.extract_rgbd_features(
            ext, cam, jnp.asarray(np.clip(img, 0, 255).astype(np.float32)),
            jnp.asarray(depth), jnp.float32(1.0), cfg.width, cfg.height)
        if 8 <= k < 14:
            drift = drift + np.float32([0.015, 0.0, 0.008])
            if not fix_scale:
                scale += 0.02
        scales.append(scale)
        t_told = t + drift
        if not fix_scale:
            feats = feats._replace(ur=jnp.full_like(feats.ur, -1.0))
            d = jnp.where(d > 0, d * np.float32(scale), d)
            c = -R.T @ t
            center_told = c if k == 0 else (
                center_told + np.float32(scale) * (c - center))
            center = c
            t_told = (-R @ center_told + drift).astype(np.float32)
        obs = steps.FrameObs(feats, d, jnp.full(d.shape[0], -1, jnp.int32))
        m = steps.keyframe_step(
            m, cam, obs, jnp.asarray(R), jnp.asarray(t_told), jnp.int32(k),
            jnp.float32(cfg.depth_threshold), cfg.width, cfg.height)
        n_before = int(loop.n_loops)
        err = float(np.linalg.norm(np.asarray(m.kf_t[k]) - poses[k][1]))
        scale_before = kf_scale(m, k)
        m, loop = step(loop, m, jnp.int32(k))
        if int(loop.n_loops) > n_before:
            err_after = float(np.linalg.norm(np.asarray(m.kf_t[k])
                                             - poses[k][1]))
            anchor = float(np.abs(np.asarray(m.kf_t[0]) - poses[0][1]).max())
            print(f"fired at keyframe {k}: error {err:.5f} -> {err_after:.5f}"
                  f" m (share {err_after / err:.3f}), landmark scale "
                  f"{scale_before:.4f} -> {kf_scale(m, k):.4f}, keyframe 0 "
                  f"moved {anchor:.2e} m", flush=True)
            print("landmark scale of keyframes 8 on:",
                  {j: round(kf_scale(m, j), 4) for j in range(8, k + 1)},
                  flush=True)
    print(f"took {time.time() - t0:.1f} s")


def _write_fixture(job):
    """One phase-14 fixture, by scripts/make_fixture_dataset.py."""
    name, path, n = job
    spec = importlib.util.spec_from_file_location(
        "make_fixture_dataset", os.path.join(ROOT, "scripts",
                                             "make_fixture_dataset.py"))
    make = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make)
    fn = {"tum_fixture": make.make_tum_rgbd,
          "kitti_fixture": make.make_kitti_stereo,
          "euroc_fixture": make.make_euroc_stereo}[name]
    return fn(path, n_frames=n)


def run_drivers():
    from orb_slam2_with_comment_tpu import System
    from orb_slam2_with_comment_tpu.pipeline import AutoTracker
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    root = tempfile.mkdtemp()
    t0 = time.time()
    jobs = [(name, os.path.join(root, name), n)
            for name, n in chip_smoke.FIXTURE_FRAMES.items()]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(len(jobs),
                                                mp_context=ctx) as pool:
        seqs = dict(zip(chip_smoke.FIXTURE_FRAMES,
                        pool.map(_write_fixture, jobs)))
    print(f"fixtures written in {time.time() - t0:.1f} s to {root}",
          flush=True)
    for phase, (name, fix, auto, traj, kitti, sim3) in \
            chip_smoke.DRIVER_RUNS.items():
        run_dir = os.path.join(root, phase.split()[0])
        os.makedirs(run_dir)
        mod = importlib.import_module(name)
        t0 = time.time()
        with chip_smoke.constructed(AutoTracker, System) as made:
            os.chdir(run_dir)
            try:
                rc = mod.main(chip_smoke.driver_argv(name, seqs[fix], auto))
            finally:
                os.chdir(ROOT)
        assert rc == 0 and len(made) == 1
        tracker = made[0] if auto else made[0].tracker
        got = chip_smoke.driver_outcome(tracker, auto, run_dir, seqs[fix],
                                        traj, kitti, sim3)
        print(f"{phase}: {time.time() - t0:.1f} s, {got}", flush=True)


def run_street(frames, kmax, root=None):
    from orb_slam2_with_comment_tpu_torch.dataio import fixtures
    from orb_slam2_with_comment_tpu_torch.examples import eval_street
    root = root or tempfile.mkdtemp()
    fix = os.path.join(root, "kitti_street_fixture")
    t0 = time.time()
    if not os.path.exists(os.path.join(fix, "poses_gt.txt")):
        fixtures.make_kitti_street(fix, n_frames=frames, workers=7)
        print(f"fixture written in {time.time() - t0:.1f} s to {fix}",
              flush=True)
    with open(os.path.join(fix, "times.txt")) as f:
        assert len(f.read().split()) == frames, "another frame count"
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    mod = importlib.import_module("stereo_kitti")
    wd = os.path.join(root, "run_street")
    os.makedirs(wd, exist_ok=True)
    t0 = time.time()
    os.chdir(wd)
    try:
        rc = mod.main(["stereo_kitti", os.path.join(fix, "settings.yaml"),
                       fix, "--auto", "--kmax", str(kmax)])
    finally:
        os.chdir(ROOT)
    assert rc == 0
    row, scores = eval_street.score(fix, wd, kmax)
    with open(os.path.join(wd, "CameraTrajectory.txt")) as f:
        tracked = sum(1 for ln in f if ln.strip())
    print(f"street, {frames} frames, kmax {kmax}: {time.time() - t0:.1f} s, "
          f"tracked {tracked}", flush=True)
    print(row)
    print(scores)


def run_vocab():
    import importlib.util as iu
    spec = iu.spec_from_file_location(
        "eval_vocab", os.path.join(ROOT, "scripts", "eval_vocab.py"))
    ev = iu.module_from_spec(spec)
    spec.loader.exec_module(ev)
    data = os.path.join(ROOT, "orb_slam2_with_comment_tpu", "place", "data")
    t0 = time.time()
    for name in ("vocab_10k.npz", "vocab_default.npz"):
        voc = ev.load_vocabulary(os.path.join(data, name), as_numpy=True)
        ext = ev.OrbExtractor(n_features=600)
        rng = np.random.default_rng(77)
        same, diff = [], []
        for seed in ev.HELD_OUT_SEEDS:  # eval_vocab.evaluate's loop
            world = SyntheticWorld(seed=seed)
            poses = chip_smoke.orbit_trajectory(n_frames=16)
            R, t = poses[3]
            img_a, _ = world.render(R, t)
            img_b, _ = world.render(*poses[4])
            va = ev.vec(voc, ext, img_a)
            rows = [ev.vec(voc, ext, ev.jitter(img_a, rng)),
                    ev.vec(voc, ext, ev.jitter(img_b, rng)),
                    ev.vec(voc, ext, SyntheticWorld(seed=seed + 1000)
                           .render(R, t)[0]),
                    ev.vec(voc, ext, world.render(*poses[11])[0])]
            sc = np.asarray(ev.score_l1_sparse(
                va[0], va[1], jnp.stack([r[0] for r in rows]),
                jnp.stack([r[1] for r in rows]), int(voc.n_words)))
            same += sc[:2].tolist()
            diff += sc[2:].tolist()
        same, diff = np.asarray(same), np.asarray(diff)
        recall = float(np.mean(same > diff.max()))
        sep = float(np.median(same) / max(np.median(diff), 1e-9))
        print(f"{name}: {time.time() - t0:.1f} s, recall {recall}, "
              f"separation {sep!r}, median same {np.median(same):.3f}, "
              f"diff {np.median(diff):.3f}", flush=True)
        print(f'"{name}": {{"same": {[round(v, 8) for v in same.tolist()]}, '
              f'"diff": {[round(v, 8) for v in diff.tolist()]}, '
              f'"recall": {recall}, "separation": {sep!r}}},')


if __name__ == "__main__":
    if sys.argv[1:2] == ["mono"]:
        run_mono(float(sys.argv[2]) if len(sys.argv) > 2 else None)
    elif sys.argv[1:2] == ["loop"] and len(sys.argv) == 5:
        run_loop(int(sys.argv[2]), sys.argv[3] == "1", sys.argv[4])
    elif sys.argv[1:2] == ["drivers"]:
        run_drivers()
    elif sys.argv[1:2] == ["street"] and len(sys.argv) in (4, 5):
        run_street(int(sys.argv[2]), int(sys.argv[3]),
                   sys.argv[4] if len(sys.argv) == 5 else None)
    elif sys.argv[1:2] == ["vocab"]:
        run_vocab()
    else:
        sys.exit(__doc__)
