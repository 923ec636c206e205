"""What the JAX package does on two scenarios of chip_smoke.py, on the CPU:
the outcomes that the script's monocular and free-scale loop gates are set
from.

    JAX_PLATFORMS=cpu python3 scripts/jax_reference_runs.py mono [X_AMP]
    JAX_PLATFORMS=cpu python3 scripts/jax_reference_runs.py loop K_MAX FIX_SCALE SEQ

``mono`` runs the JAX AutoTracker at chip_smoke's monocular configuration
(640x480, 2000 features, MapConfig(24, 2000, 8000, 8)) twice over the
60-frame orbit and prints the bootstrap frame, the keyframe inserts and
the similarity-aligned ATE of either pass (about 5 minutes). ``loop`` runs
chip_smoke's controlled loop (``run_controlled_loop``: the same frames,
drift and, with FIX_SCALE=0, scale injection) through the JAX
keyframe_step and close_loop_step in a map of K_MAX slots, on the sequence
SEQ ("loop18" or "loop18_shifted"), and prints the position error and the
landmark scale of the firing keyframe before and after (about 2 minutes).

This is the one script of the port's tooling that imports the JAX
package; it takes only the pose lists from chip_smoke.py.
"""
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

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


if __name__ == "__main__":
    if sys.argv[1:2] == ["mono"]:
        run_mono(float(sys.argv[2]) if len(sys.argv) > 2 else None)
    elif sys.argv[1:2] == ["loop"] and len(sys.argv) == 5:
        run_loop(int(sys.argv[2]), sys.argv[3] == "1", sys.argv[4])
    else:
        sys.exit(__doc__)
