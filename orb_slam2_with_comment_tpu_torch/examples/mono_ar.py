"""Augmented-reality demo (reference: Examples/ROS/ORB_SLAM2/src/AR/
ros_mono_ar.cc + ViewerAR.cc; the counterpart of examples/mono_ar.py).

The reference tracks a live camera monocularly, fits a dominant plane to
the well-observed map points (DetectPlane, ViewerAR.cc:392) and renders a
virtual cube on it. This headless driver runs the same pipeline on a TUM
monocular directory or on the synthetic world, inserts the cube once
tracking is stable, and writes an overlay PNG per tracked frame (tracked
points, plane grid, cube) with the port's own PNG codec.

Usage (options take their value after "="):
  python -m orb_slam2_with_comment_tpu_torch.examples.mono_ar --synthetic
      [--out=ar_out] [--frames=80] [--insert-at=30] [--cube-size=0.15]
      [--workers=N] [--device=cuda]
  python -m orb_slam2_with_comment_tpu_torch.examples.mono_ar
      <settings.yaml> <tum_sequence_dir> [--out=ar_out] [--device=cuda]

The plane detection at frame i draws from a torch.Generator seeded with i
(the JAX driver draws from PRNGKey(i)). ``--workers`` renders the
synthetic frames in that many spawned processes first (default 1).

The synthetic mode tracks with bench.py's monocular configuration (2000
features, 60 initialization matches; bench.py:196-206). The JAX driver
takes the default TrackerConfig there, whose 100-match initialization
gate the orbit's consecutive frames never pass (bench.py says so, and
the two packages' matchers agree), so it never initializes.
"""
import os
import sys

import numpy as np
import torch

from .. import Sensor, System
from ..dataio.png import write_png
from ..mapstate.map import MapConfig
from ..pipeline.tracking import TrackerConfig
from ..visualization import ar
from ..visualization.frame_drawer import draw_frame


def synthetic_config() -> TrackerConfig:
    """bench.py's monocular configuration (bench.py:202-206)."""
    return TrackerConfig(sensor="mono", n_features=2000, min_init_features=200,
                         min_init_matches=60,
                         map_cfg=MapConfig(24, 2000, 8000, 8), fps=30)


def _tracked_points(slam):
    """World points with more than 5 observations (ViewerAR.cc:405), as
    tensors on the map's device."""
    m = slam.tracker.map
    n_obs = (m.lm_obs_kf >= 0).sum(1)
    return m.lm_pw, m.lm_valid & (n_obs > 5)


def main(argv):
    args = [a for a in argv[1:] if not a.startswith("--")]
    opts = {a.split("=")[0]: (a.split("=", 1) + ["1"])[1]
            for a in argv[1:] if a.startswith("--")}
    out_dir = opts.get("--out", "ar_out")
    os.makedirs(out_dir, exist_ok=True)
    insert_at = int(opts.get("--insert-at", 30))
    cube_size = float(opts.get("--cube-size", 0.15))
    device = torch.device(opts.get("--device", "cuda"))

    if "--synthetic" in opts:
        from ..dataio.fixtures import render_views
        from ..dataio.synthetic import orbit_trajectory
        n_frames = int(opts.get("--frames", 80))
        poses = orbit_trajectory(n_frames)
        renders = render_views(("orbit", 0, False), poses,
                               workers=int(opts.get("--workers", 1)))
        slam = System(synthetic_config(), Sensor.MONOCULAR, device=device)
        frames = ((img, i) for i, (img, _) in enumerate(renders))
    else:
        if len(args) < 2:
            print(__doc__)
            return 1
        from ..dataio.datasets import TumMonoDataset
        ds = TumMonoDataset(args[1])
        slam = System(settings_path=args[0], sensor=Sensor.MONOCULAR,
                      device=device)
        frames = ((img, i) for i, (_, img) in enumerate(ds.prefetch()))
    cam = slam.config.cam

    plane = None
    n_drawn = 0
    for img, i in frames:
        T = slam.track_monocular(img, timestamp=i / 30.0)
        if T is None:
            continue
        Rcw, tcw = T[:3, :3], T[:3, 3]
        if plane is None and i >= insert_at:
            pts, valid = _tracked_points(slam)
            gen = torch.Generator(device=pts.device).manual_seed(i)
            det = ar.detect_plane(pts, valid, Rcw, tcw, gen)
            if det is not None:
                plane = det[:2]
                print(f"frame {i}: new virtual cube inserted "
                      f"({int(det[2].sum())} plane inliers)")
        tr = slam.tracker
        obs = tr.last_obs
        over = draw_frame(np.asarray(img), obs.feats.xy.cpu().numpy(),
                          obs.lm.cpu().numpy(),
                          obs.feats.valid.cpu().numpy(), state="OK",
                          n_kf=tr.n_kf_host,
                          n_lm=int(tr.map.lm_valid.sum()))
        if plane is not None:
            over[:img.shape[0]] = ar.draw_ar(
                over[:img.shape[0]], cam, Rcw, tcw, *plane,
                cube_size=cube_size)
        write_png(os.path.join(out_dir, f"ar_{i:05d}.png"), over)
        n_drawn += 1
    slam.shutdown()
    print(f"wrote {n_drawn} overlay frames to {out_dir}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
