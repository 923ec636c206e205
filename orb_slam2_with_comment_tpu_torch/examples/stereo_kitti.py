"""Stereo KITTI driver (reference: Examples/Stereo/stereo_kitti.cc).

Usage: python -m orb_slam2_with_comment_tpu_torch.examples.stereo_kitti
       <settings.yaml> <sequence_dir> [--auto] [--kmax N] [--device cuda]

--auto runs the autonomous tracker (pipeline.auto.AutoTracker): joint L/R
extraction, row-band stereo depth, keyframe maintenance and loop closing,
with no per-frame readback. --kmax sets the keyframe capacity (e.g. to
force slot recycling). Both modes write CameraTrajectory.txt in the KITTI
format (System.cc:436-486 SaveTrajectoryKITTI).
"""
import sys

from .. import Sensor, System
from ..dataio.datasets import KittiDataset
from ..dataio.settings import load_tracker_config
from ..pipeline import AutoTracker
from ._util import parse_args, run_auto, run_system


def main(argv):
    parsed = parse_args(argv, __doc__, 2, options=("--kmax",))
    if parsed is None:
        return 1
    argv, auto, opts = parsed
    kmax = int(opts["--kmax"]) if opts["--kmax"] is not None else None
    settings_path, seq_dir = argv[1], argv[2]
    ds = KittiDataset(seq_dir, stereo=True)
    print(f"Loaded {len(ds)} frames from {seq_dir}")
    if auto:
        cfg = load_tracker_config(settings_path, expected_frames=len(ds),
                                  k_max=kmax)
        cfg.sensor = "stereo"
        tracker = AutoTracker(cfg, device=opts["--device"])
        return run_auto(tracker, ds, lambda ts, left, right:
                        tracker.process_stereo(left, right, timestamp=ts),
                        kitti=True)
    slam = System(settings_path=settings_path, sensor=Sensor.STEREO,
                  expected_frames=len(ds), device=opts["--device"])
    return run_system(slam, ds, lambda ts, left, right:
                      slam.track_stereo(left, right, ts),
                      [("save_trajectory_kitti", "CameraTrajectory.txt")])


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
