"""Monocular KITTI driver (reference: Examples/Monocular/mono_kitti.cc).

Usage: python -m orb_slam2_with_comment_tpu_torch.examples.mono_kitti
       <settings.yaml> <sequence_dir> [--auto] [--device cuda]

The System mode writes KeyFrameTrajectory.txt, --auto CameraTrajectory.txt.
"""
import sys

from .. import Sensor, System
from ..dataio.datasets import KittiDataset
from ..dataio.settings import load_tracker_config
from ..pipeline import AutoTracker
from ._util import auto_tracker_config, parse_args, run_auto, run_system


def main(argv):
    parsed = parse_args(argv, __doc__, 2)
    if parsed is None:
        return 1
    argv, auto, opts = parsed
    settings_path = argv[1]
    ds = KittiDataset(argv[2], stereo=False)
    print(f"Loaded {len(ds)} frames from {argv[2]}")
    if auto:
        cfg = load_tracker_config(settings_path, expected_frames=len(ds),
                                  sensor="mono")
        cfg.sensor = "mono"
        tracker = AutoTracker(cfg, auto_tracker_config(),
                              device=opts["--device"])
        return run_auto(tracker, ds, lambda ts, img:
                        tracker.process_mono(img, timestamp=ts))
    slam = System(settings_path=settings_path, sensor=Sensor.MONOCULAR,
                  expected_frames=len(ds), device=opts["--device"])
    return run_system(slam, ds, lambda ts, img: slam.track_monocular(img, ts),
                      [("save_keyframe_trajectory_tum",
                        "KeyFrameTrajectory.txt")])


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
