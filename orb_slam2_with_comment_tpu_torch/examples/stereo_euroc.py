"""Stereo EuRoC driver with online rectification (reference:
Examples/Stereo/stereo_euroc.cc:97-137: initUndistortRectifyMap from the
YAML LEFT./RIGHT. blocks, remap per frame, then System::TrackStereo).

Usage: python -m orb_slam2_with_comment_tpu_torch.examples.stereo_euroc
       <settings.yaml> <mav0_dir> <timestamps.txt> [--auto] [--device cuda]

The pair is rectified on the device (dataio.rectify.StereoRectifier) and
the rectified tensors feed the tracker.
"""
import sys

from .. import Sensor, System
from ..dataio.datasets import EurocDataset
from ..dataio.rectify import StereoRectifier
from ..dataio.settings import load_settings, load_tracker_config
from ..pipeline import AutoTracker
from ._util import parse_args, run_auto, run_system


def main(argv):
    parsed = parse_args(argv, __doc__, 3)
    if parsed is None:
        return 1
    argv, auto, opts = parsed
    settings_path, mav_dir, times_path = argv[1], argv[2], argv[3]
    s = load_settings(settings_path)
    if s.left_rect is None:
        print("settings file has no LEFT./RIGHT. rectification blocks")
        return 1
    rect = StereoRectifier(s.left_rect, s.right_rect, s.width, s.height,
                           device=opts["--device"])
    ds = EurocDataset(mav_dir, times_path, stereo=True)
    print(f"Loaded {len(ds)} frames from {mav_dir}")
    if auto:
        cfg = load_tracker_config(settings_path, expected_frames=len(ds))
        cfg.sensor = "stereo"
        tracker = AutoTracker(cfg, device=opts["--device"])
        return run_auto(tracker, ds, lambda ts, left, right:
                        tracker.process_stereo(*rect(left, right),
                                               timestamp=ts))
    slam = System(settings_path=settings_path, sensor=Sensor.STEREO,
                  expected_frames=len(ds), device=opts["--device"])
    return run_system(slam, ds, lambda ts, left, right:
                      slam.track_stereo(*rect(left, right), ts),
                      [("save_trajectory_tum", "CameraTrajectory.txt")])


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
