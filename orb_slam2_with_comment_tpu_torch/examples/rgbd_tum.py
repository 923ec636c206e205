"""RGB-D TUM driver (reference: Examples/RGB-D/rgbd_tum; behavior follows
upstream + README.md:151-167: associations loader -> System::TrackRGBD,
then SaveTrajectoryTUM + SaveKeyFrameTrajectoryTUM).

Usage: python -m orb_slam2_with_comment_tpu_torch.examples.rgbd_tum
       <settings.yaml> <sequence_dir> [associations.txt] [--auto]
       [--device cuda]

--auto runs the autonomous tracker (pipeline.auto.AutoTracker): the whole
per-frame state machine, keyframe maintenance and loop closing included,
with no per-frame readback; the trajectory is read back once at the end.
Frames come through ``TumRgbdDataset.prefetch()`` in both modes.
"""
import sys

from .. import Sensor, System
from ..dataio.datasets import TumRgbdDataset
from ..dataio.settings import load_settings, load_tracker_config
from ..pipeline import AutoTracker
from ._util import auto_tracker_config, parse_args, run_auto, run_system


def main(argv):
    parsed = parse_args(argv, __doc__, 2)
    if parsed is None:
        return 1
    argv, auto, opts = parsed
    settings_path, seq_dir = argv[1], argv[2]
    assoc = argv[3] if len(argv) > 3 else None
    s = load_settings(settings_path)
    ds = TumRgbdDataset(seq_dir, depth_map_factor=s.depth_map_factor,
                        associations=assoc)
    print(f"Loaded {len(ds)} frames from {seq_dir}")
    if auto:
        cfg = load_tracker_config(settings_path, expected_frames=len(ds))
        cfg.sensor = "rgbd"  # loader yields meters; cfg.depth_factor is 1.0
        tracker = AutoTracker(cfg, auto_tracker_config(),
                              device=opts["--device"])
        return run_auto(tracker, ds.prefetch(), lambda ts, rgb, depth:
                        tracker.process_rgbd(rgb, depth, timestamp=ts))
    slam = System(settings_path=settings_path, sensor=Sensor.RGBD,
                  expected_frames=len(ds), device=opts["--device"])
    return run_system(slam, ds.prefetch(), lambda ts, rgb, depth:
                      slam.track_rgbd(rgb, depth, ts),
                      [("save_trajectory_tum", "CameraTrajectory.txt"),
                       ("save_keyframe_trajectory_tum",
                        "KeyFrameTrajectory.txt")])


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
