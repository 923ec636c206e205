"""Where the time of the PyTorch port's tracking slice goes, on one GPU.

    python3 scripts/profile_torch_slice.py [--frames 60] [--trace-frames 14]
                                           [--out DIR]
                                           [--sensor rgbd|stereo|stereo-kitti]

Runs the bench configuration (640x480, 1000 features, MapConfig(24, 1000,
8000, 8), loop_closing=False) over the synthetic orbit: one pass to build
the map, then one timed pass that re-tracks the same frames. With
``--sensor stereo`` the frames are the rectified pairs of chip_smoke.py's
stereo phase at the same configuration, with ``stereo-kitti`` its 30 pairs
at the KITTI 00-02 camera with 2000 features. The timed pass is measured
two ways:

- per layer: the pipeline's stages are wrapped with a timer that
  synchronizes the device around each call and keeps exclusive time (a
  nested stage's time is not counted in its caller's);
- per kernel: a torch.profiler trace of the first --trace-frames frames of
  the same pass (two maintenance cycles by default: the trace's
  post-processing takes minutes for a whole pass), for device-busy time,
  the idle share and the kernels that take the most device time.

Prints one JSON object as its last line and writes the profiler's table
under --out.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (  # noqa: E402
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu_torch.frontend import stereo  # noqa: E402
from orb_slam2_with_comment_tpu_torch.frontend.extractor import (  # noqa: E402
    OrbExtractor)
from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig  # noqa: E402
from orb_slam2_with_comment_tpu_torch.pipeline import auto, steps  # noqa: E402
from orb_slam2_with_comment_tpu_torch.pipeline.tracking import (  # noqa: E402
    TrackerConfig)

# stage name -> (object, attribute) wrapped with the exclusive timer
STAGES = {
    "extract": (steps, "extract_rgbd_features"),
    # the stereo front end: both views' pyramids and features, then the
    # association (mask, Hamming kernel, outlier sweep) and its SAD part
    "stereo_pyramid": (OrbExtractor, "_pyramid"),
    "stereo_extract": (OrbExtractor, "_extract_from_pyramid"),
    "match_stereo": (stereo, "match_stereo"),
    "sad_refine": (stereo, "_sad_refine"),
    "match_motion_model": (steps, "_match_motion_model"),
    "match_reference_kf": (steps, "_match_reference_kf"),
    "pose_lm": (steps, "_pose_optimize_from_matches"),
    "local_map_search": (steps, "track_local_map"),
    "insert_keyframe": (steps, "insert_keyframe"),
    "create_depth_landmarks": (steps, "create_depth_landmarks"),
    "ph_fuse_in": (auto.AutoStep, "ph_fuse_in"),
    "ph_fuse_out": (auto.AutoStep, "ph_fuse_out"),
    "ph_merge": (auto.AutoStep, "ph_merge"),
    "ph_refresh_cull": (auto.AutoStep, "ph_refresh_cull"),
    "ph_ba1": (auto.AutoStep, "ph_ba1"),
    "ph_ba2": (auto.AutoStep, "ph_ba2"),
}


class ExclusiveTimer:
    def __init__(self):
        self.total = defaultdict(float)
        self.calls = defaultdict(int)
        self.stack = []
        self.on = False

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.stack.append(0.0)
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                inner = self.stack.pop()
                self.total[name] += dt - inner
                self.calls[name] += 1
                if self.stack:
                    self.stack[-1] += dt
        return timed


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--trace-frames", type=int, default=14)
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--sensor", default="rgbd",
                    choices=("rgbd", "stereo", "stereo-kitti"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    if args.sensor == "rgbd":
        n = args.frames
        world = SyntheticWorld(seed=1)
        frames = [(np.clip(img, 0, 255).astype(np.uint8),
                   np.clip(depth * 5000.0, 0, 65535).astype(np.uint16))
                  for img, depth in (world.render(R, t)
                                     for R, t in orbit_trajectory(n))]
        cfg = TrackerConfig(
            n_features=1000, min_init_features=200,
            map_cfg=MapConfig(k_max=24, n_feat=1000, l_max=8000, d_max=8),
            fps=30, depth_factor=1.0 / 5000.0)
    else:
        kitti = args.sensor == "stereo-kitti"
        chip_smoke.render_all(
            max(1, min(7, (os.cpu_count() or 2) - 1)),
            names=(("kitti30_left", "kitti30_right") if kitti
                   else ("orbit60", "orbit60_right")))
        cfg, frames, _ = (chip_smoke.stereo_kitti_setup() if kitti
                          else chip_smoke.stereo_bench_setup())
        n = len(frames)
    timer = ExclusiveTimer()
    for name, (obj, attr) in STAGES.items():
        setattr(obj, attr, timer.wrap(name, getattr(obj, attr)))

    def process(tr, frame):
        if args.sensor == "rgbd":
            tr.process_rgbd(*frame)
        else:
            tr.process_stereo(*frame)

    def built_tracker():
        """A tracker after pass 1 (map built); the timed pass re-tracks."""
        tr = auto.AutoTracker(cfg, auto.AutoTrackerConfig(
            traj_capacity=8 * n, loop_closing=False), device="cuda")
        for frame in frames:
            process(tr, frame)
        torch.cuda.synchronize()
        return tr

    def timed_pass(tr, frames):
        t0 = time.perf_counter()
        for frame in frames:
            process(tr, frame)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # per-layer exclusive times on one tracker's second pass
    tracker = built_tracker()
    timer.on = True
    wall_layers = timed_pass(tracker, frames)
    timer.on = False
    # kernel-level trace of the same pass on a second tracker
    tracker = built_tracker()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    nt = min(args.trace_frames, n)
    with torch.profiler.profile(activities=acts) as prof:
        wall = timed_pass(tracker, frames[:nt])
    timed_pass(tracker, frames[nt:])
    out = tracker.finalize()
    events = prof.key_averages()
    kernels = sorted(
        ((e.key, e.self_device_time_total, e.count) for e in events
         if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda r: -r[1])
    dev_us = sum(us for _, us, _ in kernels)
    n_launch = sum(c for _, _, c in kernels)
    with open(os.path.join(args.out, "key_averages.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    frames_run = 2 * n
    result = {
        "card": card, "sensor": args.sensor, "frames": n,
        "traced_frames": nt,
        "ms_per_frame_layer_pass": 1e3 * wall_layers / n,
        "ms_per_frame_traced": 1e3 * wall / nt,
        "device_busy_ms_per_frame": dev_us / 1e3 / nt,
        "device_idle_share": 1.0 - dev_us / 1e6 / wall,
        "device_ops_per_frame": n_launch / nt,
        "layers_ms_per_frame": {k: 1e3 * v / n for k, v in
                                sorted(timer.total.items(),
                                       key=lambda kv: -kv[1])},
        "layer_calls": dict(timer.calls),
        "top_device_ops_ms_per_frame": [
            [k, us / 1e3 / nt, c] for k, us, c in kernels[:15]],
        "valid_frames": int(out["valid"].sum()), "frames_run": frames_run,
        "n_keyframes": out["n_keyframes"],
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
