"""What the drivers share: their arguments, the reader's timing, the
autonomous (``--auto``) and System runs, and the run summary next to the
trajectory (so downstream tooling attributes per-run counts exactly
instead of parsing a shared log)."""
from __future__ import annotations

import json
import time

from ..pipeline.auto import AutoTrackerConfig


def parse_args(argv, doc: str, n_required: int, options=()):
    """(positional arguments with the program first, --auto given, option
    values by name) from ``argv``, or None after printing ``doc`` when
    fewer than ``n_required`` positional arguments are given. ``--device``
    (default "cuda") and each name in ``options`` (default None) take one
    value."""
    argv = list(argv)
    auto = "--auto" in argv
    if auto:
        argv.remove("--auto")
    opts = {"--device": "cuda", **{name: None for name in options}}
    for name in opts:
        if name in argv:
            i = argv.index(name)
            opts[name] = argv[i + 1]
            del argv[i:i + 2]
    if len(argv) < n_required + 1:
        print(doc)
        return None
    return argv, auto, opts


def auto_tracker_config():
    """The ``--auto`` drivers' AutoTrackerConfig: loop closing on, and each
    keyframe's whole maintenance cycle in the frame after its insert
    (``whole_cycle``), as ORB-SLAM2's LocalMapping finishes each keyframe.
    A vehicle at speed inserts every other frame or so, and then the
    default one phase a frame never reaches local BA or loop detection."""
    return AutoTrackerConfig(whole_cycle=True)


class TimedFrames:
    """Iterates ``frames``, adding the time spent waiting for each frame
    (its decode, or the prefetch queue) to ``seconds``."""

    def __init__(self, frames):
        self._it = iter(frames)
        self.seconds = 0.0

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        try:
            return next(self._it)
        finally:
            self.seconds += time.perf_counter() - t0


def _decode_ms(decode_s, n_frames):
    return round(1000 * decode_s / max(n_frames, 1), 3)


def write_run_summary(out, dt, path="run_summary.json", decode_s=None):
    summary = {
        "n_frames": int(out["n_frames"]),
        "n_keyframes": int(out["n_keyframes"]),
        "n_loops_closed": int(out["n_loops_closed"]),
        "lost_at": int(out["lost_at"]),
        "n_compact_kf": int(out.get("n_compact_kf", 0)),
        "n_compact_lm": int(out.get("n_compact_lm", 0)),
        "fps": round(float(out["n_frames"]) / dt, 2) if dt > 0 else 0.0,
    }
    if decode_s is not None:
        summary["decode_ms"] = _decode_ms(decode_s, out["n_frames"])
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)


def run_auto(tracker, frames, step, kitti: bool = False) -> int:
    """Drive an AutoTracker: ``step(*frame)`` per frame, one sync, then the
    summary, run_summary.json and CameraTrajectory.txt (KITTI lines with
    ``kitti``, else TUM)."""
    reader = TimedFrames(frames)
    t0 = time.perf_counter()
    for frame in reader:
        step(*frame)
    tracker.sync()
    dt = time.perf_counter() - t0
    out = tracker.finalize()
    print(f"{out['n_frames']} frames in {dt:.2f}s "
          f"({out['n_frames'] / dt:.1f} fps), "
          f"{out['n_keyframes']} keyframes, "
          f"{out['n_loops_closed']} loops closed, "
          f"lost_at={out['lost_at']}")
    print(f"waited {_decode_ms(reader.seconds, out['n_frames'])} ms per "
          "frame for the reader")
    write_run_summary(out, dt, decode_s=reader.seconds)
    lines = tracker.trajectory_kitti() if kitti else tracker.trajectory_tum()
    with open("CameraTrajectory.txt", "w") as f:
        f.write("\n".join(lines) + "\n")
    return 0


def run_system(slam, frames, step, saves) -> int:
    """Drive a System: ``step(*frame)`` per frame (timed alone), shutdown,
    the tracking-time summary, then ``getattr(slam, name)(path)`` for each
    (name, path) of ``saves``, and run_summary.json."""
    reader = TimedFrames(frames)
    times, n_tracked = [], 0
    t_run = time.perf_counter()
    for frame in reader:
        t0 = time.perf_counter()
        n_tracked += step(*frame) is not None
        times.append(time.perf_counter() - t0)
    slam.shutdown()
    dt = time.perf_counter() - t_run
    n = len(times)
    mean = sum(times) / n
    times.sort()
    print(f"median tracking time: {times[n // 2]:.4f}s  mean: {mean:.4f}s")
    print(f"waited {_decode_ms(reader.seconds, n)} ms per frame for the "
          "reader")
    for name, path in saves:
        getattr(slam, name)(path)
    tr = slam.tracker
    with open("run_summary.json", "w") as f:
        json.dump({
            "n_frames": n, "n_tracked": n_tracked,
            "n_keyframes": tr.n_kf_host,
            "n_loops_closed": (tr.loop_closer.n_loops_closed
                               if tr.loop_closer is not None else 0),
            "state": tr.state.name,
            "fps": round(n / dt, 2) if dt > 0 else 0.0,
            "median_ms": round(1000 * times[n // 2], 3),
            "mean_ms": round(1000 * mean, 3),
            "decode_ms": _decode_ms(reader.seconds, n)}, f, indent=1)
    return 0
