"""The port's headline benchmark: the repository's ``bench.py`` on the card.

    python -m orb_slam2_with_comment_tpu_torch.bench [--device cuda]

It runs bench.py's five figures, with bench.py's configurations and pass
counts, on the port's ``AutoTracker`` (loop closing and relocalization on,
``batch_frames=4``), and prints one JSON line with bench.py's keys.
``BENCH_FRAMES`` (default 60) sets the orbit's length, as at bench.py:71.

| figure | bench.py | configuration | passes |
| --- | --- | --- | --- |
| ``tracking_fps`` (the headline) | :72-103 | SyntheticWorld(seed=1), orbit_trajectory(n), 640x480, 1000 features, MapConfig(24, 1000, 8000, 8), depth_factor 1/5000 | one untimed build pass, then 3 timed re-tracking passes; the median |
| ``extra.map_building_fps`` | :115-125 | a fresh tracker of the same configuration, built before the clock starts | 1 timed pass from scratch |
| ``extra.stereo_fps`` | :127-152 | stereo, bf 40 at fx 500 (8 cm), 1000 features | 1 build pass, then 2 timed |
| ``extra.stereo_kitti_fps`` | :154-188 | the KITTI 00-02 camera (1241x376, bf 386.1448), 2000 features, fps 10, the first max(20, n // 2) poses | 1 build pass, then 2 timed |
| ``extra.mono_fps`` | :190-218 | mono, 2000 features, min_init_matches 60, MapConfig(24, 2000, 8000, 8) | 1 build pass, then 2 timed |

Every ``AutoTrackerConfig`` is bench.py's: ``traj_capacity`` 8 times the
figure's frames and ``batch_frames=4``. bench.py batches four frames into
one dispatch to spare its TPU transport; here the batched path runs the
same per-frame step in order and equals the per-frame path bit for bit
(``pipeline/auto.py`` ``rgbd_batch``; tests/test_torch_batched.py holds it
against the JAX package), so it only groups the RGB-D uploads to the card.
Stereo and mono frames are not batched, in either package.

**Frames.** Every frame is rendered before any clock starts, by
``dataio/synthetic.render_views`` on the bench's device (16 views a batch):
the numpy renderer's arithmetic in float32, so a few pixels of a frame may
be one grey level from bench.py's ``world.render``. ``world.render`` would
give bench.py's exact inputs, but takes seconds a frame at the KITTI
camera; the gates below hold on these frames all the same. Frames enter
the tracker as uint8 images and uint16 depth (5000 a metre) in host
memory, as in bench.py, so each frame's upload is part of its cost, as it
is for a user. Where bench.py's orbit has fewer poses than ``n_kitti``
(``BENCH_FRAMES`` below 20), the KITTI figure tracks the poses there are
and divides by their count.

**Timing.** A pass records a CUDA event on the current stream, runs its
``process_*`` calls with no readback and no synchronization of its own,
ends with ``tracker.drain()`` (a partial batch), records the end event,
then waits (``tracker.sync()``). The figure is the median of the passes'
rates by the events; the host clock of each pass is reported beside it.
On the CPU (the tests) there are no events and the host clock gives the
rate. Every kernel library of the path is built and loaded before the
first frame (``ops/cuda_lib.build_all``, one nvcc a source, all at once),
so no build can land inside a timed pass; the map-building figure runs
after the headline has launched every kernel of the RGB-D path.
``run`` is ``figures``, then ``track`` for each figure (its passes, and
each timed pass's launches), then ``report`` (the gates and the line);
chip_smoke.py's phase 17 calls the three itself, a figure at a time.

**Gates** (bench.py:220-266, and PERF.md section 2's pose gates from
tests/test_auto.py:183-185 and :310-311, on the timed passes against the
orbit's ground truth). The headline needs an initialized run, no loss,
every timed frame valid and at least 3 keyframes, and each timed pass's
median translation error below 0.02 m and median rotation error below
1 degree; otherwise the line is ``value`` 0.0 with an ``error`` object,
and ``main`` returns 1. A sub-figure needs an initialized run, no loss and
its pose gates: below 0.02 m (0.03 m for stereo) and 1 degree, or for
mono a similarity-aligned ATE below 0.03 m (``evaluation/ate.py``
``ate_rmse(..., with_scale=True)``). One that fails goes to ``errors``,
with a line on stderr, and never appears as a rate. The validation
readbacks (``finalize()``) come after all timing, in bench.py's order.

**Output.** bench.py's keys: ``metric``, ``value``, ``unit``,
``vs_baseline`` (value / 30, bench.py:67), ``extra`` with the four
sub-figures, and ``errors`` when a figure failed. Under ``extra`` only:
``passes``, for each figure that passed, its per-pass ms per frame by CUDA
events (``events_ms_per_frame``, null on the CPU) and by the host clock
(``host_ms_per_frame``), and its launches per timed frame of each kernel
entry point (``launches_per_frame``, from the wrappers' ``LAUNCHES``
counters; all 0 on the CPU, where the plain versions run); and ``card``,
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``. Numbers
are not rounded.

**Device.** ``--device`` defaults to ``cuda``, and without a card the bench
raises: it never carries on on the CPU. ``--device cpu`` runs the plain
versions, for the tests at a reduced size (``run(reduced=...)``). No
failure is caught. On the card every kernel of these paths is the
hand-written one: K1 (csrc/hamming.cu), K2 (csrc/orb.cu) and K3
(csrc/pose_lm.cu) on every path, K4 (csrc/ba.cu) wherever keyframe
maintenance runs a local BA, K5 (csrc/stereo_sad.cu) once a stereo pair.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from .dataio.synthetic import SyntheticWorld, orbit_trajectory, render_views
from .evaluation.ate import ate_rmse, camera_centers
from .mapstate.map import MapConfig
from .ops import cuda_lib, hamming, orb, sad
from .optim import ba, pose_opt
from .pipeline.auto import AutoTracker, AutoTrackerConfig
from .pipeline.tracking import TrackerConfig

BASELINE_FPS = 30.0  # bench.py:67
KITTI_CAM = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                 width=1241, height=376)  # Examples/Stereo/KITTI00-02.yaml
KITTI_BF = 386.1448
CAMERA = ("fx", "fy", "cx", "cy", "width", "height")
# the kernel libraries of the bench's paths, and their launch counters
KERNEL_LIBS = ("hamming", "pose_lm", "orb", "stereo_sad", "ba")
COUNTERS = (hamming.LAUNCHES, orb.LAUNCHES, pose_opt.LAUNCHES, sad.LAUNCHES,
            ba.LAUNCHES)
# median translation error gates in metres (tests/test_auto.py:183-185),
# median rotation error in degrees, similarity-aligned ATE for mono
# (tests/test_auto.py:310-311)
T_GATE = {"rgbd": 0.02, "stereo": 0.03}
ROT_GATE = 1.0
ATE_GATE = 0.03
HEADLINE = "tracking_fps"
SUB_FIGURES = ("map_building_fps", "stereo_fps", "stereo_kitti_fps",
               "mono_fps")


@dataclass
class Figure:
    """One figure: its tracker's configuration, its frames (the arguments
    of one ``process_<sensor>`` call each), the ground truth of each frame,
    whether an untimed build pass comes first, and its timed passes."""
    name: str
    cfg: TrackerConfig
    frames: list
    poses: list
    build: bool
    passes: int


def figures(n: int, device, reduced: dict | None = None,
            passes: int | None = None) -> list[Figure]:
    """bench.py's five figures over ``orbit_trajectory(n)``, their frames
    rendered on ``device``. ``reduced`` (tests only): camera fields and
    ``n_features`` that replace every figure's, each stereo figure keeping
    its baseline in metres; ``passes`` replaces every figure's timed
    passes."""
    poses = orbit_trajectory(n_frames=n)
    n_kitti = max(20, n // 2)  # bench.py:158
    rgbd = TrackerConfig(
        n_features=1000, min_init_features=200,
        map_cfg=MapConfig(k_max=24, n_feat=1000, l_max=8000, d_max=8),
        fps=30, depth_factor=1.0 / 5000.0)
    stereo = TrackerConfig(
        sensor="stereo", n_features=1000, min_init_features=200,
        map_cfg=MapConfig(k_max=24, n_feat=1000, l_max=8000, d_max=8),
        fps=30)
    kitti = TrackerConfig(
        sensor="stereo", n_features=2000, min_init_features=200,
        bf=KITTI_BF, map_cfg=MapConfig(k_max=24, n_feat=2000, l_max=8000,
                                       d_max=8), fps=10, **KITTI_CAM)
    mono = TrackerConfig(
        sensor="mono", n_features=2000, min_init_features=200,
        min_init_matches=60,
        map_cfg=MapConfig(k_max=24, n_feat=2000, l_max=8000, d_max=8),
        fps=30)
    rgbd, stereo, kitti, mono = (_sized(c, reduced)
                                 for c in (rgbd, stereo, kitti, mono))
    world = SyntheticWorld(seed=1)
    views = render(world, poses, device, rgbd)
    images = [img for img, _ in views]
    rights = render(world, _shifted(poses, stereo), device, stereo)
    kt_poses = poses[:n_kitti]
    kt_left = render(world, kt_poses, device, kitti)
    kt_right = render(world, _shifted(kt_poses, kitti), device, kitti)
    rgbd_frames = [(img, _depth_u16(depth)) for img, depth in views]

    def count(k):
        return k if passes is None else passes

    return [
        Figure(HEADLINE, rgbd, rgbd_frames, poses, True, count(3)),
        Figure("map_building_fps", rgbd, rgbd_frames, poses, False, 1),
        Figure("stereo_fps", stereo, list(zip(images, (r for r, _ in rights))),
               poses, True, count(2)),
        Figure("stereo_kitti_fps", kitti,
               [(left, right) for (left, _), (right, _)
                in zip(kt_left, kt_right)], kt_poses, True, count(2)),
        Figure("mono_fps", mono, [(img,) for img in images], poses, True,
               count(2)),
    ]


def _sized(cfg: TrackerConfig, reduced: dict | None) -> TrackerConfig:
    if reduced is None:
        return cfg
    n = reduced["n_features"]
    cam = {k: reduced[k] for k in CAMERA}
    return replace(cfg, **cam, bf=cfg.bf / cfg.fx * cam["fx"], n_features=n,
                   map_cfg=cfg.map_cfg._replace(n_feat=n))


def _shifted(poses, cfg: TrackerConfig):
    """The right camera's poses: ``bf / fx`` metres along x."""
    shift = np.array([cfg.bf / cfg.fx, 0, 0], np.float32)
    return [(R, np.asarray(t, np.float32) - shift) for R, t in poses]


def _depth_u16(depth: np.ndarray) -> np.ndarray:
    return np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)


def render(world, poses, device, cfg: TrackerConfig) -> list:
    """(uint8 image, float depth in metres) of each pose at ``cfg``'s
    camera, rendered on ``device`` 16 views a batch."""
    cam = {k: getattr(cfg, k) for k in CAMERA}
    views = [v for i in range(0, len(poses), 16)
             for v in render_views(world, poses[i:i + 16], device, **cam)]
    return [(np.clip(img, 0, 255).astype(np.uint8), depth)
            for img, depth in views]


def launch_counts() -> dict:
    """Each kernel entry point's launches so far."""
    return {k: v for c in COUNTERS for k, v in c.items()}


def build_kernels():
    """Build every kernel library of the bench's paths (one nvcc a source,
    all at once) and load it, so that no build lands inside a timed pass."""
    cuda_lib.build_all(list(KERNEL_LIBS))
    for mod in (hamming, pose_opt, orb, sad, ba):
        mod._kernel_lib()


def card_name(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def timed_pass(tracker: AutoTracker, process, frames) -> tuple:
    """(CUDA-event ms, host-clock ms) per frame of one pass over ``frames``;
    the event time is None on the CPU."""
    cuda = tracker.device.type == "cuda"
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for frame in frames:
        process(*frame)
    tracker.drain()
    if cuda:
        end.record()
    tracker.sync()
    host = 1000 * (time.perf_counter() - t0) / len(frames)
    return (start.elapsed_time(end) / len(frames) if cuda else None), host


@dataclass
class Run:
    """One figure's tracker after its passes: each timed pass's
    (CUDA-event ms, host-clock ms) per frame, and each timed pass's
    launches of each kernel entry point."""
    tracker: AutoTracker
    times: list
    launches: list


def track(fig: Figure, device) -> Run:
    """Build ``fig``'s tracker, run its build pass and its timed passes."""
    tracker = AutoTracker(fig.cfg, AutoTrackerConfig(
        traj_capacity=8 * len(fig.frames), batch_frames=4), device=device)
    process = getattr(tracker, {"rgbd": "process_rgbd",
                                "stereo": "process_stereo",
                                "mono": "process_mono"}[fig.cfg.sensor])
    if fig.build:
        for frame in fig.frames:
            process(*frame)
        tracker.sync()
    times, launches = [], []
    for _ in range(fig.passes):
        before = launch_counts()
        times.append(timed_pass(tracker, process, fig.frames))
        launches.append({k: v - before[k] for k, v in launch_counts().items()})
    return Run(tracker, times, launches)


def pose_errors(out: dict, poses, offset: int = 0) -> tuple:
    """Median translation error (m) and rotation error (degrees) of the
    frames ``offset``.. against ``poses``, world->camera."""
    n = len(poses)
    t_err = [np.linalg.norm(out["t"][offset + i] - poses[i][1])
             for i in range(n)]
    r_err = [np.degrees(np.arccos(np.clip(
        (np.trace(out["R"][offset + i] @ poses[i][0].T) - 1) / 2, -1, 1)))
        for i in range(n)]
    return float(np.median(t_err)), float(np.median(r_err))


def sim_ate(out: dict, poses, offset: int = 0) -> float:
    """Similarity-aligned (scale + SE3) ATE RMSE in metres over the valid
    frames ``offset``.. against ``poses``."""
    n = len(poses)
    sel = out["valid"][offset:offset + n]
    gt = camera_centers(np.stack([p[0] for p in poses])[sel],
                        np.stack([p[1] for p in poses])[sel])
    est = camera_centers(out["R"][offset:offset + n][sel],
                         out["t"][offset:offset + n][sel])
    return float(ate_rmse(est, gt, with_scale=True))


def check(fig: Figure, out: dict) -> tuple[bool, dict]:
    """(whether ``fig`` passes its gates, what they read) from its
    tracker's ``finalize()``."""
    n = len(fig.frames)
    seen = {"initialized": bool(out["initialized"]),
            "lost_at": int(out["lost_at"]),
            "n_keyframes": int(out["n_keyframes"])}
    ok = seen["initialized"] and seen["lost_at"] < 0
    first = n if fig.build else 0
    if fig.name == HEADLINE:
        seen["valid_timed"] = int(out["valid"][first:].sum())
        ok = (ok and seen["valid_timed"] == fig.passes * n
              and seen["n_keyframes"] >= 3)
    if not ok:
        return False, seen
    offsets = [first + p * n for p in range(fig.passes)]
    if fig.cfg.sensor == "mono":
        seen["ate_m"] = [sim_ate(out, fig.poses, o) for o in offsets]
        return all(a < ATE_GATE for a in seen["ate_m"]), seen
    errs = [pose_errors(out, fig.poses, o) for o in offsets]
    seen["median_t_err_m"] = [t for t, _ in errs]
    seen["median_rot_err_deg"] = [r for _, r in errs]
    return all(t < T_GATE[fig.cfg.sensor] and r < ROT_GATE
               for t, r in errs), seen


def rate(passes) -> float:
    """Frames per second of the median pass: by CUDA events where there
    are events, by the host clock on the CPU."""
    ms = [ev if ev is not None else host for ev, host in passes]
    return float(np.median([1000.0 / m for m in ms]))


def run(device="cuda", n_frames: int = 60, reduced: dict | None = None,
        passes: int | None = None) -> dict:
    """Run the five figures on ``device`` and return the JSON line's
    object. ``reduced`` and ``passes`` are for the tests (``figures``)."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the bench runs on cuda or cpu, not {device}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the bench needs a CUDA device and none is available "
                "(--device cpu runs the plain versions, for the tests)")
        build_kernels()
    figs = figures(n_frames, device, reduced, passes)
    return report(figs, [track(fig, device) for fig in figs], device)


def report(figs: list[Figure], runs: list[Run], device) -> dict:
    """The JSON line's object from the figures' runs: the validation
    readbacks (``finalize()``), after all timing, in bench.py's order."""
    ok, seen = check(figs[0], runs[0].tracker.finalize())
    if not ok:
        return {"metric": HEADLINE, "value": 0.0, "unit": "frames/s",
                "vs_baseline": 0.0, "error": seen}
    fps = rate(runs[0].times)
    extra, errors = {}, {}
    timings = {HEADLINE: _timings(figs[0], runs[0])}
    for fig, fig_run in zip(figs[1:], runs[1:]):
        ok, seen = check(fig, fig_run.tracker.finalize())
        if ok:
            extra[fig.name] = rate(fig_run.times)
            timings[fig.name] = _timings(fig, fig_run)
        else:
            errors[fig.name] = seen
            print(f"bench: {fig.name} validation FAILED: {seen}",
                  file=sys.stderr)
    extra["passes"] = timings
    extra["card"] = card_name(device)
    result = {"metric": HEADLINE, "value": fps, "unit": "frames/s",
              "vs_baseline": fps / BASELINE_FPS, "extra": extra}
    if errors:
        result["errors"] = errors
    return result


def _timings(fig: Figure, fig_run: Run) -> dict:
    times, timed = fig_run.times, len(fig_run.launches) * len(fig.frames)
    return {"events_ms_per_frame": (None if times[0][0] is None
                                    else [ev for ev, _ in times]),
            "host_ms_per_frame": [host for _, host in times],
            "launches_per_frame": {
                k: sum(p[k] for p in fig_run.launches) / timed
                for k in fig_run.launches[0]}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="bench.py's five figures on the port (BENCH_FRAMES "
                    "sets the orbit's frames, default 60)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu "
                             "(the plain versions, for the tests)")
    args = parser.parse_args(argv)
    result = run(args.device, int(os.environ.get("BENCH_FRAMES", "60")))
    print(json.dumps(result))
    return 1 if "error" in result else 0


if __name__ == "__main__":
    sys.exit(main())
