"""Run one cell of the benchmark once.

    python3 slambench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration and a traffic mix,
found by name under this folder (``spec.py``). The run:

1. builds and loads the port's kernel libraries (``build/`` in the
   checkout: only the first run in a checkout compiles), renders the
   traffic's frames on the card (``generator.py``), builds an
   ``AutoTracker`` of the configuration with the options its ``tracker``
   key and the traffic's give (loop closing and relocalization on in
   both), and feeds it the warm-up frames through ``process_<sensor>``;
   all of that is
   set-up (``setup_s``, from the process's start to the window's first
   frame);
2. feeds the tracker frame after frame from host memory, as fast as it
   takes them, for ``--seconds`` (or until the path ends, which it says on
   stderr), with a CUDA event after each frame and no readback of its own;
   the window ends with ``drain()``, an end event and ``sync()``;
   ``frames_per_s`` is every frame over the time between the start and
   end events;
3. with ``--trace 1``, traces ``trace_frames`` more frames under
   torch.profiler with spans round the tracker's layers (``tracing.py``),
   and reports the per-layer metrics (``metrics/``) instead of the
   end-to-end ones;
4. reads the trajectory back, frees the tracker, and decides ``correct``
   (``checks.py``) against ``limits/<workload>.json``.

It prints each compared number beside its limit as its last lines on
stderr, and one JSON object as the last line of stdout. Without a CUDA
device (or with fewer than the cell asks for), or if JAX or the JAX
package was loaded, it exits with a code other than 0 and prints no
result. Caches go inside the checkout (``build/``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from slambench import spec  # noqa: E402


def host_threads(argv: list) -> int | None:
    """The intra-op threads the cell's configuration deploys the tracker
    with (its ``host`` key), or None for the libraries' default."""
    try:
        name = argv[argv.index("--workload") + 1]
        cfg = spec.config(spec.workload(spec.benchmark(), name)["config"])
    except (ValueError, IndexError, KeyError, OSError):
        return None
    n = cfg.get("host", {}).get("intra_op_threads")
    return int(n) if n else None


if __name__ == "__main__":
    # set before OpenMP loads with torch
    THREADS = host_threads(sys.argv[1:])
    if THREADS:
        os.environ["OMP_NUM_THREADS"] = str(THREADS)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from slambench import checks, generator, tracing, window  # noqa: E402

PROGRAM = "orb_slam2_with_comment_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam2_with_comment_tpu")
KERNEL_LIBS = ("hamming", "pose_lm", "orb", "stereo_sad", "ba")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared as whole names."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


def tracker_config(cfg: dict):
    from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig
    from orb_slam2_with_comment_tpu_torch.pipeline.tracking import (
        TrackerConfig)
    rgbd = cfg["sensor"] == "rgbd"
    return TrackerConfig(
        sensor=cfg["sensor"], fx=cfg["Camera.fx"], fy=cfg["Camera.fy"],
        cx=cfg["Camera.cx"], cy=cfg["Camera.cy"], bf=cfg["Camera.bf"],
        width=int(cfg["Camera.width"]), height=int(cfg["Camera.height"]),
        n_features=int(cfg["ORBextractor.nFeatures"]),
        th_depth=cfg["ThDepth"], fps=cfg["Camera.fps"],
        map_cfg=MapConfig(**cfg["map"]),
        **({"min_init_features": int(cfg["Init.minFeatures"])}
           if "Init.minFeatures" in cfg else {}),
        depth_factor=1.0 / cfg["DepthMapFactor"] if rgbd else 1.0,
        dist=tuple(cfg.get(k, 0.0) for k in ("Camera.k1", "Camera.k2",
                                              "Camera.p1", "Camera.p2",
                                              "Camera.k3")))


def tracker_options(cfg: dict, traffic: dict) -> dict:
    """The AutoTracker's options: the configuration's ``tracker`` key, with
    the traffic's over it."""
    return dict(cfg.get("tracker", {}), **traffic.get("tracker", {}))


def launch_counts() -> dict:
    from orb_slam2_with_comment_tpu_torch.ops import hamming, orb, sad
    from orb_slam2_with_comment_tpu_torch.optim import ba, pose_opt
    return {"hamming": sum(hamming.LAUNCHES.values()),
            "orb": sum(orb.LAUNCHES.values()),
            "pose_lm": sum(pose_opt.LAUNCHES.values()),
            "stereo_sad": sum(sad.LAUNCHES.values()),
            "ba": sum(ba.LAUNCHES.values())}


def build_kernels() -> None:
    from orb_slam2_with_comment_tpu_torch.ops import (cuda_lib, hamming, orb,
                                                      sad)
    from orb_slam2_with_comment_tpu_torch.optim import ba, pose_opt
    cuda_lib.build_all(list(KERNEL_LIBS))
    for mod in (hamming, pose_opt, orb, sad, ba):
        mod._kernel_lib()


def steal_s() -> float | None:
    """Seconds the machine's CPUs waited for their host, over all of them
    (``/proc/stat``); None where it cannot be read."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return None


class HostClock:
    """What the process's host side did over a stretch: CPU seconds, context
    switches and the machine's steal time, read before and after, and the
    machine's load average at the start."""

    def __init__(self):
        self.r0, self.s0 = resource.getrusage(resource.RUSAGE_SELF), steal_s()
        self.load = os.getloadavg()[0]

    def report(self, wall_s: float) -> str:
        r, s = resource.getrusage(resource.RUSAGE_SELF), steal_s()
        steal = (f"{s - self.s0:.2f} s" if s is not None
                 and self.s0 is not None else "not read")
        return (f"user {r.ru_utime - self.r0.ru_utime:.3f} s, sys "
                f"{r.ru_stime - self.r0.ru_stime:.3f} s of {wall_s:.3f} s; "
                f"{r.ru_nvcsw - self.r0.ru_nvcsw} voluntary and "
                f"{r.ru_nivcsw - self.r0.ru_nivcsw} involuntary switches; "
                f"steal {steal} over {os.cpu_count()} CPUs; load "
                f"{self.load:.2f} at the start; "
                f"{torch.get_num_threads()} intra-op threads")


def card(device) -> str:
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


class Stamps:
    """The window's stamps: CUDA events on the card, the host clock on the
    CPU (the tests), in milliseconds."""

    def __init__(self, device, n: int):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.ev = [torch.cuda.Event(enable_timing=True)
                       for _ in range(n + 2)]
        self.host = [0.0] * (n + 2)

    def record(self, k: int) -> None:
        if self.cuda:
            self.ev[k].record()
        else:
            self.host[k] = 1000.0 * time.perf_counter()

    def ms(self, k: int) -> float:
        """Stamp k relative to stamp 0 (after a sync)."""
        if self.cuda:
            return self.ev[0].elapsed_time(self.ev[k])
        return self.host[k] - self.host[0]


class Run:
    """What the per-layer readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device, after_setup=None, overrides=None,
             control_dt=None, log=print) -> dict:
    """One run of ``cell``; returns the result's object. ``after_setup``
    (tests) is called with the tracker once set-up is done;
    ``overrides`` (tests) replaces keys of the configuration and the
    traffic. With ``control_dt`` (the
    control's test) the numbers are also worked out with the reference in
    that precision, under the result's ``control`` key."""
    from orb_slam2_with_comment_tpu_torch.matching import search as msearch
    from orb_slam2_with_comment_tpu_torch.ops import sad
    from orb_slam2_with_comment_tpu_torch.optim import ba, pose_opt
    from orb_slam2_with_comment_tpu_torch.pipeline import steps
    from orb_slam2_with_comment_tpu_torch.pipeline.auto import (
        AutoTracker, AutoTrackerConfig)
    device = torch.device(device)
    overrides = overrides or {}
    cfg = dict(spec.config(cell["config"]), **overrides.get("config", {}))
    traffic = dict(spec.traffic(cell["traffic"]),
                   **overrides.get("traffic", {}))
    limits = spec.limits(cell["name"])
    if device.type == "cuda":
        build_kernels()
    log(f"slambench: kernels ready at {time.perf_counter() - T_START:.3f} s")
    seq = generator.build(traffic, cfg, seed, device)
    log(f"slambench: {cell['name']} seed {seed}: rendered "
        f"{seq.n_stored} frames in {seq.render_s:.3f} s, "
        f"{seq.host_bytes / 2**20:.1f} MiB on the host")
    tracker = AutoTracker(tracker_config(cfg),
                          AutoTrackerConfig(**tracker_options(cfg, traffic)),
                          device=device)
    process = getattr(tracker, "process_" + cfg["sensor"])
    log(f"slambench: tracker built at {time.perf_counter() - T_START:.3f} s")

    def feed(i: int) -> None:
        process(*seq.frame(i))

    first = seq.warmup_frames
    for i in range(first):
        feed(i)
    tracker.sync()
    warm = tracker.state
    log(f"slambench: warm-up done at {time.perf_counter() - T_START:.3f} s: "
        f"{first} frames, {int(warm.map.n_kf)} keyframe "
        f"slots used, {warm.n_compact_kf} keyframe and {warm.n_compact_lm} "
        f"landmark compactions, lost at {warm.lost}")
    samples = checks.sample_frames(seed, first, int(traffic["sample_span"]),
                                   int(traffic["samples"]))
    cap = checks.Capture(tracker, pose_opt, ba, samples, steps, msearch)
    if after_setup is not None:
        after_setup(tracker)
    n_max = seq.window_frames_max
    stamps = Stamps(device, n_max)
    before = launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    host = HostClock()
    cpu = [0.0] * (n_max + 1)
    stamps.record(0)
    t0 = time.perf_counter()
    cpu[0] = time.thread_time()
    n = 0
    while n < n_max:
        feed(first + n)
        n += 1
        stamps.record(n)
        cpu[n] = time.thread_time()
        if time.perf_counter() - t0 >= seconds:
            break
    tracker.drain()
    stamps.record(n + 1)
    tracker.sync()
    host_s = time.perf_counter() - t0
    log(f"slambench: host in the window: {host.report(host_s)}")
    if n >= n_max:
        log(f"slambench: the window ended at the path's end: {n} frames in "
            f"{host_s:.3f} s of the {seconds} asked")
    window_ms = stamps.ms(n + 1)
    frame_stamps = [stamps.ms(k) for k in range(1, n + 1)]
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    fps = window.frames_per_s(n, window_ms)
    log(f"slambench: window {n} frames, {window_ms:.3f} ms by events, "
        f"{1000 * host_s:.3f} ms by the host clock, {fps:.4f} frames/s")
    iv = window.intervals_ms(0.0, frame_stamps)
    sums = [iv[k:k + 50].sum() for k in range(0, n - 49, 50)]
    log("slambench: frame ms p50 {:.3f} p95 {:.3f} max {:.3f}; frames/s a "
        "50-frame chunk: {}; the main thread's CPU share of each: {}".format(
            float(np.median(iv)), window.p95(iv), float(iv.max()),
            " ".join(f"{50000.0 / t:.2f}" for t in sums),
            " ".join(f"{1000.0 * (cpu[50 * c + 50] - cpu[50 * c]) / t:.2f}"
                     for c, t in enumerate(sums))))
    traced = None
    t_after = time.perf_counter()
    if trace:
        sad_work = []
        launched = launch_counts()
        with tracing.wrap_layers(tracker, steps), \
                tracing.count_sad_keypoints(sad, sad_work):
            traced = tracing.profile(feed, first + n,
                                     seq.trace_frames, tracker.sync)
        tracing.check_launches(traced, {
            k: v - launched[k] for k, v in launch_counts().items()})
        traced.sad_keypoints = tracing.sad_keypoints(sad_work, sad.TH_ORB)
    memory_peak = (torch.cuda.max_memory_reserved(device)
                   if device.type == "cuda" else 0)
    cap.remove()
    out = tracker.finalize()
    if len(out["valid"]) != out["n_frames"]:
        raise ValueError("the run outgrew the tracker's trajectory ring: "
                         "raise the traffic's tracker traj_capacity")
    del tracker, warm, process
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log("slambench: slowest frames (frame, ms, inserted, loops closed): "
        + ", ".join(f"({first + k}, {iv[k]:.1f}, {out['stats'][first + k, 6]}"
                    f", {out['stats'][first + k, 7]})"
                    for k in np.argsort(-iv)[:3]))
    valid = out["valid"][first:first + n]
    failed = int((~valid).sum())
    numbers = checks.compare(cap, seq, cfg, out, first, first + n,
                             int(traffic["rpe_step"]), device)
    correct, shown = checks.judge(numbers, limits)
    control = None
    if control_dt is not None:
        control = checks.compare(cap, seq, cfg, out, first, first + n,
                                 int(traffic["rpe_step"]), device,
                                 control_dt)
    log(f"slambench: trace and check took "
        f"{time.perf_counter() - t_after:.3f} s")
    run = Run(cfg=cfg, traffic=traffic, trace=traced, frames=n,
              intervals_ms=iv,
              launches=launches,
              inserted=int(out["stats"][first:first + n, 6].sum()))
    metrics = {}
    if trace:
        for m in spec.metrics_of(bench, cell["name"], "per_layer"):
            value = spec.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"frames_per_s": fps, "setup_s": setup_s}
        for m in spec.metrics_of(bench, cell["name"], "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": n, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in traced.top_ops],
            "idle_gaps": [[k, v] for k, v in traced.idle_by_span]}
    result["card"] = card(device)
    result["samples"] = {"frames": samples,
                         "ba_frames": [f for f, _ in cap.ba],
                         "rpe_mm": numbers["rpe_mm"],
                         "t_err_mm": numbers["t_err_mm"],
                         "rot_err_deg": numbers["rot_err_deg"],
                         "pose_checked": len(numbers["_pose_detail"]),
                         "pose_skipped": numbers["_pose_skipped"],
                         "pose_detail": numbers["_pose_detail"],
                         "search_detail": numbers["_search_detail"],
                         "ba_point_median_mm": numbers["_ba_point_median"]}
    if control is not None:
        result["control"] = checks.judge(control, limits)[1]
    result["checks"] = shown
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # caches at fixed paths inside the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "build", "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    threads = host_threads(["--workload", args.workload])
    if threads:
        torch.set_num_threads(threads)
    if not torch.cuda.is_available():
        print("slambench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"slambench: {cell['name']} needs {cell['chips']} CUDA "
              f"devices, {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(bench, cell, args.seed, args.seconds,
                      bool(args.trace), "cuda",
                      log=lambda s: print(s, file=sys.stderr, flush=True))
    leaked = forbidden_modules()
    if leaked:
        print(f"slambench: forbidden modules loaded: {leaked}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
