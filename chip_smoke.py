"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero without the final
``{"ok": true, ...}`` line):

1. Require CUDA; print the card's name and power limit (nvidia-smi), and the
   torch and CUDA versions. TF32 is switched off for matmuls and cuDNN.
   Every synthetic frame of the later phases is rendered here, in worker
   processes, before anything is timed.
2. Build the Hamming kernels from ``orb_slam2_with_comment_tpu_torch/csrc``
   (``hamming.cu``, and the package's first kernel ``hamming_v1.cu`` as the
   timing baseline; one nvcc each, started together) and print the build
   time and ptxas' register report.
3. Hold both kernel entry points against their plain PyTorch versions on the
   card, bit-exact: random 30% masks with ties, an all-masked and an
   all-admissible row at [300,257], [1000,1000], [8000,1000], [1024,8000]
   (the duplicate-landmark merge's grid), [4096,1000] (the loop closer's
   projection searches), [4096,2000] (the monocular local-map search),
   [2000,2000], [1241,999] (an odd row pitch), [37,1] and [1,5];
   stereo-like row-band masks (about 1% admissible) at [1000,1000],
   [2000,2000] and [1241,999]; an all-false and an all-true mask;
   descriptors that start off a 16-byte boundary; the monocular
   initialization window mask (100 px, level-0 features) of the first two
   orbit frames at [2000,2000]. The baseline
   kernel is held to the same results. Then time the kernel, the baseline
   kernel and the plain version at the main path's shapes: per wrapper call
   with CUDA events (the host's launch cost included) and per launch
   inside a replayed CUDA graph (the device's time alone), beside the
   bound computed from each problem's bytes and admissible pairs.
4. Run the RGB-D slice at the bench configuration (640x480, 1000 features,
   MapConfig(24, 1000, 8000, 8), loop_closing=False) over the 60-frame
   synthetic orbit, then re-track its first 30 frames once more (the whole
   orbit before the stereo phases came; cut to keep the run's time);
   assert initialization, no loss, every frame of both passes valid, the
   keyframe count, the pose error against ground truth, and that both
   kernels were launched.
5. Run a 16-frame reduced-size slice on the card and on the CPU (plain
   versions) and compare keyframe decisions and poses.
6. The default tracker, AutoTrackerConfig() (loop closing and
   relocalization on), at the bench configuration: the 60-frame orbit,
   3 black frames, then frames 2-4 again. Every build frame valid, the
   black frames invalid, the first revisit frame relocalized (stats column
   6 == 2) within 0.05 m of ground truth, not lost at the end, and no loop
   closed (the JAX package closes none on this sequence on the CPU: the
   orbit has no loop to close). Both kernels launch on the relocalization
   frame. Prints the tracker's build time (vocabulary load and the
   forward-mode AD warm-up), the ms of the frames that ran the
   loop-closing phase and
   of the relocalization frame, by stage on that first call and on a
   second call from the same state and random draws.
7. A controlled loop at full width (tests/test_auto_loop.py's scenario):
   640x480, 1000 features, MapConfig(20, 1000, 10000, 8), a 14-frame lap
   plus 4 frames, drift injected into the poses the map is told for
   keyframes 8-13, driven through keyframe_step + close_loop_step. A loop
   fires at a keyframe >= 10, the corrected keyframe's error falls below
   0.35 of its error before, keyframe 0 stays within 1e-3 m. Prints the ms
   of the close_loop_step that fires, by stage on that first call and on a
   second call from the same input and random draws.
8. Slot compaction with loop closing on, every frame valid and median
   error < 0.02 m: the landmark-pressure configuration of
   tests/test_auto.py (MapConfig(12, 1000, 2500, 8), the 40-frame orbit)
   compacts landmarks (n_compact_lm >= 1); the first 40 frames of the
   60-frame orbit with 2% depth noise (SyntheticWorld(seed=1,
   depth_noise=0.02)) at MapConfig(12, 1000, 8000, 8) compact keyframes
   (n_compact_kf >= 1). The noise keeps the tracked share low, so a
   keyframe is inserted at nearly every early frame, maintenance culls a
   redundant one, and the insert at frame 33 recycles its slot. The JAX
   package does the same on the CPU: inserts at frames 0-4, 6, 7, 9, 12,
   13, 16, 21 and 33, n_compact_kf = 1, median error 4.7 mm.
9. Stereo at the bench configuration (bench.py's stereo figure): 640x480,
   1000 features, bf = 40, fx = 500, MapConfig(24, 1000, 8000, 8), the
   60-frame orbit with the right view rendered at the 8 cm baseline, the
   default AutoTrackerConfig(), built, its first 20 frames re-tracked (the
   whole orbit before the monocular phase came), then the next 10 frames
   with stage timers. Initialized, never lost, every frame valid,
   at least 3 keyframes, median translation error < 0.03 m, more than 200
   features with depth on frame 0, one ``masked_best_two`` launch by the
   stereo association in every frame, and at least one launch per frame
   more than the default RGB-D tracker of phase 6 made over the same 60
   poses. Prints ms per frame and the stage times of the front end: both
   views' extraction, ``match_stereo`` and its ``_sad_refine`` part.
10. Stereo at the KITTI 00-02 camera (bench.py's KITTI-shape figure):
   1241x376, 2000 features, fx = fy = 718.856, cx = 607.1928,
   cy = 185.2157, bf = 386.1448, MapConfig(24, 2000, 8000, 8), fps = 10,
   30 frames, built, the first 10 re-tracked (all 30 before the monocular
   phase came), then the next 10 frames with stage timers. Initialized, not lost, every frame valid. Prints the same times
   and ``trajectory_kitti()``'s line count. (The scene stays well tracked
   from the first keyframe, so this run inserts no second one and its only
   kernel is ``masked_best_two``.)
11. Monocular at the bench configuration (bench.py's mono figure): 640x480,
   2000 features, min_init_features=200, min_init_matches=60,
   MapConfig(24, 2000, 8000, 8), fps=30, the default AutoTrackerConfig(),
   the 60 images of the orbit built then re-tracked once. Initialized,
   never lost, every frame after the bootstrap frame valid in both
   passes, at least 3 keyframes, similarity-aligned (scale + SE3) ATE
   below 0.03 m in either pass, the median scene depth of keyframe 0
   equal to 1 within 1e-3 right after the bootstrap, ``masked_best_two``
   launched by search_for_initialization and by search_for_triangulation,
   both kernels launched over the two passes. Prints the bootstrap frame,
   the number of two-view landmarks, whether H or F won, ms per frame of
   both passes and the stage times of the bootstrap frame. Both passes
   keep the newest inputs of every (calling function, shape) they gave
   either kernel; afterwards each of these problems, the local-map search
   at [4096,2000] among them, and the epipolar mask of the run's keyframes
   1 and 0 at [2000,2000] join phase 3: bit-exact against the plain
   version and the baseline kernel, and timed like the others. Last, the
   initializer runs on the card and on the CPU from the same matches and
   8-point sets (cuSOLVER against LAPACK): both succeed or both fail, and
   where they succeed the good points, rotation and translation direction
   agree.
12. Loop closing in maps of more than 64 keyframe slots: phase 7's
   controlled loop at MapConfig(96, 1000, 10000, 8) (the bounded edge
   list, the CG global BA) and at MapConfig(300, 1000, 10000, 8) (also the
   CG pose graph), with phase 7's gates; and at 300 once more with
   fix_scale=False on a monocular map whose keyframes 8-13 also drift in
   scale (2% a keyframe, up to 1.12), the lap revisited from 15 cm aside:
   there the corrected keyframes' scale returns to within 5% of 1 and the
   position error falls below 0.5 of its value (the JAX package on the
   same frames on the CPU: 0.450). Prints the stage times of the firing
   step, its edge count, its launches, and how far the same step run
   twice differs (index_add_ sums in no fixed order on the card).

    python3 chip_smoke.py --kernels-only

stops after phase 3 (a short run for work on the kernels; it prints no
``ok`` line).

The second-to-last line is a JSON object describing each kernel; the last
line is the JSON ``ok`` record.
"""
import concurrent.futures
import contextlib
import ctypes
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import torch

from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu_torch.evaluation.ate import (
    ate_rmse, camera_centers)
from orb_slam2_with_comment_tpu_torch.frontend import stereo
from orb_slam2_with_comment_tpu_torch.frontend.extractor import OrbExtractor
from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig, empty_map
from orb_slam2_with_comment_tpu_torch.matching import search as msearch
from orb_slam2_with_comment_tpu_torch.ops import cuda_lib, hamming
from orb_slam2_with_comment_tpu_torch.pipeline import auto_loop, steps
from orb_slam2_with_comment_tpu_torch.pipeline.auto import (
    AutoTracker, AutoTrackerConfig)
from orb_slam2_with_comment_tpu_torch.pipeline.tracking import TrackerConfig
from orb_slam2_with_comment_tpu_torch.place import vocabulary as V
from orb_slam2_with_comment_tpu_torch.solvers import initializer, pnp

BENCH_MAP = MapConfig(k_max=24, n_feat=1000, l_max=8000, d_max=8)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, launches: int = 20, reps: int = 10) -> float:
    """Mean ms per call of fn() inside a replayed CUDA graph of
    ``launches`` calls: the device's time, without the host's launch cost."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return cuda_ms(graph.replay, reps) / launches


def random_desc(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.randint(-2 ** 31, 2 ** 31, (n, 8), generator=gen,
                         dtype=torch.int64).to(torch.int32)


def planted_desc(gen: torch.Generator, q: int, n: int):
    """Query and target descriptors with planted duplicates (ties)."""
    dq, dt = random_desc(gen, q), random_desc(gen, n)
    if n > 4:
        dt[1::4] = dt[0::4][: dt[1::4].shape[0]]  # equal targets: ties
        dq[: min(q, n) // 2] = dt[: min(q, n) // 2]  # exact matches
    return dq, dt


def random_problem(gen: torch.Generator, q: int, n: int, dev):
    """A mask with ~30% admissible pairs, one all-masked row and one
    all-admissible row."""
    dq, dt = planted_desc(gen, q, n)
    mask = torch.rand((q, n), generator=gen) < 0.3
    mask[0] = False
    if q > 1:
        mask[1] = True
    return dq.to(dev), dt.to(dev), mask.to(dev)


def band_problem(gen: torch.Generator, q: int, n: int, dev):
    """A stereo-like mask: a target is admissible when its image row lies
    within 2.4 px of the query's on a 480-row image, about 1% of pairs."""
    dq, dt = planted_desc(gen, q, n)
    vq = 480.0 * torch.rand(q, generator=gen)
    vt = 480.0 * torch.rand(n, generator=gen)
    mask = (vq[:, None] - vt[None, :]).abs() <= 2.4
    return dq.to(dev), dt.to(dev), mask.to(dev)


class BaselineKernels:
    """The package's first Hamming kernels (csrc/hamming_v1.cu), loaded
    beside the current ones for the timing comparison only."""

    def __init__(self):
        self.lib = ctypes.CDLL(cuda_lib.build("hamming_v1"))
        p, i = ctypes.c_void_p, ctypes.c_int
        self.lib.hamming_distance_matrix.argtypes = [p, p, p, i, i, p]
        self.lib.hamming_distance_matrix.restype = i
        self.lib.hamming_masked_best_two.argtypes = [p, p, p, p, p, p, p, i,
                                                     i, p]
        self.lib.hamming_masked_best_two.restype = i

    def distance_matrix(self, d1, d2):
        out = torch.empty((d1.shape[0], d2.shape[0]), dtype=torch.int32,
                          device=d1.device)
        err = self.lib.hamming_distance_matrix(
            d1.data_ptr(), d2.data_ptr(), out.data_ptr(), d1.shape[0],
            d2.shape[0], torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return out

    def masked_best_two(self, dq, dt, mask):
        q = dq.shape[0]
        outs = torch.empty((4, q), dtype=torch.int32, device=dq.device)
        err = self.lib.hamming_masked_best_two(
            dq.data_ptr(), dt.data_ptr(), mask.data_ptr(),
            *(outs.data_ptr() + 4 * q * i for i in range(4)), q,
            dt.shape[0], torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return tuple(outs.unbind(0))


def popc_per_s() -> float:
    """The card's peak popc rate: 16 results per clock on each SM
    (NVIDIA's table of arithmetic instruction throughput for compute
    capability 9.0) at the card's highest SM clock."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 16.0 * sms * float(mhz) * 1e6


HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def bound(n_bytes: int, n_popc: int, popc_rate: float):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the popcounts over the popc rate."""
    by_bytes = 1000.0 * n_bytes / HBM_BYTES_PER_S
    by_ops = 1000.0 * n_popc / popc_rate
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def bound_best_two(dq, dt, mask, popc_rate):
    """Each input read once (mask bytes, descriptors), the four [Q] outputs
    written once; 8 popc for every admissible pair of this mask."""
    q, n = mask.shape
    return bound(q * n + 32 * (q + n) + 16 * q, 8 * int(mask.sum()),
                 popc_rate)


def bound_distance_matrix(n1, n2, popc_rate):
    return bound(32 * (n1 + n2) + 4 * n1 * n2, 8 * n1 * n2, popc_rate)


def time_pair(new, old, plain, plain_reps: int = 5) -> dict:
    """Times of the kernel and the baseline kernel in turns (new, old,
    new, old; the mean of each), and the plain version's."""
    out = {"ms": 0.0, "device_ms": 0.0, "prev_ms": 0.0, "prev_device_ms": 0.0}
    for _ in range(2):
        out["ms"] += cuda_ms(new, 50) / 2
        out["prev_ms"] += cuda_ms(old, 50) / 2
        out["device_ms"] += graph_ms(new) / 2
        out["prev_device_ms"] += graph_ms(old) / 2
    out["plain_ms"] = cuda_ms(plain, plain_reps)
    return out


def assert_same(name, got, want, where):
    err = 0
    for part, a, b in zip(("best", "idx", "second", "idx2"), got, want):
        e = int((a.long() - b.long()).abs().max()) if a.numel() else 0
        assert e == 0, f"{name} {part} differs at {where}: {e}"
        err = max(err, e)
    return err


def check_kernels(dev):
    """Phase 3: bit-exact comparison and timing. Returns per-kernel rows."""
    gen = torch.Generator().manual_seed(0)
    base = BaselineKernels()
    problems = [(f"random [{q},{n}]", random_problem(gen, q, n, dev))
                for q, n in ((300, 257), (1000, 1000), (8000, 1000),
                             (1024, 8000), (4096, 1000), (4096, 2000),
                             (2000, 2000), (1241, 999), (37, 1), (1, 5))]
    problems += [(f"band [{q},{n}]", band_problem(gen, q, n, dev))
                 for q, n in ((1000, 1000), (2000, 2000), (1241, 999))]
    dq, dt = (d.to(dev) for d in planted_desc(gen, 1000, 1000))
    for name, fill in (("all-false", False), ("all-true", True)):
        problems.append((f"{name} [1000,1000]", (dq, dt, torch.full(
            (1000, 1000), fill, dtype=torch.bool, device=dev))))
    # descriptors that start 4 bytes off a 16-byte boundary
    dq, dt, mask = random_problem(gen, 301, 130, dev)
    off = [torch.cat([d.new_zeros(1), d.reshape(-1)])[1:].view(-1, 8)
           for d in (dq, dt)]
    assert all(d.data_ptr() % 16 for d in off)
    problems.append(("unaligned [301,130]", (off[0], off[1], mask)))
    # the monocular initialization window of two orbit frames
    f1, f2 = mono_first_two(dev)
    init_window = (f1.desc, f2.desc, msearch.initialization_mask(f1, f2,
                                                                 f1.xy))
    assert init_window[2].shape == (2000, 2000)
    problems.append(("initialization window [2000,2000]", init_window))
    err_bt = err_dm = 0
    for where, (dq, dt, mask) in problems:
        want = hamming.masked_best_two_plain(dq, dt, mask)
        err_bt = max(err_bt, assert_same(
            "masked_best_two", hamming.masked_best_two(dq, dt, mask), want,
            where))
        assert_same("baseline masked_best_two",
                    base.masked_best_two(dq.contiguous(), dt.contiguous(),
                                         mask), want, where)
        want = hamming.distance_matrix_plain(dq, dt)
        e = int((hamming.distance_matrix(dq, dt) - want).abs().max())
        assert e == 0, f"distance_matrix differs at {where}: {e}"
        err_dm = max(err_dm, e)
        assert torch.equal(base.distance_matrix(dq.contiguous(),
                                                dt.contiguous()), want)
        log(f"kernel check {where}: bit-exact ("
            f"{float(mask.float().mean()):.4f} admissible)")
    torch.cuda.synchronize()

    popc_rate = popc_per_s()
    log(f"bounds: {HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
        f"{popc_rate / 1e12:.3f} T popc/s")
    timed = []
    for where, (dq, dt, mask) in (
            ("random [8000,1000]", random_problem(gen, 8000, 1000, dev)),
            ("random [4096,1000]", random_problem(gen, 4096, 1000, dev)),
            ("random [4096,2000]", random_problem(gen, 4096, 2000, dev)),
            ("initialization window [2000,2000]", init_window),
            ("band [1000,1000]", band_problem(gen, 1000, 1000, dev)),
            ("band [2000,2000]", band_problem(gen, 2000, 2000, dev)),
            ("band [8000,1000]", band_problem(gen, 8000, 1000, dev))):
        row = time_pair(lambda: hamming.masked_best_two(dq, dt, mask),
                        lambda: base.masked_best_two(dq, dt, mask),
                        lambda: hamming.masked_best_two_plain(dq, dt, mask))
        row["bound_ms"], row["bound_by"] = bound_best_two(dq, dt, mask,
                                                          popc_rate)
        row["problem"] = where
        row["admissible"] = float(mask.float().mean())
        timed.append(row)
        log(f"masked_best_two {where}: " + fmt_times(row))
    timed_dm = []
    for n1, n2 in ((1024, 8000), (2000, 2000), (1000, 1000)):
        d1, d2 = random_desc(gen, n1).to(dev), random_desc(gen, n2).to(dev)
        row = time_pair(lambda: hamming.distance_matrix(d1, d2),
                        lambda: base.distance_matrix(d1, d2),
                        lambda: hamming.distance_matrix_plain(d1, d2))
        row["bound_ms"], row["bound_by"] = bound_distance_matrix(n1, n2,
                                                                 popc_rate)
        row["problem"] = f"[{n1},{n2}]"
        timed_dm.append(row)
        log(f"distance_matrix [{n1},{n2}]: " + fmt_times(row))
    src = "orb_slam2_with_comment_tpu_torch/csrc/hamming.cu"
    pallas = "orb_slam2_with_comment_tpu/ops/hamming_pallas.py:59"
    # no single PyTorch call computes either function: library_ms is null
    return [
        dict(timed[0], name="hamming_masked_best_two", route="cuda",
             source=src, replaces=pallas, max_abs_err=err_bt,
             library_ms=None, other_problems=timed[1:]),
        dict(timed_dm[0], name="hamming_distance_matrix", route="cuda",
             source=src, replaces=pallas, max_abs_err=err_dm,
             library_ms=None, other_problems=timed_dm[1:]),
    ]


def fmt_times(row: dict) -> str:
    return (f"kernel {row['ms']:.4f} ms per call, {row['device_ms']:.4f} ms "
            f"on the device; baseline kernel {row['prev_ms']:.4f} and "
            f"{row['prev_device_ms']:.4f}; plain {row['plain_ms']:.4f}; "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}")


def reset_launches():
    for k in hamming.LAUNCHES:
        hamming.LAUNCHES[k] = 0


def bench_cfg(map_cfg=BENCH_MAP):
    """The bench configuration (bench.py:74-77)."""
    return TrackerConfig(n_features=1000, min_init_features=200,
                         map_cfg=map_cfg, fps=30, depth_factor=1.0 / 5000.0)


def synced_ms(fn) -> float:
    """Host-clock ms of fn() between two device syncs."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)  # a rehearsal of a phase on the CPU
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return 1000 * (time.perf_counter() - t0)


REDUCED_CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320,
                   height=240)
KITTI_CAM = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                 width=1241, height=376)  # Examples/Stereo/KITTI00-02.yaml
KITTI_BF = 386.1448
BENCH_BASELINE = 40.0 / 500.0  # bf / fx of the bench configuration
MONO_SEQ = "orbit60"  # the sequence phase 11 tracks (its images only)


def right_view(poses, baseline: float):
    """The poses of a right camera ``baseline`` metres along the x axis."""
    shift = np.array([baseline, 0, 0], np.float32)
    return [(R, np.asarray(t, np.float32) - shift) for R, t in poses]


def sequences() -> dict:
    """Every synthetic sequence the phases track, by name: (depth noise,
    poses, camera, what a frame holds: "rgbd" = (uint8 image, uint16 depth
    at 5000 per metre), "image" = uint8 image, "raw" = the renderer's
    float image and depth)."""
    orbit60 = orbit_trajectory(n_frames=60)
    lap = orbit_trajectory(n_frames=14)
    kitti30 = orbit60[:30]
    return {
        "orbit60": (0.0, orbit60, {}, "rgbd"),
        "orbit60_right": (0.0, right_view(orbit60, BENCH_BASELINE), {},
                          "image"),
        "reduced16": (0.0, orbit_trajectory(n_frames=16), REDUCED_CAM,
                      "rgbd"),
        "loop18": (0.0, lap + lap[:4], {}, "raw"),
        # the same lap, revisited from 15 cm to the right: a Sim3 between
        # two keyframes at one camera center leaves its scale unobservable
        "loop18_shifted": (0.0, lap + right_view(lap[:4], 0.15), {}, "raw"),
        "pressure40": (0.0, orbit_trajectory(n_frames=40), {}, "rgbd"),
        "noisy40": (0.02, orbit60[:40], {}, "rgbd"),
        "kitti30_left": (0.0, kitti30, KITTI_CAM, "image"),
        "kitti30_right": (0.0, right_view(
            kitti30, KITTI_BF / KITTI_CAM["fx"]), KITTI_CAM, "image"),
    }


def render_job(job):
    """Render one sequence, in order, from one SyntheticWorld(seed=1)."""
    noise, poses, cam, kind = job
    world = SyntheticWorld(seed=1, depth_noise=noise)
    out = []
    for R, t in poses:
        img, depth = world.render(R, t, **cam)
        if kind == "raw":
            out.append((img, depth))
            continue
        img = np.clip(img, 0, 255).astype(np.uint8)
        out.append(img if kind == "image" else (
            img, np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)))
    return out


_FRAMES: dict = {}


def frames_of(name: str):
    """A sequence's frames: rendered by render_all, or here on first use
    (a rehearsal of one phase)."""
    if name not in _FRAMES:
        _FRAMES[name] = render_job(sequences()[name])
    return _FRAMES[name]


def first_frames(name: str, n: int):
    """The first ``n`` frames of a sequence without depth noise: of the
    rendered ones, or rendered here alone (the kernels-only run renders
    nothing else)."""
    if name in _FRAMES:
        return _FRAMES[name][:n]
    noise, poses, cam, kind = sequences()[name]
    assert noise == 0.0, "a noisy sequence draws from one stream, in order"
    return render_job((noise, poses[:n], cam, kind))


def render_all(workers: int, chunk: int = 5, names=None):
    """Render every sequence (or those in ``names``) in ``workers``
    processes (a render takes longer than a tracked frame). Sequences
    without depth noise are cut into chunks; the noisy one draws from one
    random stream, in order."""
    jobs = []
    todo = {k: v for k, v in sequences().items()
            if names is None or k in names}
    for name, (noise, poses, cam, kind) in todo.items():
        step = len(poses) if noise > 0 else chunk
        jobs += [(name, i, (noise, poses[i:i + step], cam, kind))
                 for i in range(0, len(poses), step)]
    # the longest jobs first: the noisy sequence is one job of 40 frames
    jobs.sort(key=lambda j: -len(j[2][1]) * j[2][2].get("width", 640))
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers,
                                                mp_context=ctx) as pool:
        parts = list(pool.map(render_job, [job for _, _, job in jobs]))
    done = sorted(zip(jobs, parts), key=lambda jp: jp[0][:2])
    for name in todo:
        _FRAMES[name] = [f for (n, _, _), part in done if n == name
                         for f in part]


def pose_errors(out, poses, offset=0):
    n = len(poses)
    t_err = [np.linalg.norm(out["t"][offset + i] - poses[i][1])
             for i in range(n)]
    r_err = [np.degrees(np.arccos(np.clip(
        (np.trace(out["R"][offset + i] @ poses[i][0].T) - 1) / 2, -1, 1)))
        for i in range(n)]
    return float(np.median(t_err)), float(np.median(r_err))


def timed_pass(process, frames):
    """(CUDA-event ms, host-clock ms) per frame of process(frame) over
    ``frames``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for frame in frames:
        process(frame)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (start.elapsed_time(end) / len(frames),
            1000 * wall / len(frames))


def run_slice(dev):
    """Phase 4: the full-width RGB-D slice, counted launches, timed passes."""
    n, n_again = 60, 30
    poses = orbit_trajectory(n_frames=n)
    frames = frames_of("orbit60")
    tracker = AutoTracker(bench_cfg(), AutoTrackerConfig(
        traj_capacity=8 * n, loop_closing=False), device=dev)
    reset_launches()
    for k, count in enumerate((n, n_again)):
        ms, wall = timed_pass(lambda f: tracker.process_rgbd(*f),
                              frames[:count])
        log(f"slice pass {k + 1} ({count} frames): {ms:.3f} ms/frame (CUDA "
            f"events), {wall:.3f} ms/frame (host clock)")
    launches = dict(hamming.LAUNCHES)
    out = tracker.finalize()
    log(f"slice: initialized={out['initialized']} lost_at={out['lost_at']} "
        f"valid={int(out['valid'].sum())}/{n + n_again} keyframes="
        f"{out['n_keyframes']} inserted at "
        f"{np.nonzero(out['stats'][:, 6])[0].tolist()} launches={launches}")
    assert out["initialized"] and out["lost_at"] == -1, "tracking lost"
    assert out["valid"].shape == (n + n_again,) and out["valid"].all(), \
        "not every frame of both passes valid"
    assert 3 <= out["n_keyframes"] <= 24, out["n_keyframes"]
    for p, count in enumerate((n, n_again)):
        t_med, r_med = pose_errors(out, poses[:count], offset=p * n)
        log(f"pass {p + 1}: median t err {t_med:.5f} m, rot err "
            f"{r_med:.4f} deg")
        assert t_med < 0.02 and r_med < 1.0, "pose error gate"
    for name, count in launches.items():
        assert count > 0, f"kernel {name} never launched on the main path"
    return launches


def compare_devices(dev):
    """Phase 5: the reduced slice on the card against the plain CPU run."""
    cam = REDUCED_CAM
    frames = frames_of("reduced16")
    outs = []
    for device in (dev, "cpu"):
        cfg = TrackerConfig(
            **cam, bf=20.0, n_features=500, min_init_features=100, fps=30,
            depth_factor=1.0 / 5000.0,
            map_cfg=MapConfig(k_max=8, n_feat=500, l_max=3000, d_max=8))
        tr = AutoTracker(cfg, AutoTrackerConfig(loop_closing=False),
                         device=device)
        for img, depth in frames:
            tr.process_rgbd(img, depth)
        outs.append(tr.finalize())
    gpu, cpu = outs
    ins_g = np.nonzero(gpu["stats"][:, 6])[0].tolist()
    ins_c = np.nonzero(cpu["stats"][:, 6])[0].tolist()
    dt = float(np.abs(gpu["t"] - cpu["t"]).max())
    log(f"card vs cpu (reduced slice): inserts {ins_g} vs {ins_c}, "
        f"valid {int(gpu['valid'].sum())} vs {int(cpu['valid'].sum())}, "
        f"max |t| diff {dt:.2e} m")
    assert ins_g == ins_c and (gpu["valid"] == cpu["valid"]).all()
    assert dt < 1e-3, "card and CPU poses differ"


def run_default(dev):
    """Phase 6: AutoTrackerConfig() at the bench configuration, with a
    kidnap (3 black frames) and a revisit that must relocalize."""
    n = 60
    poses = orbit_trajectory(n_frames=n)
    frames = frames_of("orbit60")
    black = (np.zeros((480, 640), np.uint8), np.zeros((480, 640), np.uint16))
    seq = frames + [black] * 3 + frames[2:5]
    r = n + 3  # the first revisit frame
    box = {}
    ctor_ms = synced_ms(lambda: box.setdefault("t", AutoTracker(
        bench_cfg(), AutoTrackerConfig(), device=dev)))
    tracker = box["t"]
    log(f"default tracker: built in {ctor_ms:.2f} ms (the vocabulary's "
        f"load and the forward-mode AD warm-up, the first in this run)")
    n_phases = len(tracker._step.maint_phases)
    assert n_phases == 7, "loop closing is not the seventh phase"
    reset_launches()
    loop_ms, build_ms = [], []
    for i, (img, depth) in enumerate(seq):
        s = tracker.state
        may_loop = (s.initialized and s.lost < 0 and s.maint_kf >= 0
                    and s.maint_phase == n_phases - 1)
        before, gen_state = dict(hamming.LAUNCHES), s.loop.gen.get_state()
        with stage_ms(*(RELOC_STAGES if i == r else ())) as cold:
            ms = synced_ms(lambda: tracker.process_rgbd(img, depth))
        if may_loop and tracker.state.maint_kf < 0:  # ph_loop ran
            loop_ms.append(ms)
        if i < n:
            build_ms.append(ms)
            build_launches = dict(hamming.LAUNCHES)
        if i == r:
            reloc_ms, reloc_cold = ms, cold
            reloc_launches = {k: hamming.LAUNCHES[k] - before[k]
                              for k in before}
            # the same frame again from the same state: the warm cost
            reloc_warm = warm_rerun(lambda: tracker._step(
                s, torch.as_tensor(img, device=dev),
                torch.as_tensor(depth.astype(np.int32), device=dev)),
                s.loop.gen, gen_state, RELOC_STAGES)
    launches = dict(hamming.LAUNCHES)
    out = tracker.finalize()
    t_err = float(np.linalg.norm(out["t"][r] - poses[2][1]))
    log(f"default tracker: valid={int(out['valid'].sum())}/{len(seq)} "
        f"keyframes={out['n_keyframes']} lost_at={out['lost_at']} "
        f"loops={out['n_loops_closed']} reloc frame {r}: stats "
        f"{out['stats'][r].tolist()} t err {t_err:.5f} m")
    log(f"default tracker: build frames median {np.median(build_ms):.2f} "
        f"ms; ph_loop frames {[round(v, 2) for v in loop_ms]} ms; "
        f"relocalization frame {reloc_ms:.2f} ms (host clock, synced)")
    log(f"default tracker: relocalization frame by stage (ms, synced): "
        f"first {reloc_cold}, again {reloc_warm}")
    log(f"default tracker launches: run {launches}, the {n} build frames "
        f"{build_launches}, relocalization frame {reloc_launches}")
    assert out["valid"][:n].all(), "a build frame is invalid"
    assert not out["valid"][n:r].any(), "a black frame is valid"
    assert out["valid"][r:].all() and out["stats"][r, 6] == 2, \
        "did not relocalize at the first revisit frame"
    assert t_err < 0.05, "relocalized pose error"
    assert out["lost_at"] == -1
    assert out["n_loops_closed"] == 0, "the JAX package closes no loop here"
    assert loop_ms, "no frame ran the loop-closing phase"
    assert reloc_launches["masked_best_two"] > 0
    for name, count in launches.items():
        assert count > 0, f"kernel {name} never launched on the main path"
    return launches, build_launches


@contextlib.contextmanager
def stage_ms(*targets):
    """Within the block, each (module, function name) of ``targets`` adds
    the synced host-clock ms of its calls to the yielded dict (nested
    stages count in their callers too)."""
    out = {}

    def timed(name, fn):
        def run(*a, **kw):
            box = {}
            ms = synced_ms(lambda: box.setdefault("r", fn(*a, **kw)))
            out[name] = round(out.get(name, 0.0) + ms, 2)
            return box["r"]
        return run

    saved = [getattr(mod, name) for mod, name in targets]
    try:
        for (mod, name), fn in zip(targets, saved):
            setattr(mod, name, timed(
                f"{mod.__name__.rsplit('.', 1)[-1]}.{name}", fn))
        yield out
    finally:
        for (mod, name), fn in zip(targets, saved):
            setattr(mod, name, fn)


RELOC_STAGES = ((steps, "extract_rgbd_features"), (V, "transform"),
                (msearch, "search_brute"), (pnp, "solve_ransac"),
                (steps, "_pose_optimize_from_matches"),
                (steps, "track_local_map"))
LOOP_STAGES = ((auto_loop, "add_keyframe_bow"), (auto_loop, "detect"),
               (auto_loop, "sim3_solve"),
               (auto_loop.sim3solver, "solve_ransac"),
               (auto_loop, "sim3_grow_matches"),
               (auto_loop.sim3_opt, "optimize_sim3"),
               (auto_loop, "sim3_accept_gate"), (auto_loop, "correct_loop"),
               (steps, "loop_search_and_fuse"),
               (auto_loop.pose_graph, "optimize_pose_graph"),
               (auto_loop.pose_graph, "optimize_pose_graph_cg"),
               (auto_loop.ba, "ba_solve"), (auto_loop.ba, "ba_solve_cg"))


def warm_rerun(fn, gen: torch.Generator, gen_state, stages) -> dict:
    """fn() once more with the generator rewound to ``gen_state``, timed
    by stage; the generator and the launch counts are left as they were."""
    after, counts = gen.get_state(), dict(hamming.LAUNCHES)
    gen.set_state(gen_state)
    with stage_ms(*stages) as out:
        fn()
    gen.set_state(after)
    hamming.LAUNCHES.update(counts)
    return out


LOOP_MAP = MapConfig(k_max=20, n_feat=1000, l_max=10000, d_max=8)


def run_controlled_loop(dev, map_cfg=LOOP_MAP, fix_scale=True,
                        label="controlled loop", seq="loop18",
                        drift_gate=0.35):
    """Phases 7 and 12: tests/test_auto_loop.py's controlled loop at full
    width, through keyframe_step + close_loop_step. With fix_scale=False
    the map is monocular (no right coordinates; its landmarks still come
    from the depth image) and keyframes 8-13 also drift in scale, 2% a
    keyframe up to 1.12, as a monocular map drifts: the depths a keyframe
    is given, and its step from the keyframe before it, are multiplied by
    its scale. The keyframes after them keep that scale. ``seq`` names
    the 18 frames: the free-scale run takes the lap revisited from 15 cm
    aside ("loop18_shifted"), because a revisit from the very same camera
    center makes the Sim3's scale unobservable to its refinement."""
    cfg = TrackerConfig(n_features=1000, min_init_features=200,
                        map_cfg=map_cfg, fps=30, depth_factor=1.0)
    poses = sequences()[seq][1]
    rendered = frames_of(seq)
    ext = OrbExtractor(n_features=1000)
    voc = V.load_default_vocabulary(dev)
    auto_loop.warm_up_autodiff()  # as AutoTracker does (cheap after it)
    cam = cfg.cam
    th_depth = float(np.float32(cfg.depth_threshold))
    m = empty_map(cfg.map_cfg, dev)
    loop = auto_loop.empty_loop_carry(cfg.map_cfg.k_max, 1000, dev)
    drift = np.zeros(3, np.float32)
    scale, scales, center, center_told = 1.0, [], None, None
    events, err_before, fire_ms, stages = [], None, None, {}
    n_edges = []
    edges_fn = auto_loop._essential_edges

    def counted_edges(*a, **kw):
        out = edges_fn(*a, **kw)
        n_edges.append((int(out[2].sum()), out[2].numel()))
        return out

    def kf_scale(m, k):
        """Median ratio of keyframe k's landmark depths in the map to the
        depths the camera measured there."""
        lm = m.kf_lm[k]
        safe = lm.clamp(min=0).long()
        has = (lm >= 0) & m.lm_valid[safe] & (m.kf_depth[k] > 0)
        z = m.lm_pw[safe] @ m.kf_R[k][2] + m.kf_t[k][2]
        return float((z / (m.kf_depth[k] / scales[k]))[has].median())

    reset_launches()
    for k, (R, t) in enumerate(poses):
        img, depth = rendered[k]
        feats, d = steps.extract_rgbd_features(
            ext, cam, torch.as_tensor(np.clip(img, 0, 255).astype(
                np.float32), device=dev),
            torch.as_tensor(depth, device=dev), 1.0, cfg.width, cfg.height)
        if 8 <= k < 14:
            drift = drift + np.float32([0.015, 0.0, 0.008])
            if not fix_scale:
                scale += 0.02
        scales.append(scale)
        t_told = t + drift
        if not fix_scale:
            feats = feats._replace(ur=torch.full_like(feats.ur, -1.0))
            d = torch.where(d > 0, d * np.float32(scale), d)
            c = -R.T @ t
            center_told = c if k == 0 else (
                center_told + np.float32(scale) * (c - center))
            center = c
            t_told = (-R @ center_told + drift).astype(np.float32)
        obs = steps.FrameObs(feats, d, torch.full(
            (d.shape[0],), -1, dtype=torch.int32, device=dev))
        m = steps.keyframe_step(
            m, cam, obs, torch.as_tensor(R, device=dev),
            torch.as_tensor(t_told, device=dev), k, th_depth, cfg.width,
            cfg.height)
        n_before = loop.n_loops
        if err_before is None:
            err_now = float(np.linalg.norm(m.kf_t[k].cpu().numpy()
                                           - poses[k][1]))
            scale_now = kf_scale(m, k)
        box = {}

        def close(loop=loop, m=m, k=k):
            box["r"] = auto_loop.close_loop_step(
                loop, m, cam, k, voc, fix_scale=fix_scale, width=cfg.width,
                height=cfg.height)

        gen_state = loop.gen.get_state()
        before_close = dict(hamming.LAUNCHES)
        auto_loop._essential_edges = counted_edges
        try:
            with stage_ms(*LOOP_STAGES) as cold:
                ms = synced_ms(close)
        finally:
            auto_loop._essential_edges = edges_fn
        m, loop = box["r"]
        if loop.n_loops > n_before:
            events.append(k)
            if err_before is None:
                err_before, fire_ms, stages = err_now, ms, {"first": cold}
                fire_launches = {k: v - before_close[k]
                                 for k, v in hamming.LAUNCHES.items()}
                scale_before = scale_now
                # the same step again from the same input and draws
                stages["again"] = warm_rerun(close, loop.gen, gen_state,
                                             LOOP_STAGES)
                # index_add_ sums in no fixed order on the card: what the
                # same step from the same input and draws gives twice
                again = box["r"][0]
                rerun_diff = (float((again.kf_t - m.kf_t).abs().max()),
                              float((again.lm_pw - m.lm_pw).abs().max()))
    launches = dict(hamming.LAUNCHES)
    assert events, "no loop closed over a perfect revisit"
    k0 = events[0]
    err_after = float(np.linalg.norm(m.kf_t[k0].cpu().numpy() - poses[k0][1]))
    anchor = float(np.abs(m.kf_t[0].cpu().numpy() - poses[0][1]).max())
    log(f"{label} (k_max {map_cfg.k_max}, fix_scale={fix_scale}): fired at "
        f"keyframes {events}, error {err_before:.5f} -> {err_after:.5f} m, "
        f"keyframe 0 moved {anchor:.2e} m, the firing close_loop_step took "
        f"{fire_ms:.2f} ms (host clock, synced), its essential graph has "
        f"{n_edges[0][0]} valid edges of {n_edges[0][1]} listed; launches "
        f"{launches}, of them in the firing step {fire_launches}")
    log(f"{label}: the firing step by stage (ms, synced): {stages}")
    log(f"{label}: the firing step run twice differs by {rerun_diff[0]:.2e} m"
        f" on keyframe translations, {rerun_diff[1]:.2e} m on landmarks")
    if not fix_scale:
        after = {k: round(kf_scale(m, k), 4) for k in range(8, k0 + 1)}
        log(f"{label}: scale of keyframe {k0}'s landmarks {scale_before:.4f} "
            f"-> {after[k0]:.4f}; keyframes 8-{k0} after: {after}")
    assert k0 >= 10 and err_before > (0.05 if fix_scale else 0.03)
    assert err_after < drift_gate * err_before, \
        "loop correction did not reduce drift"
    assert anchor < 1e-3, "keyframe 0 moved"
    assert torch.isfinite(m.kf_t).all() and torch.isfinite(m.lm_pw).all()
    if not fix_scale:
        assert abs(scale_before - 1.0) > 0.08, "no scale error was injected"
        assert all(abs(v - 1.0) < 0.05 for v in after.values()), \
            "the corrected keyframes' scale is not back within 5% of 1"
    for name, count in launches.items():
        assert count > 0, f"kernel {name} never launched on the loop path"
    return launches, fire_ms


def run_compaction(dev):
    """Phase 8: landmark and keyframe slot compaction with loop closing
    on."""
    results = {}
    for name, map_cfg, seq, key in (
            ("landmark pressure", MapConfig(12, 1000, 2500, 8), "pressure40",
             "n_compact_lm"),
            ("noisy depth", MapConfig(12, 1000, 8000, 8), "noisy40",
             "n_compact_kf")):
        poses = sequences()[seq][1]
        frames = frames_of(seq)
        tracker = AutoTracker(bench_cfg(map_cfg), AutoTrackerConfig(
            traj_capacity=len(frames)), device=dev)
        reset_launches()
        for img, depth in frames:
            tracker.process_rgbd(img, depth)
        launches = dict(hamming.LAUNCHES)
        out = tracker.finalize()
        t_med, r_med = pose_errors(out, poses)
        log(f"compaction ({name}): n_compact_lm={out['n_compact_lm']} "
            f"n_compact_kf={out['n_compact_kf']} "
            f"valid={int(out['valid'].sum())}/{len(frames)} keyframe slots "
            f"{out['n_keyframes']} inserted at "
            f"{np.nonzero(out['stats'][:, 6] == 1)[0].tolist()} median t err "
            f"{t_med:.5f} m, rot err {r_med:.4f} deg; launches {launches}")
        assert out[key] >= 1, f"{key} == 0"
        assert out["valid"].all() and out["lost_at"] == -1
        assert t_med < 0.02, "pose error gate"
        results[name] = launches
    return results


STEREO_STAGES = ((OrbExtractor, "stereo"),
                 (OrbExtractor, "_pyramid"),
                 (OrbExtractor, "_extract_from_pyramid"),
                 (stereo, "match_stereo"), (stereo, "association_mask"),
                 (stereo, "_sad_refine"))


def run_stereo(dev, label, cfg, pairs, poses, n_again, n_staged=10):
    """Phases 9 and 10: the default tracker on rectified pairs, built, its
    first ``n_again`` frames re-tracked, then the ``n_staged`` frames after
    them with stage timers. Returns (first pass launches, finalize()'s
    result, the tracker)."""
    n = len(pairs)
    # frame 0's features with depth, outside the counted run
    feats, sd = OrbExtractor(n_features=cfg.n_features).stereo(
        *(torch.as_tensor(im, device=dev) for im in pairs[0]), cfg.bf, cfg.fx)
    n_depth0 = int(((sd.depth > 0) & feats.valid).sum())
    tracker = AutoTracker(cfg, AutoTrackerConfig(traj_capacity=8 * n),
                          device=dev)
    reset_launches()
    # the stereo association's own launches, one per frame
    match_launches = []
    match_stereo = stereo.match_stereo

    def counted_match(*a, **kw):
        before = hamming.LAUNCHES["masked_best_two"]
        out = match_stereo(*a, **kw)
        match_launches.append(hamming.LAUNCHES["masked_best_two"] - before)
        return out

    stereo.match_stereo = counted_match
    try:
        build = timed_pass(lambda p: tracker.process_stereo(*p), pairs)
        first_launches = dict(hamming.LAUNCHES)
        again = timed_pass(lambda p: tracker.process_stereo(*p),
                           pairs[:n_again])
    finally:
        stereo.match_stereo = match_stereo
    with stage_ms(*STEREO_STAGES) as staged:
        for pair in pairs[n_again:n_again + n_staged]:
            tracker.process_stereo(*pair)
    out = tracker.finalize()
    t_med, r_med = pose_errors(out, poses)
    log(f"{label}: initialized={out['initialized']} lost_at={out['lost_at']} "
        f"valid={int(out['valid'].sum())}/{n + n_again + n_staged} keyframes="
        f"{out['n_keyframes']} loops={out['n_loops_closed']} inserted at "
        f"{np.nonzero(out['stats'][:n, 6])[0].tolist()} median t err "
        f"{t_med:.5f} m, rot err {r_med:.4f} deg; features with depth on "
        f"frame 0: {n_depth0}")
    log(f"{label}: build pass {build[0]:.3f} ms/frame (CUDA events), "
        f"{build[1]:.3f} (host clock); re-tracking pass ({n_again} frames) "
        f"{again[0]:.3f} and {again[1]:.3f}")
    log(f"{label}: front end by stage, ms per frame over {n_staged} frames "
        f"(synced; nested stages count in their callers): "
        f"{ {k: round(v / n_staged, 3) for k, v in staged.items()} }")
    log(f"{label}: launches in the build pass {first_launches}, by the "
        f"stereo association per frame {sorted(set(match_launches))}")
    assert out["initialized"] and out["lost_at"] == -1, "tracking lost"
    assert out["valid"].all(), "not every frame valid"
    assert match_launches == [1] * (n + n_again), \
        "the stereo association is not one masked_best_two launch per frame"
    return first_launches, out, tracker, (t_med, n_depth0)


def stereo_bench_setup():
    """bench.py's stereo figure: (config, rectified pairs, poses)."""
    cfg = TrackerConfig(
        sensor="stereo", n_features=1000, min_init_features=200,
        map_cfg=BENCH_MAP, fps=30)
    assert cfg.bf == 40.0 and cfg.fx == 500.0
    pairs = list(zip((img for img, _ in frames_of("orbit60")),
                     frames_of("orbit60_right")))
    return cfg, pairs, orbit_trajectory(n_frames=60)


def stereo_kitti_setup():
    """bench.py's KITTI-shape stereo figure: (config, pairs, poses)."""
    cfg = TrackerConfig(
        sensor="stereo", n_features=2000, min_init_features=200,
        bf=KITTI_BF, map_cfg=MapConfig(k_max=24, n_feat=2000, l_max=8000,
                                       d_max=8), fps=10, **KITTI_CAM)
    pairs = list(zip(frames_of("kitti30_left"), frames_of("kitti30_right")))
    return cfg, pairs, orbit_trajectory(n_frames=60)[:30]


def run_stereo_bench(dev, rgbd_build_launches):
    """Phase 9: stereo at the bench configuration."""
    cfg, pairs, poses = stereo_bench_setup()
    launches, out, _, (t_med, n_depth0) = run_stereo(
        dev, "stereo (bench)", cfg, pairs, poses, n_again=20)
    assert out["n_keyframes"] >= 3, out["n_keyframes"]
    assert t_med < 0.03, "pose error gate (tests/test_auto.py:183-185)"
    assert n_depth0 > 200, "too few features with depth on frame 0"
    for name, count in launches.items():
        assert count > 0, f"kernel {name} never launched on the stereo path"
    more = launches["masked_best_two"] - rgbd_build_launches["masked_best_two"]
    log(f"stereo (bench): {more} more masked_best_two launches than the "
        f"default RGB-D tracker over the same {len(pairs)} poses")
    assert more >= len(pairs), \
        "fewer than one masked_best_two launch per frame more than RGB-D"
    return launches


def run_stereo_kitti(dev):
    """Phase 10: stereo at the KITTI 00-02 camera."""
    cfg, pairs, poses = stereo_kitti_setup()
    launches, out, tracker, _ = run_stereo(
        dev, "stereo (KITTI camera)", cfg, pairs, poses, n_again=10)
    lines = tracker.trajectory_kitti()
    log(f"stereo (KITTI camera): trajectory_kitti() gives {len(lines)} "
        f"lines of {len(lines[0].split())} numbers")
    assert len(lines) == int(out["valid"].sum()) == out["n_frames"]
    return launches


MONO_MAP = MapConfig(k_max=24, n_feat=2000, l_max=8000, d_max=8)
MONO_STAGES = ((msearch, "search_for_initialization"),
               (initializer, "sample_octets"),
               (initializer, "initialize_from_samples"),
               (steps, "insert_keyframe"),
               (steps, "insert_landmarks_two_view"),
               (steps, "refresh_landmarks"),
               (steps, "local_bundle_adjustment"),
               (steps, "scene_median_depth"), (steps, "scale_map"),
               (auto_loop, "add_keyframe_bow"))


def mono_bench_cfg():
    """bench.py's monocular figure (bench.py:202-206)."""
    return TrackerConfig(sensor="mono", n_features=2000,
                         min_init_features=200, min_init_matches=60,
                         map_cfg=MONO_MAP, fps=30)


@contextlib.contextmanager
def counted_launches(*targets):
    """Within the block, each (module, function name) of ``targets`` adds
    the masked_best_two launches of its calls to the yielded dict."""
    out = {name: 0 for _, name in targets}

    def counted(name, fn):
        def run(*a, **kw):
            before = hamming.LAUNCHES["masked_best_two"]
            r = fn(*a, **kw)
            out[name] += hamming.LAUNCHES["masked_best_two"] - before
            return r
        return run

    saved = [getattr(mod, name) for mod, name in targets]
    try:
        for (mod, name), fn in zip(targets, saved):
            setattr(mod, name, counted(name, fn))
        yield out
    finally:
        for (mod, name), fn in zip(targets, saved):
            setattr(mod, name, fn)


@contextlib.contextmanager
def captured_problems():
    """Within the block, every launch of either kernel wrapper leaves a
    copy of its inputs in the yielded dict, the newest of each (kernel,
    calling function, shape): the problems this path really gives the
    kernels, to be held against the plain versions after the run."""
    out = {}
    saved = hamming.masked_best_two, hamming.distance_matrix

    def keep(kernel, fn):
        def run(*tensors):
            if tensors[0].is_cuda and tensors[0].shape[0]:
                caller = sys._getframe(1).f_code.co_name
                shape = (tensors[0].shape[0], tensors[1].shape[0])
                out[kernel, caller, shape] = tuple(t.clone() for t in tensors)
            return fn(*tensors)
        return run

    hamming.masked_best_two = keep("masked_best_two", saved[0])
    hamming.distance_matrix = keep("distance_matrix", saved[1])
    try:
        yield out
    finally:
        hamming.masked_best_two, hamming.distance_matrix = saved


def sim_ate(out, poses, offset=0):
    """Similarity-aligned (scale + SE3) ATE RMSE over the valid frames of
    one pass, in metres of the ground truth."""
    n = len(poses)
    sel = out["valid"][offset:offset + n]
    gt = camera_centers(np.stack([p[0] for p in poses])[sel],
                        np.stack([p[1] for p in poses])[sel])
    est = camera_centers(out["R"][offset:offset + n][sel],
                         out["t"][offset:offset + n][sel])
    return ate_rmse(est, gt, with_scale=True)


def run_mono(dev):
    """Phase 11: the monocular tracker at the bench configuration, the
    default AutoTrackerConfig(), over the 60-frame orbit, then re-tracked
    once. Returns (launches of both passes, the tracker, the newest
    problem of each shape either pass gave the kernels)."""
    n = 60
    poses = sequences()[MONO_SEQ][1]
    frames = [f[0] if isinstance(f, tuple) else f
              for f in frames_of(MONO_SEQ)]
    tracker = AutoTracker(mono_bench_cfg(), AutoTrackerConfig(
        traj_capacity=8 * n), device=dev)
    assert tracker._step.maint_phases[0] == tracker._step.ph_loop
    reset_launches()
    boot, build_ms = {}, []
    first_init = initializer.initialize_from_samples

    def watched_init(*a, **kw):
        res = first_init(*a, **kw)
        boot["tries"] = boot.get("tries", 0) + 1
        boot["used_h"], boot["success"] = bool(res.used_h), bool(res.success)
        return res

    initializer.initialize_from_samples = watched_init
    try:
        with captured_problems() as problems:
            with counted_launches(
                    (msearch, "search_for_initialization"),
                    (msearch, "search_for_triangulation")) as by_fn:
                for i, img in enumerate(frames):
                    was = tracker.state.initialized
                    with stage_ms(*(() if was else MONO_STAGES)) as staged:
                        build_ms.append(synced_ms(
                            lambda: tracker.process_mono(img)))
                    if tracker.state.initialized and not was:
                        m = tracker.state.map
                        boot.update(
                            frame=i, ms=build_ms[-1], stages=dict(staged),
                            n_lm=int(m.n_lm),
                            depth0=float(steps.scene_median_depth(m, 0)))
                first_launches = dict(hamming.LAUNCHES)
            again = timed_pass(tracker.process_mono, frames)
    finally:
        initializer.initialize_from_samples = first_init
    # the phase is both passes: the build pass inserts so often that its
    # maintenance cycles seldom reach the duplicate merge (distance_matrix)
    launches = dict(hamming.LAUNCHES)
    out = tracker.finalize()
    assert out["initialized"] and "frame" in boot, "never bootstrapped"
    b = boot["frame"]
    tracked = [v for i, v in enumerate(build_ms) if i > b]
    log(f"mono (bench): bootstrap at frame {b} after {boot['tries']} tries "
        f"of the initializer, {'H' if boot['used_h'] else 'F'} won, "
        f"{boot['n_lm']} two-view landmarks, median scene depth of keyframe "
        f"0 {boot['depth0']:.6f}; the bootstrap frame took {boot['ms']:.2f} "
        f"ms (the frames before it "
        f"{[round(v, 2) for v in build_ms[:b]]}), by stage (ms, synced): "
        f"{boot['stages']}")
    log(f"mono (bench): initialized={out['initialized']} "
        f"lost_at={out['lost_at']} valid={int(out['valid'].sum())}/{2 * n} "
        f"keyframes={out['n_keyframes']} loops={out['n_loops_closed']} "
        f"inserted at {np.nonzero(out['stats'][:n, 6] == 1)[0].tolist()}")
    log(f"mono (bench): build pass {np.mean(tracked):.3f} ms/frame after the "
        f"bootstrap (host clock, synced per frame; median "
        f"{np.median(tracked):.3f}); re-tracking pass {again[0]:.3f} ms/frame "
        f"(CUDA events), {again[1]:.3f} (host clock)")
    log(f"mono (bench): launches in both passes {launches}, in the build "
        f"pass {first_launches}, of masked_best_two by function there "
        f"{by_fn}")
    assert out["lost_at"] == -1, "tracking lost"
    assert out["valid"][b:n].all() and out["valid"][n:].all(), \
        "a frame after the bootstrap frame is invalid"
    assert not out["valid"][:b].any()
    assert out["n_keyframes"] >= 3, out["n_keyframes"]
    assert abs(boot["depth0"] - 1.0) < 1e-3, "the gauge is not depth 1"
    for p in range(2):
        rmse = sim_ate(out, poses, offset=p * n)
        log(f"mono (bench) pass {p + 1}: similarity-aligned ATE "
            f"{rmse:.5f} m")
        assert rmse < 0.03, "ATE gate (tests/test_auto.py:310-311)"
    assert by_fn["search_for_initialization"] > 0
    assert by_fn["search_for_triangulation"] > 0
    for name, count in launches.items():
        assert count > 0, f"kernel {name} never launched on the mono path"
    return launches, tracker, problems


def mono_first_two(dev):
    """The monocular feature sets of the first two frames of the mono
    sequence, at the bench configuration's 2000 features."""
    ext = OrbExtractor(n_features=2000)
    out = []
    for f in first_frames(MONO_SEQ, 2):
        img = f[0] if isinstance(f, tuple) else f
        f = ext(torch.as_tensor(img, device=dev))
        out.append(msearch.FeatureSet(f.xy, torch.full_like(f.angle, -1.0),
                                      f.octave, f.angle, f.desc, f.valid))
    return out


def compare_initializer(dev):
    """The two-view initializer on the card and on the CPU from the same
    matches and the same 8-point sets (drawn on the CPU): the batched
    eigh and svd go through cuSOLVER on the card and LAPACK on the host,
    and the two may rank the hypotheses differently. Gated on the
    outcome, not on the winner's index: both succeed or both fail; where
    they succeed (with the same model or one with H and one with F), nine
    tenths of the good points are shared, the rotations agree within 1e-2
    and the translation directions within 10 degrees (frames 0 and 1 are
    a low-parallax pair, won by H, whose translation is the least
    determined part: the two differ by some 5 degrees)."""
    f1, f2 = mono_first_two(dev)
    idx, _, matched = msearch.search_for_initialization(f1, f2, f1.xy)
    p2 = f2.xy[idx.clamp(min=0).long()]
    cfg = mono_bench_cfg()
    K4 = (cfg.cam.fx, cfg.cam.fy, cfg.cam.cx, cfg.cam.cy)
    gen = torch.Generator().manual_seed(auto_loop.SEED)
    octets = initializer.sample_octets(gen, matched.cpu())
    res = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        res[name] = initializer.initialize_from_samples(
            octets.to(d), K4, f1.xy.to(d), p2.to(d), matched.to(d))
    c, h = res["card"], res["cpu"]
    dR = float((c.R.cpu() - h.R).abs().max())
    cos = torch.dot(c.t.cpu(), h.t) / (c.t.norm().cpu() * h.t.norm()).clamp(
        min=1e-12)
    dt = float(torch.rad2deg(torch.acos(cos.clamp(-1.0, 1.0))))
    shared = int((c.good.cpu() & h.good).sum())
    log(f"initializer card vs cpu (frames 0 and 1, {int(matched.sum())} "
        f"matches, the same 200 8-point sets): success {bool(c.success)} vs "
        f"{bool(h.success)}, {'H' if c.used_h else 'F'} vs "
        f"{'H' if h.used_h else 'F'}, good points {int(c.good.sum())} vs "
        f"{int(h.good.sum())}, of them shared {shared}, max |R| diff "
        f"{dR:.2e}, translation directions {dt:.2f} degrees apart")
    assert torch.isfinite(c.R).all() and torch.isfinite(c.t).all()
    assert bool(c.success) == bool(h.success), "card and CPU disagree"
    if bool(c.success):
        assert shared >= 0.9 * max(int(c.good.sum()), int(h.good.sum()))
        assert dR < 1e-2 and dt < 10.0, "another pose from the same sets"


def check_mono_problems(dev, tracker, problems, rows):
    """Phase 3's problems that need the monocular run, held bit-exact
    against the plain versions and the baseline kernel and timed like the
    others: the epipolar mask of the run's keyframes 1 and 0 at
    [2000, 2000], and the newest problem of every (calling function,
    shape) that phase 11 gave either kernel, the local-map search at
    [4096, 2000] among them. Appended to the kernels' rows."""
    base = BaselineKernels()
    popc_rate = popc_per_s()
    m = tracker.state.map
    k1, k2 = steps._kf_featureset(m, 1), steps._kf_featureset(m, 0)
    F12, e2 = steps.epipolar_geometry(m, tracker.cfg.cam, 1, 0)
    todo = [("epipolar [2000,2000]", "masked_best_two",
             (k1.desc, k2.desc, msearch.triangulation_mask(
                 k1, k2, m.kf_lm[1] < 0, m.kf_lm[0] < 0, F12, e2)))]
    assert todo[0][2][2].shape == (2000, 2000)
    todo += [(f"mono path, {caller} [{q},{n}]", kernel, tensors)
             for (kernel, caller, (q, n)), tensors in sorted(
                 problems.items(), key=lambda kv: kv[0])]
    shapes = {(kernel, shape) for kernel, _, shape in problems}
    assert ("masked_best_two", (4096, 2000)) in shapes, sorted(shapes)
    assert ("masked_best_two", (2000, 2000)) in shapes, sorted(shapes)
    for where, kernel, tensors in todo:
        tensors = tuple(t.contiguous() for t in tensors)
        if kernel == "distance_matrix":
            d1, d2 = tensors
            want = hamming.distance_matrix_plain(d1, d2)
            assert torch.equal(hamming.distance_matrix(d1, d2), want), where
            assert torch.equal(base.distance_matrix(d1, d2), want), where
            log(f"kernel check {where}: distance_matrix bit-exact")
            row = time_pair(lambda: hamming.distance_matrix(d1, d2),
                            lambda: base.distance_matrix(d1, d2),
                            lambda: hamming.distance_matrix_plain(d1, d2))
            row["bound_ms"], row["bound_by"] = bound_distance_matrix(
                d1.shape[0], d2.shape[0], popc_rate)
            row["problem"] = where
            rows[1]["other_problems"].append(row)
            log(f"distance_matrix {where}: " + fmt_times(row))
            continue
        dq, dt, mask = tensors
        want = hamming.masked_best_two_plain(dq, dt, mask)
        assert_same("masked_best_two", hamming.masked_best_two(dq, dt, mask),
                    want, where)
        assert_same("baseline masked_best_two",
                    base.masked_best_two(dq, dt, mask), want, where)
        share = float(mask.float().mean())
        log(f"kernel check {where}: masked_best_two bit-exact "
            f"({share:.4f} admissible)")
        row = time_pair(lambda: hamming.masked_best_two(dq, dt, mask),
                        lambda: base.masked_best_two(dq, dt, mask),
                        lambda: hamming.masked_best_two_plain(dq, dt, mask))
        row["bound_ms"], row["bound_by"] = bound_best_two(dq, dt, mask,
                                                          popc_rate)
        row["problem"], row["admissible"] = where, share
        rows[0]["other_problems"].append(row)
        log(f"masked_best_two {where}: " + fmt_times(row))


def main():
    kernels_only = sys.argv[1:] == ["--kernels-only"]
    if sys.argv[1:] and not kernels_only:
        raise SystemExit("usage: python3 chip_smoke.py [--kernels-only]")
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cuda_lib.build_all(["hamming", "hamming_v1"])
    cuda_lib.load("hamming")
    log(f"built csrc/hamming.cu and csrc/hamming_v1.cu in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in ("hamming", "hamming_v1"):
        log(cuda_lib.build_logs.get(name, "").strip())
    if not kernels_only:
        t0 = time.perf_counter()
        workers = max(1, min(7, (os.cpu_count() or 2) - 1))
        render_all(workers)
        log(f"rendered {sum(len(f) for f in _FRAMES.values())} frames of "
            f"{len(_FRAMES)} sequences in {workers} processes in "
            f"{time.perf_counter() - t0:.2f} s")
    rows = check_kernels(dev)
    if kernels_only:
        log(json.dumps({"kernels": rows}))
        return
    by_phase = {"4 rgbd slice": run_slice(dev)}
    compare_devices(dev)
    by_phase["6 default rgbd"], rgbd_build = run_default(dev)
    by_phase["7 controlled loop"], _ = run_controlled_loop(dev)
    run_compaction(dev)
    by_phase["9 stereo bench"] = run_stereo_bench(dev, rgbd_build)
    by_phase["10 stereo kitti"] = run_stereo_kitti(dev)
    by_phase["11 mono bench"], mono_tracker, mono_problems = run_mono(dev)
    check_mono_problems(dev, mono_tracker, mono_problems, rows)
    compare_initializer(dev)
    for k_max, fix_scale in ((96, True), (300, True), (300, False)):
        key = f"12 loop k_max {k_max}" + ("" if fix_scale else " free scale")
        # the free-scale gate on the position error is the JAX package's
        # outcome on the same frames on the CPU (0.0397 -> 0.0179 m, a
        # share of 0.450: the Sim3 of a 15 cm baseline leaves that much)
        by_phase[key], _ = run_controlled_loop(
            dev, MapConfig(k_max, 1000, 10000, 8), fix_scale,
            label="loop above 64 slots",
            seq="loop18" if fix_scale else "loop18_shifted",
            drift_gate=0.35 if fix_scale else 0.5)
    for row in rows:
        # the newest slice's main path is the monocular tracker of phase 11
        # (its build pass); every other path's count is listed beside it.
        # Each phase has failed already if a kernel of its path was not
        # launched (phase 10 keeps one keyframe over its 30 frames, so no
        # duplicate-landmark merge and no distance_matrix there).
        key = row["name"].removeprefix("hamming_")
        row["launches"] = by_phase["11 mono bench"][key]
        row["launches_by_phase"] = {p: c[key] for p, c in by_phase.items()}
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
