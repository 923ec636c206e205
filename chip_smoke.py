"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero without the final
``{"ok": true, ...}`` line):

1. Require CUDA; print the card's name and power limit (nvidia-smi), and the
   torch and CUDA versions. TF32 is switched off for matmuls and cuDNN.
2. Build the Hamming kernels from ``orb_slam2_with_comment_tpu_torch/csrc``
   and print the build time and ptxas' register report.
3. Hold both kernel entry points against their plain PyTorch versions on the
   card, bit-exact, on random [300,257], [1000,1000], [8000,1000] and
   [1024,8000] (the duplicate-landmark merge's grid) problems whose masks
   include ties, all-masked rows and N = 1; time kernel and plain version
   with CUDA events at the main path's largest shapes.
4. Run the RGB-D slice at the bench configuration (640x480, 1000 features,
   MapConfig(24, 1000, 8000, 8), loop_closing=False) over the 60-frame
   synthetic orbit, then re-track the same frames once more; assert
   initialization, no loss, every frame of both passes valid, the keyframe
   count, the pose error against ground truth, and that both kernels were
   launched.
5. Run a 16-frame reduced-size slice on the card and on the CPU (plain
   versions) and compare keyframe decisions and poses.

The second-to-last line is a JSON object describing each kernel; the last
line is the JSON ``ok`` record.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig
from orb_slam2_with_comment_tpu_torch.ops import cuda_lib, hamming
from orb_slam2_with_comment_tpu_torch.pipeline.auto import (
    AutoTracker, AutoTrackerConfig)
from orb_slam2_with_comment_tpu_torch.pipeline.tracking import TrackerConfig


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


def random_problem(gen: torch.Generator, q: int, n: int, dev):
    """Descriptors with planted duplicates (ties) and a mask with ~30%
    admissible pairs, one all-masked row and one all-admissible row."""
    dq = torch.randint(-2 ** 31, 2 ** 31, (q, 8), generator=gen,
                       dtype=torch.int64).to(torch.int32)
    dt = torch.randint(-2 ** 31, 2 ** 31, (n, 8), generator=gen,
                       dtype=torch.int64).to(torch.int32)
    if n > 4:
        dt[1::4] = dt[0::4][: dt[1::4].shape[0]]  # equal targets: ties
        dq[: min(q, n) // 2] = dt[: min(q, n) // 2]  # exact matches
    mask = torch.rand((q, n), generator=gen) < 0.3
    mask[0] = False
    if q > 1:
        mask[1] = True
    return dq.to(dev), dt.to(dev), mask.to(dev)


def check_kernels(dev):
    """Phase 3: bit-exact comparison and timing. Returns per-kernel rows."""
    gen = torch.Generator().manual_seed(0)
    err_bt = err_dm = 0
    for q, n in ((300, 257), (1000, 1000), (8000, 1000), (1024, 8000),
                 (37, 1), (1, 5)):
        dq, dt, mask = random_problem(gen, q, n, dev)
        got = hamming.masked_best_two(dq, dt, mask)
        want = hamming.masked_best_two_plain(dq, dt, mask)
        for name, a, b in zip(("best", "idx", "second", "idx2"), got, want):
            e = int((a.long() - b.long()).abs().max())
            assert e == 0, f"masked_best_two {name} differs at [{q},{n}]: {e}"
            err_bt = max(err_bt, e)
        dm = hamming.distance_matrix(dq, dt)
        e = int((dm - hamming.distance_matrix_plain(dq, dt)).abs().max())
        assert e == 0, f"distance_matrix differs at [{q},{n}]: {e}"
        err_dm = max(err_dm, e)
        assert int(got[0][0]) == hamming.BIG and int(got[2][0]) == hamming.BIG
        log(f"kernel check [{q},{n}]: bit-exact")
    torch.cuda.synchronize()
    # timing at the main path's largest shapes
    dq, dt, mask = random_problem(gen, 8000, 1000, dev)
    bt_ms = cuda_ms(lambda: hamming.masked_best_two(dq, dt, mask), 50)
    bt_plain = cuda_ms(lambda: hamming.masked_best_two_plain(dq, dt, mask), 5)
    dr = torch.randint(-2 ** 31, 2 ** 31, (1024, 8), generator=gen,
                       dtype=torch.int64).to(torch.int32).to(dev)
    dl = torch.randint(-2 ** 31, 2 ** 31, (8000, 8), generator=gen,
                       dtype=torch.int64).to(torch.int32).to(dev)
    dm_ms = cuda_ms(lambda: hamming.distance_matrix(dr, dl), 50)
    dm_plain = cuda_ms(lambda: hamming.distance_matrix_plain(dr, dl), 5)
    log(f"masked_best_two [8000,1000]: kernel {bt_ms:.4f} ms, plain "
        f"{bt_plain:.4f} ms")
    log(f"distance_matrix [1024,8000]: kernel {dm_ms:.4f} ms, plain "
        f"{dm_plain:.4f} ms")
    src = "orb_slam2_with_comment_tpu_torch/csrc/hamming.cu"
    pallas = "orb_slam2_with_comment_tpu/ops/hamming_pallas.py:59"
    return [
        {"name": "hamming_masked_best_two", "route": "cuda", "source": src,
         "replaces": pallas, "max_abs_err": err_bt, "ms": bt_ms,
         "plain_ms": bt_plain},
        {"name": "hamming_distance_matrix", "route": "cuda", "source": src,
         "replaces": pallas, "max_abs_err": err_dm, "ms": dm_ms,
         "plain_ms": dm_plain},
    ]


def render_frames(world, poses, **cam):
    return [(np.clip(img, 0, 255).astype(np.uint8),
             np.clip(depth * 5000.0, 0, 65535).astype(np.uint16))
            for img, depth in (world.render(R, t, **cam) for R, t in poses)]


def pose_errors(out, poses, offset=0):
    n = len(poses)
    t_err = [np.linalg.norm(out["t"][offset + i] - poses[i][1])
             for i in range(n)]
    r_err = [np.degrees(np.arccos(np.clip(
        (np.trace(out["R"][offset + i] @ poses[i][0].T) - 1) / 2, -1, 1)))
        for i in range(n)]
    return float(np.median(t_err)), float(np.median(r_err))


def run_slice(dev):
    """Phase 4: the full-width RGB-D slice, counted launches, timed passes."""
    world = SyntheticWorld(seed=1)
    n = 60
    poses = orbit_trajectory(n_frames=n)
    frames = render_frames(world, poses)
    cfg = TrackerConfig(
        n_features=1000, min_init_features=200,
        map_cfg=MapConfig(k_max=24, n_feat=1000, l_max=8000, d_max=8),
        fps=30, depth_factor=1.0 / 5000.0)
    tracker = AutoTracker(cfg, AutoTrackerConfig(
        traj_capacity=8 * n, loop_closing=False), device=dev)
    for k in hamming.LAUNCHES:
        hamming.LAUNCHES[k] = 0
    pass_ms = []
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for img, depth in frames:
            tracker.process_rgbd(img, depth)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pass_ms.append(start.elapsed_time(end) / n)
        log(f"slice pass {len(pass_ms)}: {pass_ms[-1]:.3f} ms/frame (CUDA "
            f"events), {1000 * wall / n:.3f} ms/frame (host clock)")
    launches = dict(hamming.LAUNCHES)
    out = tracker.finalize()
    log(f"slice: initialized={out['initialized']} lost_at={out['lost_at']} "
        f"valid={int(out['valid'].sum())}/{2 * n} keyframes="
        f"{out['n_keyframes']} inserted at "
        f"{np.nonzero(out['stats'][:, 6])[0].tolist()} launches={launches}")
    assert out["initialized"] and out["lost_at"] == -1, "tracking lost"
    assert out["valid"].shape == (2 * n,) and out["valid"].all(), \
        "not every frame of both passes valid"
    assert 3 <= out["n_keyframes"] <= 24, out["n_keyframes"]
    for p in range(2):
        t_med, r_med = pose_errors(out, poses, offset=p * n)
        log(f"pass {p + 1}: median t err {t_med:.5f} m, rot err "
            f"{r_med:.4f} deg")
        assert t_med < 0.02 and r_med < 1.0, "pose error gate"
    for name, count in launches.items():
        assert count > 0, f"kernel {name} never launched on the main path"
    return launches


def compare_devices(dev):
    """Phase 5: the reduced slice on the card against the plain CPU run."""
    n = 16
    world = SyntheticWorld(seed=1)
    poses = orbit_trajectory(n_frames=n)
    cam = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    frames = render_frames(world, poses, **cam)
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


def main():
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
    cuda_lib.load("hamming")
    log(f"built csrc/hamming.cu in {time.perf_counter() - t0:.2f} s")
    log(cuda_lib.build_logs.get("hamming", "").strip())
    rows = check_kernels(dev)
    launches = run_slice(dev)
    compare_devices(dev)
    for row in rows:
        row["launches"] = launches[row["name"].removeprefix("hamming_")]
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
