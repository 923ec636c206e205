"""Launch N processes on this host that join one torch.distributed group
and run the multi-device paths over it (the counterpart of
scripts/launch_distributed.py).

    python -m orb_slam2_with_comment_tpu_torch.parallel.launch --nprocs N \
        [--device cpu|cuda] [--timeout SECONDS]

Each process is a rank of one group: gloo on the CPU, NCCL on the card
(rank r on ``cuda:r``), meeting at a free port of 127.0.0.1. Each rank runs
the landmark-sharded bundle adjustment (dist_ba), the edge-sharded pose
graph (dist_pose_graph) and one frame of a MultiSeqTracker with one
sequence per rank, checks each against the single-device solvers or its
gates, and prints ``DISTRIBUTED OK``. The launcher exits non-zero if any
rank fails or outlives the time limit.
"""
from __future__ import annotations

import argparse
import datetime
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist


def free_port() -> int:
    """A TCP port of 127.0.0.1 that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_group(rank: int, world: int, port: int, device: str,
               timeout_s: float = 120.0) -> torch.device:
    """Join the group of ``world`` ranks at 127.0.0.1:``port``: gloo for
    the CPU, NCCL for the card, where rank r takes ``cuda:r``. Returns the
    rank's device."""
    if device == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev = torch.device("cpu")
        backend = "gloo"
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev


def run_ranks(argv_of_rank, nprocs: int, timeout_s: float,
              env: dict | None = None) -> int:
    """Start ``nprocs`` processes (``argv_of_rank(rank)`` each, their
    output passed through), wait for all of them and kill the rest when
    one fails or the time runs out. Returns 0 if every rank exited 0."""
    procs = [subprocess.Popen(argv_of_rank(r), env=env)
             for r in range(nprocs)]
    deadline = time.monotonic() + timeout_s
    rc = 0
    try:
        pending = list(procs)
        while pending and not rc:
            for p in list(pending):
                code = p.poll()
                if code is not None:
                    pending.remove(p)
                    rc = rc or code
            if time.monotonic() > deadline:
                print(f"launch: timed out after {timeout_s:.0f} s",
                      file=sys.stderr, flush=True)
                rc = rc or 124
            if pending and not rc:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return rc


# -- what every rank runs ---------------------------------------------------

def ba_demo_problem(device, n_poses: int = 6, n_pts: int = 256,
                    noise: float = 0.2, seed: int = 0):
    """A multi-view BA problem (every pose sees every landmark, perturbed
    start, pose 0 fixed), the JAX launcher's; returns (problem, true t)."""
    from ..geometry import se3
    from ..optim.ba import BAProblem
    rng = np.random.RandomState(seed)
    X = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                  rng.uniform(5, 12, n_pts)], -1).astype(np.float32)
    xi = np.stack([np.array([0.15 * k, 0.01 * k, 0, 0, 0.02 * k, 0],
                            np.float32) for k in range(n_poses)])
    R_gt, t_gt = (a.numpy() for a in se3.exp_se3(torch.as_tensor(xi)))
    uvr = []
    for k in range(n_poses):
        Xc = X @ R_gt[k].T + t_gt[k]
        u = 500.0 * Xc[:, 0] / Xc[:, 2] + 320.0
        v = 500.0 * Xc[:, 1] / Xc[:, 2] + 240.0
        uvr.append(np.stack([u, v, u - 40.0 / Xc[:, 2]], -1))
    obs_uvr = np.stack(uvr, 1).astype(np.float32)
    obs_uvr[..., :2] += rng.randn(n_pts, n_poses, 2).astype(np.float32) * noise
    t0 = t_gt + np.concatenate([np.zeros((1, 3)), rng.randn(
        n_poses - 1, 3) * 0.02]).astype(np.float32)
    X0 = X + rng.randn(n_pts, 3).astype(np.float32) * 0.05
    fixed = np.zeros(n_poses, bool)
    fixed[0] = True

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    prob = BAProblem(t(R_gt), t(t0), t(X0), t(np.tile(
        np.arange(n_poses), (n_pts, 1)), torch.long), t(obs_uvr),
        t(np.ones((n_pts, n_poses), np.float32)), t(fixed),
        t(np.ones(n_pts, bool)))
    return prob, t_gt


def ring_problem(device, n: int = 16, drift: float = 0.03, pad_to: int = 8,
                 seed: int = 0):
    """A pose-graph ring (a chain and one loop edge, measurements from the
    truth, drifted positions, vertex 0 fixed), its edges padded with
    invalid ones to a multiple of ``pad_to``; returns (problem, true t)."""
    from ..geometry import se3, sim3
    from ..optim.pose_graph import PoseGraphProblem
    rng = np.random.RandomState(seed)
    xi = np.stack([np.array([0.4 * k, 0, 0, 0, 0.1 * k, 0], np.float32)
                   for k in range(n)])
    R_gt, t_gt = se3.exp_se3(torch.as_tensor(xi))
    walk = np.cumsum(rng.randn(n, 3).astype(np.float32) * drift, 0)
    walk -= walk[0]
    e_i = np.concatenate([np.arange(n - 1), [n - 1]])
    e_j = np.concatenate([np.arange(1, n), [0]])
    one = torch.ones(len(e_i))
    mR, mt, ms = sim3.compose(
        R_gt[e_j], t_gt[e_j], one,
        *sim3.inverse(R_gt[e_i], t_gt[e_i], one))
    E = len(e_i)
    pad = -E % pad_to
    eye = torch.eye(3).expand(pad, 3, 3)

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    fixed = np.zeros(n, bool)
    fixed[0] = True
    prob = PoseGraphProblem(
        t(R_gt), t(t_gt.numpy() + walk), t(np.ones(n, np.float32)),
        t(np.concatenate([e_i, np.zeros(pad, int)]), torch.long),
        t(np.concatenate([e_j, np.zeros(pad, int)]), torch.long),
        t(torch.cat([mR, eye])), t(torch.cat([mt, torch.zeros(pad, 3)])),
        t(torch.cat([ms, torch.ones(pad)])),
        t(np.arange(E + pad) < E), t(fixed))
    return prob, t_gt.numpy()


def demo(rank: int, world: int, device: torch.device) -> None:
    """The three multi-device paths over the default group, each checked."""
    from ..dataio.synthetic import SyntheticWorld
    from ..mapstate.map import MapConfig
    from ..optim import ba, pose_graph
    from ..optim.residuals import CamParams
    from ..pipeline.auto import AutoTrackerConfig
    from ..pipeline.tracking import TrackerConfig
    from . import dist_ba, dist_pose_graph
    from .multi_seq import MultiSeqTracker

    def log(msg):
        print(f"[rank {rank}/{world}] {msg}", flush=True)

    cam = CamParams.of(500.0, 500.0, 320.0, 240.0, 40.0)
    prob, t_gt = ba_demo_problem(device, n_pts=64 * world)
    t0 = time.perf_counter()
    R, t, X, chi2 = dist_ba.ba_solve_sharded(
        cam, dist_ba.shard_problem(prob), iters=8)
    X = dist_ba.gather_points(X)
    ms = 1000 * (time.perf_counter() - t0)
    ref = ba.ba_solve(cam, prob, iters=8, robust=True, accept_all=True)
    err = float((t.cpu() - torch.as_tensor(t_gt)).abs().max())
    gap = max(float((a - b).abs().max()) for a, b in
              ((t, ref.t), (X, ref.X), (R, ref.R)))
    log(f"dist_ba: chi2 {float(chi2):.3f}, max pose error {err:.5f} m, "
        f"against the single-device solver {gap:.2e}, {ms:.1f} ms")
    assert np.isfinite(float(chi2)) and err < 0.02 and gap < 1e-4

    pg, pg_gt = ring_problem(device, pad_to=world)
    res = dist_pose_graph.optimize_pose_graph_sharded(
        dist_pose_graph.shard_edges(pg), iters=20)
    ref = pose_graph.optimize_pose_graph(pg, iters=20, accept_all=True)
    gap = float((res.t - ref.t).abs().max())
    log(f"dist_pose_graph: chi2 {float(res.chi2):.3e}, against the "
        f"single-device solver {gap:.2e}")
    assert float(res.chi2) < 1e-4 and gap < 1e-4

    cfg = TrackerConfig(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320,
                        height=240, n_features=500, min_init_features=100,
                        map_cfg=MapConfig(4, 500, 2000, 6), fps=30,
                        depth_factor=1.0 / 5000.0)
    imgs, depths = [], []
    for s in range(world):  # one distinct world per sequence
        img, d = SyntheticWorld(seed=s).render(
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32), fx=250.0,
            fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
        imgs.append(np.clip(img, 0, 255).astype(np.uint8))
        depths.append(np.clip(d * 5000.0, 0, 65535).astype(np.uint16))
    mt = MultiSeqTracker(cfg, n_seq=world, auto_cfg=AutoTrackerConfig(
        loop_closing=False), device=device)
    mt.process_rgbd(np.stack(imgs), np.stack(depths))
    outs = mt.finalize()
    if rank == 0:
        log(f"multi_seq: {len(outs)} sequences, initialized "
            f"{[o['initialized'] for o in outs]}")
        assert len(outs) == world and all(o["initialized"] for o in outs)
    else:
        assert outs is None
    log("DISTRIBUTED OK")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--timeout", type=float, default=110.0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:  # a rank
        torch.set_num_threads(max(1, min(4, (os.cpu_count() or 2)
                                         // args.nprocs)))
        dev = init_group(args.rank, args.nprocs, args.port, args.device,
                         args.timeout)
        try:
            demo(args.rank, args.nprocs, dev)
        finally:
            dist.destroy_process_group()
        return 0
    if args.device == "cuda" and torch.cuda.device_count() < args.nprocs:
        raise SystemExit(f"--nprocs {args.nprocs} needs as many cards, "
                         f"{torch.cuda.device_count()} visible")
    port = free_port()
    base = [sys.executable, "-m", __spec__.name, "--nprocs",
            str(args.nprocs), "--device", args.device, "--port", str(port),
            "--timeout", str(args.timeout)]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    rc = run_ranks(lambda r: base + ["--rank", str(r)], args.nprocs,
                   args.timeout, env)
    print(f"launch: {args.nprocs} ranks on {args.device}, exit {rc}",
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
