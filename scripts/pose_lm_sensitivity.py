"""How far the pose-only LM's result moves when only the order of its sums
changes: the yardstick for comparing two implementations of it.

    python3 scripts/pose_lm_sensitivity.py [--frames 40] [--perms 6]
                                           [--case CASE --seeds 40]
                                           [--device cpu|cuda]

By default runs the RGB-D AutoTracker at the bench configuration (640x480,
1000 features, MapConfig(24, 1000, 8000, 8), loop_closing=False) over the
first --frames frames of the synthetic orbit and keeps every problem it
gives ``optim.pose_opt.optimize_pose``; with --case the problems are
``dataio.synthetic.pose_problem(CASE, seed)`` for --seeds seeds instead.
Each problem is solved by the plain version (``optimize_pose_plain``) as
given and again --perms times with its edges in a random order: the same
problem, every sum over the edges taken in another order. On the card the
kernel (``optimize_pose``) is held against the plain version too. Prints
one JSON object: for each comparison the quantiles of the largest |R| or
|t| difference, how many exceed 1e-4 (the tolerance the kernel is held to
against the plain version), and how many inlier masks differ.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (  # noqa: E402
    SyntheticWorld, orbit_trajectory, pose_problem)
from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig  # noqa: E402
from orb_slam2_with_comment_tpu_torch.optim import pose_opt  # noqa: E402
from orb_slam2_with_comment_tpu_torch.optim.residuals import (  # noqa: E402
    CamParams)
from orb_slam2_with_comment_tpu_torch.pipeline.auto import (  # noqa: E402
    AutoTracker, AutoTrackerConfig)
from orb_slam2_with_comment_tpu_torch.pipeline.tracking import (  # noqa: E402
    TrackerConfig)


def captured(device: str, n_frames: int) -> list:
    """(cam, R0, t0, Xw, obs_uvr, inv_sigma2, valid) of every solve."""
    out, solve = [], pose_opt.optimize_pose

    def keep(cam, *tensors, **kw):
        out.append((cam, *(t.clone() for t in tensors)))
        return solve(cam, *tensors, **kw)

    cfg = TrackerConfig(n_features=1000, min_init_features=200,
                        map_cfg=MapConfig(24, 1000, 8000, 8), fps=30,
                        depth_factor=1.0 / 5000.0)
    tracker = AutoTracker(cfg, AutoTrackerConfig(
        traj_capacity=8 * n_frames, loop_closing=False), device=device)
    world = SyntheticWorld(seed=1)
    pose_opt.optimize_pose = keep
    try:
        for R, t in orbit_trajectory(60)[:n_frames]:
            img, depth = world.render(R, t)
            tracker.process_rgbd(
                np.clip(img, 0, 255).astype(np.uint8),
                np.clip(depth * 5000.0, 0, 65535).astype(np.uint16))
    finally:
        pose_opt.optimize_pose = solve
    return out


def synthetic(device: str, case: str, seeds: int) -> list:
    cam = CamParams.of(500.0, 500.0, 320.0, 240.0, 40.0)
    keys = ("R0", "t0", "Xw", "obs_uvr", "inv_sigma2", "valid")
    return [(cam, *(torch.as_tensor(p[k]).to(device) for k in keys))
            for p in (pose_problem(case, seed) for seed in range(seeds))]


def summary(errs: list, mask_diffs: int) -> dict:
    errs = np.array(errs)
    q = np.quantile(errs, [0.5, 0.9, 0.99, 0.999])
    return {"trials": len(errs), "median": q[0], "p90": q[1], "p99": q[2],
            "p999": q[3], "max": float(errs.max()),
            "over_1e-4": int((errs > 1e-4).sum()),
            "inlier_mask_differences": mask_diffs}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--perms", type=int, default=6)
    ap.add_argument("--case", help="a dataio.synthetic.POSE_CASES name")
    ap.add_argument("--seeds", type=int, default=40)
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = ap.parse_args()
    problems = (synthetic(args.device, args.case, args.seeds) if args.case
                else captured(args.device, args.frames))

    def diff(a, b):
        return max(float((a.R - b.R).abs().max()),
                   float((a.t - b.t).abs().max()))

    gen = torch.Generator().manual_seed(1)
    perm_errs, perm_masks, kernel_errs, kernel_masks = [], 0, [], 0
    for cam, R0, t0, Xw, obs, s2, valid in problems:
        want = pose_opt.optimize_pose_plain(cam, R0, t0, Xw, obs, s2, valid)
        if args.device == "cuda":
            got = pose_opt.optimize_pose(cam, R0, t0, Xw, obs, s2, valid)
            kernel_errs.append(diff(got, want))
            kernel_masks += not torch.equal(got.inliers, want.inliers)
        for _ in range(args.perms):
            p = torch.randperm(valid.shape[1], generator=gen).to(valid.device)
            o, w = (obs[p], s2[p]) if obs.dim() == 2 else (obs[:, p],
                                                           s2[:, p])
            got = pose_opt.optimize_pose_plain(cam, R0, t0, Xw[:, p], o, w,
                                               valid[:, p])
            perm_masks += not torch.equal(got.inliers[:, torch.argsort(p)],
                                          want.inliers)
            perm_errs.append(diff(got, want))
    out = {"device": (torch.cuda.get_device_name(0) if args.device == "cuda"
                      else "cpu"),
           "problems": args.case or f"captured from {args.frames} frames",
           "n_problems": len(problems),
           "plain_vs_reordered": summary(perm_errs, perm_masks)}
    if kernel_errs:
        out["kernel_vs_plain"] = summary(kernel_errs, kernel_masks)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
