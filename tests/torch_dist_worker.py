"""The ranks of a gloo group for tests/test_torch_parallel.py. Imports no
jax: the test writes the problems into an .npz, this script solves them
with the port's sharded solvers over N CPU processes, and rank 0 writes
the results into another .npz.

    python tests/torch_dist_worker.py IN.npz OUT.npz --nprocs N

Problems in IN.npz, by key prefix: ``ba<i>_`` (a BAProblem's fields,
``iters``), ``pg<i>_`` (a PoseGraphProblem's fields, ``iters``,
``fix_scale``), and ``gba_`` (rendered RGB-D frames and their poses: a
map built from them through keyframe_step, then a global BA through
LoopCloser.poll_gba's process-group branch).
"""
import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from orb_slam2_with_comment_tpu_torch.mapstate.map import (  # noqa: E402
    MapConfig, empty_map)
from orb_slam2_with_comment_tpu_torch.optim import ba  # noqa: E402
from orb_slam2_with_comment_tpu_torch.optim.pose_graph import (  # noqa: E402
    PoseGraphProblem)
from orb_slam2_with_comment_tpu_torch.optim.residuals import (  # noqa: E402
    CamParams)
from orb_slam2_with_comment_tpu_torch.parallel import (  # noqa: E402
    dist_ba, dist_pose_graph, launch)

CAM = CamParams.of(500.0, 500.0, 320.0, 240.0, 40.0)
GBA_CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)


def _cases(data, prefix):
    ids = sorted({int(k[len(prefix):].split("_")[0]) for k in data.files
                  if k.startswith(prefix) and k[len(prefix)].isdigit()})
    return [(i, {k.split("_", 1)[1]: data[k] for k in data.files
                 if k.startswith(f"{prefix}{i}_")}) for i in ids]


def solve_ba(c):
    prob = ba.BAProblem(*(torch.as_tensor(c[f]) for f in ba.BAProblem._fields))
    prob = prob._replace(obs_pose=prob.obs_pose.long())
    local = dist_ba.shard_problem(prob)
    _, _, _, chi2_0 = dist_ba.ba_step_sharded(CAM, local)
    R, t, X, chi2 = dist_ba.ba_solve_sharded(CAM, local,
                                             iters=int(c["iters"]))
    return dict(R=R, t=t, X=dist_ba.gather_points(X), chi2=chi2,
                chi2_0=chi2_0)


def solve_pg(c):
    prob = PoseGraphProblem(*(torch.as_tensor(c[f])
                              for f in PoseGraphProblem._fields))
    prob = prob._replace(e_i=prob.e_i.long(), e_j=prob.e_j.long())
    res = dist_pose_graph.optimize_pose_graph_sharded(
        dist_pose_graph.shard_edges(prob), iters=int(c["iters"]),
        fix_scale=bool(c["fix_scale"]))
    return res._asdict()


def run_gba(c):
    """A map from the frames, then one global BA through the group."""
    from orb_slam2_with_comment_tpu_torch.frontend.extractor import (
        OrbExtractor)
    from orb_slam2_with_comment_tpu_torch.pipeline import steps
    from orb_slam2_with_comment_tpu_torch.pipeline.loop_closing import (
        LoopCloser)
    from orb_slam2_with_comment_tpu_torch.pipeline.tracking import (
        TrackerConfig, default_vocabulary)
    from orb_slam2_with_comment_tpu_torch.place.database import (
        KeyFrameDatabase)
    cfg = TrackerConfig(**GBA_CAM, n_features=500, min_init_features=100,
                        map_cfg=MapConfig(8, 500, 4096, 6), fps=30,
                        depth_factor=1.0)
    ext = OrbExtractor(n_features=500)
    m = empty_map(cfg.map_cfg, "cpu")
    for k in range(len(c["imgs"])):
        feats, d = steps.extract_rgbd_features(
            ext, cfg.cam, torch.as_tensor(c["imgs"][k]),
            torch.as_tensor(c["depths"][k]), 1.0, cfg.width, cfg.height)
        obs = steps.FrameObs(feats, d, torch.full((d.shape[0],), -1,
                                                  dtype=torch.int32))
        m = steps.keyframe_step(m, cfg.cam, obs, torch.as_tensor(c["R"][k]),
                                torch.as_tensor(c["t"][k]), k,
                                cfg.depth_threshold, cfg.width, cfg.height,
                                kf=k)
    db = KeyFrameDatabase(default_vocabulary("cpu"), cfg.map_cfg.k_max)
    lc = LoopCloser(cfg.cam, db, width=cfg.width, height=cfg.height)
    lc.mesh = dist.group.WORLD
    lc._start_gba(m)
    g = dict(lc._gba)
    out, polls = None, 0
    while out is None and polls < 10:
        out = lc.poll_gba(m)
        polls += 1
    # the same fixed schedule on one device: every step taken at 1e-4
    ref = ba.ba_solve(cfg.cam, g["prob"], iters=lc.gba_total_iters,
                      robust=True, init_lambda=1e-4, accept_all=True)
    g["prob"] = g["prob"]._replace(R=ref.R, t=ref.t, X=ref.X)
    want = lc._apply_gba(m, g)
    return dict(polls=torch.tensor(polls), Lp=torch.tensor(g["Lp"]),
                kf_t0=m.kf_t, kf_t=out.kf_t, kf_R=out.kf_R, lm_pw=out.lm_pw,
                ref_kf_t=want.kf_t, ref_kf_R=want.kf_R, ref_lm_pw=want.lm_pw)


def rank_main(rank, nprocs, port, inp, out):
    torch.set_num_threads(2)
    launch.init_group(rank, nprocs, port, "cpu")
    try:
        data = np.load(inp)
        res = {}
        for i, c in _cases(data, "ba"):
            res.update({f"ba{i}_{k}": v for k, v in solve_ba(c).items()})
        for i, c in _cases(data, "pg"):
            res.update({f"pg{i}_{k}": v for k, v in solve_pg(c).items()})
        if "gba_imgs" in data.files:
            c = {k[4:]: data[k] for k in data.files if k.startswith("gba_")}
            res.update({f"gba_{k}": v for k, v in run_gba(c).items()})
        if rank == 0:
            np.savez(out, **{k: v.numpy() for k, v in res.items()})
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("inp")
    ap.add_argument("out")
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args()
    if args.rank is not None:
        return rank_main(args.rank, args.nprocs, args.port, args.inp,
                         args.out)
    port = launch.free_port()
    return launch.run_ranks(
        lambda r: [sys.executable, os.path.abspath(__file__), args.inp,
                   args.out, "--nprocs", str(args.nprocs), "--rank", str(r),
                   "--port", str(port)], args.nprocs, 110.0)


if __name__ == "__main__":
    sys.exit(main())
