"""The street-scale run and its score (the counterpart of
scripts/eval_street.py): the stereo KITTI driver, autonomous, over the
~65 m kitti_street_fixture circuit at the KITTI 00-02 camera, with a
keyframe capacity small enough that slots are recycled, then ATE and
KITTI segment drift against the fixture's ground truth.

Usage: python -m orb_slam2_with_comment_tpu_torch.examples.eval_street
       [--root R] [--kmax 128] [--skip-run] [--device cuda]

R holds ``kitti_street_fixture`` (dataio/fixtures.py ``--street``); the
run's files go to ``R/run_street`` (CameraTrajectory.txt,
run_summary.json, and street_row.txt with the results-table row this
prints before the JSON line of the scores). ``--skip-run`` scores the
files of an earlier run.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os

import numpy as np

from ..evaluation.ate import ate_rmse
from ..evaluation.rpe import kitti_segment_drift
from ..evaluation.trajectory import read_kitti, read_kitti_full
from . import stereo_kitti

DRIFT_LENGTHS = (5, 10, 20)  # metres: the circuit is one ~65 m lap


def run(fix: str, wd: str, kmax: int, device: str) -> int:
    """stereo_kitti --auto --kmax ``kmax`` on ``fix``, in ``wd``."""
    os.makedirs(wd, exist_ok=True)
    with contextlib.chdir(wd):
        return stereo_kitti.main(
            ["stereo_kitti", os.path.join(fix, "settings.yaml"), fix,
             "--auto", "--kmax", str(kmax), "--device", device])


def score(fix: str, wd: str, kmax: int):
    """(table row, scores) of the run in ``wd``: its summary, the ATE of
    the tracked frames' camera centres (SE3-aligned) and the segment
    drift, both over the first frames of the file against the ground
    truth's, and the ground truth's path length."""
    with open(os.path.join(wd, "run_summary.json")) as f:
        summ = json.load(f)
    est = os.path.join(wd, "CameraTrajectory.txt")
    gt = os.path.join(fix, "poses_gt.txt")
    R_e, t_e = read_kitti_full(est)
    R_g, t_g = read_kitti_full(gt)
    c_e, c_g = read_kitti(est), read_kitti(gt)
    n = min(len(c_e), len(c_g))
    path_len = float(np.sum(np.linalg.norm(np.diff(c_g, axis=0), axis=1)))
    drift = kitti_segment_drift(R_e[:n], t_e[:n], R_g[:n], t_g[:n],
                                lengths=DRIFT_LENGTHS)
    ate = float(ate_rmse(c_e[:n], c_g[:n]))
    row = (f"| KITTI-geometry street circuit, {path_len:.0f} m "
           f"(examples/stereo_kitti.py --auto --kmax {kmax}) "
           f"| {summ['n_frames']} | {summ['n_frames']}"
           f" / {summ['n_keyframes']} KFs | {ate*100:.1f} cm | — "
           f"| drift {drift['trans_pct']:.2f}% / "
           f"{drift['rot_deg_per_m']:.3f}°/m, "
           f"{summ['n_loops_closed']} loop(s) closed, "
           f"{summ['n_compact_kf']} KF compactions |")
    return row, {"summary": summ, "ate_m": ate, **drift,
                 "path_len_m": path_len}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default="fixtures500")
    ap.add_argument("--kmax", type=int, default=128,
                    help="map capacity; small enough that the street's "
                         "keyframe count forces compaction")
    ap.add_argument("--skip-run", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fix = os.path.abspath(os.path.join(args.root, "kitti_street_fixture"))
    wd = os.path.abspath(os.path.join(args.root, "run_street"))
    if not args.skip_run:
        rc = run(fix, wd, args.kmax, args.device)
        if rc:
            return rc
    row, scores = score(fix, wd, args.kmax)
    print(row)
    print(json.dumps(scores))
    out = os.path.join(wd, "street_row.txt")
    with open(out, "w") as f:
        f.write(row + "\n")
    print("row written to", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
