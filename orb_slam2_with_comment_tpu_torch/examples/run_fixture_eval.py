"""Every dataset driver on the deterministic fixtures, and the results table
(the counterpart of scripts/run_fixture_eval.py together with
scripts/write_results_md.py).

Usage: python -m orb_slam2_with_comment_tpu_torch.examples.run_fixture_eval
       [--root R] [--frames 120] [--skip-gen] [--skip-run] [--out PATH]
       [--device cuda] [--workers 1]

Writes the fixtures into R with dataio/fixtures.py (unless ``--skip-gen``),
runs the six drivers' ``main`` each in a working directory of its own
under R (unless ``--skip-run``): rgbd_tum (run_tum), rgbd_tum --auto on
the two-lap revisit (run_tum_loop), stereo_kitti (run_kitti),
stereo_euroc (run_euroc), mono_tum (run_mono) and mono_tum --auto on the
revisit (run_mono_loop). Then it scores whatever run directories exist
(ATE, RPE at delta 1 where more than 30 frames pair up, KITTI segment
drift, loops closed from run_summary.json) and writes the table to
``--out``, by default R/RESULTS.md; runs not found are listed as pending.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os

import numpy as np

from ..dataio import fixtures
from ..evaluation.ate import ate_rmse
from ..evaluation.rpe import kitti_segment_drift, rpe
from ..evaluation.trajectory import (associate, read_kitti, read_kitti_full,
                                     read_tum, read_tum_full)

# run directory: (driver, fixture, --auto, arguments after the settings)
RUNS = {
    "run_tum": ("rgbd_tum", "tum_fixture", False, ()),
    "run_tum_loop": ("rgbd_tum", "tum_loop_fixture", True, ()),
    "run_kitti": ("stereo_kitti", "kitti_fixture", False, ()),
    "run_euroc": ("stereo_euroc", "euroc_fixture", False,
                  ("mav0", "timestamps.txt")),
    "run_mono": ("mono_tum", "tum_fixture", False, ()),
    "run_mono_loop": ("mono_tum", "tum_loop_fixture", True, ()),
}


def run_drivers(root: str, device: str = "cuda") -> None:
    for run_dir, (name, fix, auto, extra) in RUNS.items():
        seq = os.path.abspath(os.path.join(root, fix))
        argv = [name, os.path.join(seq, "settings.yaml")]
        argv += [os.path.join(seq, a) for a in extra] if extra else [seq]
        argv += (["--auto"] if auto else []) + ["--device", device]
        wd = os.path.join(root, run_dir)
        os.makedirs(wd, exist_ok=True)
        mod = importlib.import_module(f"{__package__}.{name}")
        with contextlib.chdir(wd):
            rc = mod.main(argv)
        if rc:
            raise RuntimeError(f"{name} in {wd} returned {rc}")


def tum_metrics(est_path: str, gt_path: str, with_scale: bool = False):
    """ATE of the frames whose timestamps pair with the ground truth's,
    and the RPE (delta 1) when more than 30 pair up."""
    ts_e, R_e, t_e = read_tum_full(est_path)
    ts_g, R_g, t_g = read_tum_full(gt_path)
    pairs = associate(ts_e, ts_g)
    ia = [p[0] for p in pairs]
    ib = [p[1] for p in pairs]
    c_e = np.stack([-(R.T @ t) for R, t in zip(R_e[ia], t_e[ia])])
    c_g = np.stack([-(R.T @ t) for R, t in zip(R_g[ib], t_g[ib])])
    out = {"tracked": len(ts_e),
           "ate_rmse_m": float(ate_rmse(c_e, c_g, with_scale=with_scale))}
    if len(pairs) > 30:
        r = rpe(R_e[ia], t_e[ia], R_g[ib], t_g[ib], delta=1)
        out["rpe_trans_rmse_m"] = r["trans_rmse"]
        out["rpe_rot_rmse_deg"] = float(np.degrees(r["rot_rmse"]))
    return out


def kitti_metrics(est_path: str, gt_path: str):
    c_e, c_g = read_kitti(est_path), read_kitti(gt_path)
    R_e, t_e = read_kitti_full(est_path)
    R_g, t_g = read_kitti_full(gt_path)
    n = min(len(c_e), len(c_g))
    drift = kitti_segment_drift(R_e[:n], t_e[:n], R_g[:n], t_g[:n],
                                lengths=(1, 2))  # the fixture spans ~2.6 m
    return {"frames": len(c_g), "tracked": len(c_e),
            "ate_rmse_m": float(ate_rmse(c_e[:n], c_g[:n])),
            "drift_trans_pct": drift["trans_pct"],
            "drift_rot_deg_per_m": drift["rot_deg_per_m"]}


def mono_metrics(est_path: str, gt_path: str, min_pairs: int = 0):
    """Similarity-aligned ATE of the frames (or keyframes) of a TUM file
    that pair with the ground truth's; nan with ``min_pairs`` or fewer."""
    ts_e, c_e = read_tum(est_path)
    ts_g, c_g = read_tum(gt_path)
    pairs = associate(ts_e, ts_g)
    ia = [p[0] for p in pairs]
    ib = [p[1] for p in pairs]
    ate = (float(ate_rmse(c_e[ia], c_g[ib], with_scale=True))
           if len(pairs) > min_pairs else float("nan"))
    return {"tracked": len(ts_e), "ate_rmse_m_scaled": ate}


def _loops(root: str, run_dir: str):
    try:
        with open(os.path.join(root, run_dir, "run_summary.json")) as f:
            return json.load(f)["n_loops_closed"]
    except (OSError, ValueError, KeyError):
        return "?"


def score_runs(root: str) -> dict:
    """The scores of every run directory under ``root`` whose trajectory
    file exists, by run directory."""
    def path(d, f="CameraTrajectory.txt"):
        p = os.path.join(root, d, f)
        return p if os.path.exists(p) and os.path.getsize(p) > 0 else None

    def gt(fix, f="groundtruth.txt"):
        return os.path.join(root, fix, f)

    out = {}
    if path("run_tum"):
        out["run_tum"] = tum_metrics(path("run_tum"), gt("tum_fixture"))
    if path("run_tum_loop"):
        out["run_tum_loop"] = dict(
            tum_metrics(path("run_tum_loop"), gt("tum_loop_fixture")),
            loops_closed=_loops(root, "run_tum_loop"))
    if path("run_kitti"):
        out["run_kitti"] = kitti_metrics(
            path("run_kitti"), gt("kitti_fixture", "poses_gt.txt"))
    if path("run_euroc"):
        out["run_euroc"] = tum_metrics(
            path("run_euroc"), gt("euroc_fixture", "groundtruth_tum.txt"))
    if path("run_mono", "KeyFrameTrajectory.txt"):
        out["run_mono"] = mono_metrics(
            path("run_mono", "KeyFrameTrajectory.txt"), gt("tum_fixture"))
    if path("run_mono_loop"):
        out["run_mono_loop"] = dict(
            mono_metrics(path("run_mono_loop"), gt("tum_loop_fixture"),
                         min_pairs=10),
            loops_closed=_loops(root, "run_mono_loop"))
    return out


def fmt_ate(m: float) -> str:
    return "n/a" if np.isnan(m) else f"{m * 100:.1f} cm"


def fmt_rpe(r: dict) -> str:
    if "rpe_trans_rmse_m" not in r:
        return "—"
    return (f"{r['rpe_trans_rmse_m'] * 1000:.1f} mm / "
            f"{r['rpe_rot_rmse_deg']:.3f}°")


LABELS = {
    "run_tum": "TUM-format RGB-D (rgbd_tum)",
    "run_tum_loop": "TUM-format RGB-D 2-lap revisit (rgbd_tum --auto, "
                    "loop closing)",
    "run_kitti": "KITTI-format stereo (stereo_kitti)",
    "run_euroc": "EuRoC-format stereo, raw distorted input rectified "
                 "online (stereo_euroc)",
    "run_mono": "TUM-format mono (mono_tum, Sim3-aligned)",
    "run_mono_loop": "TUM-format mono 2-lap revisit (mono_tum --auto, loop "
                     "closing, Sim3-aligned)",
}


def table_rows(results: dict, frames: int) -> dict:
    """The table's row of each scored run, by run directory."""
    rows = {}
    for d, r in results.items():
        if d == "run_kitti":
            cells = (r["frames"], r["tracked"], fmt_ate(r["ate_rmse_m"]),
                     "—", f"drift {r['drift_trans_pct']:.2f}% / "
                     f"{r['drift_rot_deg_per_m']:.3f}°/m")
        elif d.startswith("run_mono"):
            tracked = (f"{r['tracked']} KFs" if d == "run_mono"
                       else r["tracked"])
            extra = ("monocular gauge" if d == "run_mono"
                     else f"{r['loops_closed']} loop(s) closed")
            cells = (frames, tracked, fmt_ate(r["ate_rmse_m_scaled"]), "—",
                     extra)
        else:
            extra = {"run_tum": "",
                     "run_euroc": "radtan k1=-0.2 k2=0.05"}.get(
                d, f"{r.get('loops_closed')} loop(s) closed")
            cells = (frames, r["tracked"], fmt_ate(r["ate_rmse_m"]),
                     fmt_rpe(r), extra)
        rows[d] = f"| {LABELS[d]} | " + " | ".join(map(str, cells)) + " |"
    return rows


def write_table(results: dict, frames: int, out: str) -> str:
    rows = table_rows(results, frames)
    pending = [LABELS[d] for d in RUNS if d not in rows]
    lines = [
        "# RESULTS — dataset-path runs of the PyTorch port",
        "",
        "The port's drivers on the deterministic fixtures of "
        "dataio/fixtures.py (synthetic sequences in the real on-disk "
        "formats): PNG decode, the readers, the drivers, trajectory export "
        f"and the evaluators. Fixture length {frames} frames (KITTI: the "
        "frames column).",
        "",
        "| run | frames | tracked/KFs | ATE RMSE | RPE Δ1 (t/rot) | extra |",
        "|---|---|---|---|---|---|",
    ] + [rows[d] for d in RUNS if d in rows] + [""]
    if pending:
        lines += [f"Pending (no trajectory file yet): {', '.join(pending)}.",
                  ""]
    text = "\n".join(lines)
    with open(out, "w") as f:
        f.write(text)
    return text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default="fixtures")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--skip-gen", action="store_true")
    ap.add_argument("--skip-run", action="store_true",
                    help="only score the run directories under --root")
    ap.add_argument("--out", default=None,
                    help="the table's file (default <root>/RESULTS.md)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=1,
                    help="render the fixtures in this many processes")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    if not args.skip_run:
        if not args.skip_gen:  # the script's sizes for --frames
            fixtures.main([root, "--frames", str(args.frames),
                           "--workers", str(args.workers)])
        run_drivers(root, args.device)
    print(write_table(score_runs(root), args.frames,
                      args.out or os.path.join(root, "RESULTS.md")))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
