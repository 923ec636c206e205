"""Relative pose error (RPE), TUM-script / KITTI-devkit compatible (the
port's copy of evaluation/rpe.py; numpy only).

In-repo replacement for the external evaluation workflow the reference
documents (reference: README.md:157-167 points users at the TUM benchmark
tools, whose evaluate_rpe.py computes drift over a fixed frame/time delta;
the KITTI devkit instead averages translational drift over path segments
of 100..800 m). Both protocols operate on world<-camera (Twc) pose
sequences; we take world->camera (Rcw, tcw) like the rest of the package
and invert internally.
"""
from __future__ import annotations

import numpy as np


def _se3_from_rt(Rs: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """Stack [N,3,3]+[N,3] world->camera into [N,4,4] camera->world Twc."""
    N = len(Rs)
    T = np.tile(np.eye(4), (N, 1, 1))
    Rwc = np.transpose(Rs, (0, 2, 1))
    T[:, :3, :3] = Rwc
    T[:, :3, 3] = -np.einsum("nij,nj->ni", Rwc, ts)
    return T


def _rel(Ti: np.ndarray, Tj: np.ndarray) -> np.ndarray:
    """Relative motion Ti^-1 Tj for stacked [M,4,4]."""
    Ri = Ti[:, :3, :3]
    ti = Ti[:, :3, 3]
    RiT = np.transpose(Ri, (0, 2, 1))
    out = np.tile(np.eye(4), (len(Ti), 1, 1))
    out[:, :3, :3] = RiT @ Tj[:, :3, :3]
    out[:, :3, 3] = np.einsum("mij,mj->mi", RiT, Tj[:, :3, 3] - ti)
    return out


def _rot_angle(R: np.ndarray) -> np.ndarray:
    tr = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    return np.arccos(tr)


def rpe(est_R: np.ndarray, est_t: np.ndarray,
        gt_R: np.ndarray, gt_t: np.ndarray, delta: int = 1):
    """TUM-protocol RPE at a fixed frame delta.

    est/gt are world->camera rotation [N,3,3] and translation [N,3] at
    matched timestamps. Returns a dict with translational RMSE (m) and
    rotational RMSE (rad) of the per-pair relative-motion error
    E = (Qi^-1 Qi+d)^-1 (Pi^-1 Pi+d).
    """
    Te = _se3_from_rt(est_R, est_t)
    Tg = _se3_from_rt(gt_R, gt_t)
    if len(Te) <= delta:
        raise ValueError("trajectory shorter than delta")
    de = _rel(Te[:-delta], Te[delta:])
    dg = _rel(Tg[:-delta], Tg[delta:])
    err = _rel(dg, de)
    terr = np.linalg.norm(err[:, :3, 3], axis=1)
    rerr = _rot_angle(err[:, :3, :3])
    return {
        "trans_rmse": float(np.sqrt((terr ** 2).mean())),
        "trans_mean": float(terr.mean()),
        "rot_rmse": float(np.sqrt((rerr ** 2).mean())),
        "rot_mean": float(rerr.mean()),
        "n_pairs": int(len(terr)),
    }


def kitti_segment_drift(est_R: np.ndarray, est_t: np.ndarray,
                        gt_R: np.ndarray, gt_t: np.ndarray,
                        lengths=(100, 200, 300, 400, 500, 600, 700, 800)):
    """KITTI-devkit style drift: average translational error (%) and
    rotational error (deg/m) over all subsequences of the given path
    lengths, measured along the ground-truth trajectory.
    """
    Te = _se3_from_rt(est_R, est_t)
    Tg = _se3_from_rt(gt_R, gt_t)
    gc = Tg[:, :3, 3]
    step = np.linalg.norm(np.diff(gc, axis=0), axis=1)
    dist = np.concatenate([[0.0], np.cumsum(step)])

    t_errs, r_errs = [], []
    for L in lengths:
        # first index j >= i with dist[j] - dist[i] >= L
        j_of = np.searchsorted(dist, dist + L)
        for i in range(0, len(dist), 10):
            j = j_of[i]
            if j >= len(dist):
                break
            de = _rel(Te[i:i + 1], Te[j:j + 1])[0]
            dg = _rel(Tg[i:i + 1], Tg[j:j + 1])[0]
            E = _rel(dg[None], de[None])[0]
            t_errs.append(np.linalg.norm(E[:3, 3]) / L)
            r_errs.append(float(_rot_angle(E[None, :3, :3])[0]) / L)
    if not t_errs:
        return {"trans_pct": float("nan"), "rot_deg_per_m": float("nan"),
                "n_segments": 0}
    return {
        "trans_pct": float(np.mean(t_errs) * 100.0),
        "rot_deg_per_m": float(np.degrees(np.mean(r_errs))),
        "n_segments": len(t_errs),
    }
