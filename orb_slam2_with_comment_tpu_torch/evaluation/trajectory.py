"""Trajectory files as numpy arrays: the TUM and KITTI formats that the
drivers write and the fixtures' ground truth uses, and TUM timestamp
association (the evaluation scripts' readers; numpy only).

TUM lines are ``timestamp tx ty tz qx qy qz qw`` (camera to world); KITTI
lines are the camera-to-world 3x4 matrix, row-major. ``*_full`` readers
return world-to-camera poses (R_cw, t_cw), the convention of the trackers.
"""
from __future__ import annotations

import numpy as np


def _quat_to_R(qx, qy, qz, qw):
    x, y, z, w = qx, qy, qz, qw
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _rows(path):
    with open(path) as f:
        return [[float(x) for x in ln.split()] for ln in f
                if ln.strip() and not ln.lstrip().startswith("#")]


def read_tum(path):
    """TUM file -> (timestamps [N], camera centers [N, 3]): the poses are
    camera to world, so the center is the translation."""
    v = _rows(path)
    return (np.asarray([r[0] for r in v]), np.asarray([r[1:4] for r in v]))


def read_tum_full(path):
    """TUM file -> (timestamps [N], R_cw [N, 3, 3], t_cw [N, 3])."""
    ts, Rs, tcs = [], [], []
    for v in _rows(path):
        Rwc = _quat_to_R(v[4], v[5], v[6], v[7])
        twc = np.asarray(v[1:4])
        Rs.append(Rwc.T)
        tcs.append(-Rwc.T @ twc)
        ts.append(v[0])
    return np.asarray(ts), np.asarray(Rs), np.asarray(tcs)


def read_kitti(path):
    """KITTI file -> camera centers [N, 3]."""
    return np.asarray(_rows(path)).reshape(-1, 3, 4)[:, :, 3]


def read_kitti_full(path):
    """KITTI file -> (R_cw [N, 3, 3], t_cw [N, 3])."""
    P = np.asarray(_rows(path)).reshape(-1, 3, 4)
    Rwc, twc = P[:, :, :3], P[:, :, 3]
    Rcw = np.transpose(Rwc, (0, 2, 1))
    return Rcw, -np.einsum("nij,nj->ni", Rcw, twc)


def associate(ts_a, ts_b, max_diff=0.02):
    """Pairs (i, j): for each timestamp of ``ts_a`` the nearest of the
    sorted ``ts_b`` within ``max_diff`` seconds, if any."""
    ib = np.searchsorted(ts_b, ts_a)
    out = []
    for i, t in enumerate(ts_a):
        best, bd = -1, max_diff
        for j in (ib[i] - 1, ib[i]):
            if 0 <= j < len(ts_b) and abs(ts_b[j] - t) <= bd:
                best, bd = j, abs(ts_b[j] - t)
        if best >= 0:
            out.append((i, best))
    return out
