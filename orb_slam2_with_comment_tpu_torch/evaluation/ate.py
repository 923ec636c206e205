"""Absolute trajectory error (ATE), evo/TUM-script compatible (the port's
copy of evaluation/ate.py; numpy only).

Umeyama/Horn alignment (SE3, or Sim3 for monocular runs) of estimated
camera centers against ground truth, then the RMSE of the residuals
(reference workflow: README.md:157-161, associate.py + evaluate_ate.py).
"""
from __future__ import annotations

import numpy as np


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares similarity aligning est -> gt. est/gt: [N, 3].

    Returns (s, R, t) minimizing || gt - (s R est + t) ||^2.
    """
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    ec = est - mu_e
    gc = gt - mu_g
    Sigma = gc.T @ ec / len(est)
    U, D, Vt = np.linalg.svd(Sigma)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (ec ** 2).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_centers: np.ndarray, gt_centers: np.ndarray,
             with_scale: bool = False) -> float:
    """RMSE of aligned camera-center differences (meters)."""
    s, R, t = align_umeyama(est_centers, gt_centers, with_scale)
    aligned = (s * (R @ est_centers.T)).T + t
    err = aligned - gt_centers
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def camera_centers(Rs: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """World camera centers from world->camera poses: C = -R^T t."""
    return -np.einsum("nij,ni->nj", Rs, ts)
