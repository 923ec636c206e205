"""Plain projection and descriptor searches: the reference the tracker's
matches are compared with.

The three searches a tracked frame runs, written from ORB-SLAM2's
``ORBmatcher`` as the port states them (``matching/search.py`` and
``matching/core.py`` at commit 41c5463), query by query in NumPy:

- ``motion_model``: SearchByProjection against the last frame
  (ORBmatcher.cc:1540+): the last frame's landmarks projected with the
  predicted pose, a window ``th * 1.2^octave`` wide, the query's octave
  +-1, the right coordinate within the same window where the target has
  one, the best distance at most ``desc_th``, the rotation histogram;
- ``local_points``: SearchByProjection against the local map
  (ORBmatcher.cc:59-155, Frame::isInFrustum, MapPoint::PredictScale): the
  frustum test, a window of (2.5 if the viewing cosine is over 0.998,
  else 4) ``* th * 1.2^level``, octaves level-1 .. level, the stereo
  gate, features already matched left out, the best at most ``desc_th``,
  the 0.8 ratio test where best and runner-up share an octave;
- ``brute``: the reference keyframe's sweep (SearchByBoW's stand-in):
  every valid pair, the best at most 50, the ratio test, the rotation
  histogram.

Each keeps, per target, the query of the lowest distance (ties to the
lowest query), and returns ``{query: target}``. The best is the lowest
distance, ties to the lowest target; the runner-up the lowest over the
other targets, ties to the lowest. It imports nothing of the port.

``dt`` is the precision of the geometry (the projection, the frustum, the
angles): float32 for the reference, bfloat16 for the control. Distances
are exact integers either way.
"""
from __future__ import annotations

import math

import numpy as np
import torch

TH_LOW, TH_HIGH = 50, 100
HISTO_LENGTH = 30
BIG = 1 << 20
SCALES = np.float32(1.2) ** np.arange(8, dtype=np.float32)
LOG_SCALE = math.log(1.2)
BLOCK = 256  # queries a block of the distance matrix

_POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _np(x, dt=None):
    """A tensor on the host as NumPy, rounded through ``dt`` if given."""
    if dt is not None and x.is_floating_point():
        x = x.to(dt).to(torch.float32)
    return x.detach().cpu().numpy()


def _round(x: np.ndarray, dt) -> np.ndarray:
    """float32 NumPy values rounded to ``dt``."""
    if dt in (None, torch.float32):
        return x.astype(np.float32)
    return torch.as_tensor(np.asarray(x, np.float32)).to(dt).to(
        torch.float32).numpy()


def hamming(desc_q: np.ndarray, desc_t: np.ndarray) -> np.ndarray:
    """[Q, N] bit distances of 256-bit descriptors stored as [.., 8] int32."""
    bq = desc_q.astype(np.int32).view(np.uint8).reshape(len(desc_q), 32)
    bt = desc_t.astype(np.int32).view(np.uint8).reshape(len(desc_t), 32)
    out = np.empty((len(bq), len(bt)), np.int32)
    for a in range(0, len(bq), BLOCK):
        x = bq[a:a + BLOCK, None, :] ^ bt[None, :, :]
        out[a:a + BLOCK] = _POP8[x].sum(-1, dtype=np.int32)
    return out


def best_two(dist: np.ndarray, cand: np.ndarray):
    """Per query over its candidates: (best, its target, runner-up, its
    target); BIG where a query has none."""
    d = np.where(cand, dist, BIG)
    idx = d.argmin(1)
    best = d[np.arange(len(d)), idx]
    d2 = d.copy()
    d2[np.arange(len(d)), idx] = BIG + 1
    idx2 = d2.argmin(1)
    second = np.minimum(d2[np.arange(len(d)), idx2], BIG)
    return best, idx, second, idx2


def rotation_filter(angle_q, angle_t_of_match, matched):
    """Keep matches whose bin of the angle difference is among the three
    fullest (bins 2 and 3 only at 0.1 of bin 1's count or more), counting
    ties to the lower bin."""
    rot = (angle_q - angle_t_of_match) * np.float32(180.0 / math.pi)
    rot = np.where(rot < 0, rot + np.float32(360.0), rot)
    b = np.round(rot * np.float32(HISTO_LENGTH / 360.0)).astype(np.int64)
    b = np.where(b == HISTO_LENGTH, 0, b)
    counts = np.bincount(b[matched], minlength=HISTO_LENGTH)
    order = np.argsort(-counts, kind="stable")[:3]
    keep = b == order[0]
    for k in (1, 2):
        if counts[order[k]] >= 0.1 * counts[order[0]]:
            keep |= b == order[k]
    return matched & keep


def one_per_target(idx, best, matched) -> dict:
    """{query: target}: per target the matched query of the lowest
    distance, ties to the lowest query."""
    won = {}
    for q in np.flatnonzero(matched):
        j = int(idx[q])
        if j not in won or best[q] < best[won[j]]:
            won[j] = int(q)
    return {q: j for j, q in won.items()}


def _project(cam, R, t, pw, dt):
    fx, fy, cx, cy, bf = (np.float32(c) for c in cam)
    Xc = _round(pw @ R.T + t, dt)
    z = Xc[:, 2]
    iz = _round(np.float32(1.0) / np.where(np.abs(z) < 1e-9, 1e-9, z), dt)
    u = _round(fx * Xc[:, 0] * iz + cx, dt)
    v = _round(fy * Xc[:, 1] * iz + cy, dt)
    return z, u, v, _round(u - bf * iz, dt)


def _window(tx, ty, tur, u, v, ur_pred, radius):
    """[Q, N]: the target within ``radius`` of (u, v) in both axes, and its
    right coordinate within it where it has one."""
    r = radius[:, None]
    inside = ((np.abs(tx[None, :] - u[:, None]) < r)
              & (np.abs(ty[None, :] - v[:, None]) < r))
    stereo = np.where(tur[None, :] >= 0,
                      np.abs(tur[None, :] - ur_pred[:, None]) < r, True)
    return inside & stereo


def motion_model(p: dict, dt=torch.float32) -> dict:
    """The last frame's landmarks against the current frame's features."""
    R, t, pw = (_np(p[k], dt) for k in ("R", "t", "prev_pw"))
    z, u, v, ur = _project(p["cam"], R, t, pw, dt)
    oq = _np(p["prev_octave"]).astype(np.int64)
    ot = _np(p["octave"]).astype(np.int64)
    ok_q = (_np(p["prev_has_point"]) & _np(p["prev_valid"]) & (z > 0)
            & (u >= 0) & (u < p["width"]) & (v >= 0) & (v < p["height"]))
    radius = _round(np.float32(p["th"]) * SCALES[oq], dt)
    xy = _np(p["xy"])
    cand = (_window(xy[:, 0], xy[:, 1], _np(p["ur"]), u, v, ur, radius)
            & (ot[None, :] >= oq[:, None] - 1)
            & (ot[None, :] <= oq[:, None] + 1)
            & ok_q[:, None] & _np(p["valid"])[None, :])
    dist = hamming(_np(p["prev_desc"]), _np(p["desc"]))
    best, idx, _, _ = best_two(dist, cand)
    matched = best <= p["desc_th"]
    matched = rotation_filter(_np(p["prev_angle"], dt), _np(p["angle"], dt)[
        idx], matched)
    return one_per_target(idx, best, matched)


def local_points(p: dict, dt=torch.float32) -> dict:
    """The local map's landmarks against the current frame's features."""
    R, t, pw, normal, dmin, dmax = (_np(p[k], dt) for k in (
        "R", "t", "pw", "normal", "dmin", "dmax"))
    z, u, v, ur = _project(p["cam"], R, t, pw, dt)
    Ow = -(R.T @ t)
    PO = _round(pw - Ow, dt)
    dist3 = _round(np.linalg.norm(PO, axis=-1), dt)
    view_cos = _round((PO * normal).sum(-1) / np.maximum(dist3, 1e-9), dt)
    ratio = np.maximum(dmax / np.maximum(dist3, 1e-6), 1.0)
    level = np.clip(np.ceil(np.log(ratio) / LOG_SCALE), 0, 7).astype(np.int64)
    visible = (_np(p["lm_valid"]) & (z > 0) & (u >= 0) & (u < p["width"])
               & (v >= 0) & (v < p["height"]) & (dist3 >= 0.8 * dmin)
               & (dist3 <= 1.2 * dmax) & (view_cos >= 0.5))
    radius = _round(np.where(view_cos > 0.998, np.float32(2.5),
                             np.float32(4.0)) * np.float32(p["th"])
                    * SCALES[level], dt)
    xy = _np(p["xy"])
    ot = _np(p["octave"]).astype(np.int64)
    cand = (_window(xy[:, 0], xy[:, 1], _np(p["ur"]), u, v, ur, radius)
            & (ot[None, :] >= level[:, None] - 1)
            & (ot[None, :] <= level[:, None])
            & visible[:, None] & _np(p["valid"])[None, :]
            & ~_np(p["already"])[None, :])
    dist = hamming(_np(p["lm_desc"]), _np(p["desc"]))
    best, idx, second, idx2 = best_two(dist, cand)
    matched = best <= p["desc_th"]
    same = ot[idx] == ot[idx2]
    matched &= np.where(same, best.astype(np.float32)
                        < np.float32(0.8) * second.astype(np.float32), True)
    return one_per_target(idx, best, matched)


def brute(p: dict, dt=torch.float32) -> dict:
    """Every valid pair of the reference keyframe's features (queries) and
    the frame's (targets)."""
    cand = _np(p["valid_q"])[:, None] & _np(p["valid_t"])[None, :]
    dist = hamming(_np(p["desc_q"]), _np(p["desc_t"]))
    best, idx, second, _ = best_two(dist, cand)
    matched = best <= p["max_dist"]
    matched &= best.astype(np.float32) < np.float32(p["ratio"]) * \
        second.astype(np.float32)
    matched = rotation_filter(_np(p["angle_q"], dt), _np(p["angle_t"], dt)[
        idx], matched)
    return one_per_target(idx, best, matched)


SEARCHES = {"motion_model": motion_model, "local_points": local_points,
            "brute": brute}
