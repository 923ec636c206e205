"""Projection and brute-force search modes of the tracking slice (port of
matching/search.py).

Candidate gating (search windows, predicted scale levels, stereo and chi2
gates) builds a [queries x features] boolean mask; matching is one fused
masked Hamming sweep. Poses are world->camera (R, t).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3
from ..ops import hamming
from . import core

N_LEVELS = 8
SCALE = 1.2
SCALE_FACTORS = np.asarray([SCALE ** i for i in range(N_LEVELS)], np.float32)
SIGMA2 = SCALE_FACTORS * SCALE_FACTORS
INV_SIGMA2 = (1.0 / SIGMA2).astype(np.float32)
LOG_SCALE = math.log(SCALE)


def _table_at(table: np.ndarray, octave: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(table, device=octave.device)[octave.long()]


def scale_at(octave):
    return _table_at(SCALE_FACTORS, octave)


def sigma2_at(octave):
    return _table_at(SIGMA2, octave)


def inv_sigma2_at(octave):
    return _table_at(INV_SIGMA2, octave)


class FeatureSet(NamedTuple):
    xy: torch.Tensor  # [N, 2] float32
    ur: torch.Tensor  # [N] right-image u (< 0 for mono observations)
    octave: torch.Tensor  # [N] int32
    angle: torch.Tensor  # [N] float32
    desc: torch.Tensor  # [N, 8] int32
    valid: torch.Tensor  # [N] bool


class LandmarkSet(NamedTuple):
    pw: torch.Tensor  # [M, 3]
    normal: torch.Tensor  # [M, 3] mean viewing direction
    dmin: torch.Tensor  # [M]
    dmax: torch.Tensor  # [M]
    desc: torch.Tensor  # [M, 8] int32
    valid: torch.Tensor  # [M] bool


class Frustum(NamedTuple):
    visible: torch.Tensor  # [M] bool
    uv: torch.Tensor  # [M, 2]
    ur: torch.Tensor  # [M]
    view_cos: torch.Tensor  # [M]
    level: torch.Tensor  # [M] predicted octave
    dist: torch.Tensor  # [M]


def predict_scale(dist: torch.Tensor, dmax: torch.Tensor) -> torch.Tensor:
    """MapPoint::PredictScale (reference: MapPoint.cc:404-436)."""
    ratio = (dmax / dist.clamp(min=1e-6)).clamp(min=1.0)
    lvl = torch.ceil(torch.log(ratio) / LOG_SCALE).to(torch.int32)
    return lvl.clamp(0, N_LEVELS - 1)


def _project(cam, R, t, pw):
    Xc = se3.transform(R, t, pw)
    z = Xc[..., 2]
    iz = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
    u = cam.fx * Xc[..., 0] * iz + cam.cx
    v = cam.fy * Xc[..., 1] * iz + cam.cy
    return z, u, v, u - cam.bf * iz


def frustum_check(cam, R, t, lm: LandmarkSet, width, height,
                  view_cos_limit: float = 0.5) -> Frustum:
    """Frame::isInFrustum (reference: Frame.cc:274-342)."""
    z, u, v, ur = _project(cam, R, t, lm.pw)
    Ow = -(R.T @ t)
    PO = lm.pw - Ow
    dist = torch.linalg.norm(PO, dim=-1)
    view_cos = (PO * lm.normal).sum(-1) / dist.clamp(min=1e-9)
    level = predict_scale(dist, lm.dmax)
    visible = (lm.valid & (z > 0) & (u >= 0) & (u < width) & (v >= 0)
               & (v < height) & (dist >= 0.8 * lm.dmin)
               & (dist <= 1.2 * lm.dmax) & (view_cos >= view_cos_limit))
    return Frustum(visible, torch.stack([u, v], -1), ur, view_cos, level, dist)


def _in_window(feats: FeatureSet, u, v, radius):
    du = feats.xy[None, :, 0] - u[:, None]
    dv = feats.xy[None, :, 1] - v[:, None]
    return (du.abs() < radius[:, None]) & (dv.abs() < radius[:, None]), du, dv


def _stereo_ok(feats: FeatureSet, ur_pred, radius):
    return torch.where(feats.ur[None, :] >= 0,
                       (feats.ur[None, :] - ur_pred[:, None]).abs()
                       < radius[:, None], True)


def search_local_points(cam, R, t, lm: LandmarkSet, fr: Frustum,
                        feats: FeatureSet, th=1.0, ratio: float = 0.8,
                        already_matched=None, desc_th=core.TH_HIGH):
    """SearchByProjection vs the local map (reference: ORBmatcher.cc:59-155):
    radius (2.5 if viewCos > 0.998 else 4.0) * th * scale[pred], feature
    octave in [pred-1, pred], stereo gate, best <= desc_th, ratio test only
    when best and runner-up share a level. Returns (idx, dist, matched)."""
    r = torch.where(fr.view_cos > 0.998, 2.5, 4.0)
    radius = r * th * scale_at(fr.level)
    in_win, _, _ = _in_window(feats, fr.uv[:, 0], fr.uv[:, 1], radius)
    lvl_ok = ((feats.octave[None, :] >= fr.level[:, None] - 1)
              & (feats.octave[None, :] <= fr.level[:, None]))
    mask = (in_win & lvl_ok & _stereo_ok(feats, fr.ur, radius)
            & fr.visible[:, None] & feats.valid[None, :])
    if already_matched is not None:
        mask &= ~already_matched[None, :]
    best, idx, second, idx2 = hamming.masked_best_two(lm.desc, feats.desc,
                                                      mask)
    matched = best <= desc_th
    same_level = feats.octave[idx] == feats.octave[idx2]
    matched &= torch.where(same_level, core.ratio_ok(best, second, ratio),
                           True)
    matched &= core.dedupe_matches(idx, best, matched, feats.desc.shape[0])
    return idx, best, matched


def search_by_projection_frame(cam, R, t, prev_pw, prev_feats: FeatureSet,
                               prev_has_point, feats: FeatureSet, th,
                               width, height, desc_th=core.TH_HIGH):
    """SearchByProjection vs the last frame with the motion model (reference:
    ORBmatcher.cc:1540+), octave window [o-1, o+1] (the slice's RGB-D path
    runs neither the forward nor the backward variant), TH_HIGH,
    rotation-histogram check, no ratio test."""
    z, u, v, ur_pred = _project(cam, R, t, prev_pw)
    in_img = (z > 0) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    radius = th * scale_at(prev_feats.octave)
    in_win, _, _ = _in_window(feats, u, v, radius)
    oq = prev_feats.octave[:, None]
    ot = feats.octave[None, :]
    mask = (in_win & (ot >= oq - 1) & (ot <= oq + 1)
            & _stereo_ok(feats, ur_pred, radius)
            & (in_img & prev_has_point & prev_feats.valid)[:, None]
            & feats.valid[None, :])
    return core.windowed_match(prev_feats.desc, feats.desc, mask, desc_th,
                               angle_q=prev_feats.angle, angle_t=feats.angle)


def search_brute(desc_q, desc_t, valid_q, valid_t, ratio: float,
                 max_dist: int = core.TH_LOW, angle_q=None, angle_t=None):
    """Full masked Hamming sweep standing in for SearchByBoW (reference:
    ORBmatcher.cc:211-344); a superset of the bucketed candidates."""
    mask = valid_q[:, None] & valid_t[None, :]
    return core.windowed_match(desc_q, desc_t, mask, max_dist, ratio=ratio,
                               angle_q=angle_q, angle_t=angle_t)


def fuse_candidates(cam, R, t, lm: LandmarkSet, feats: FeatureSet,
                    width, height, th: float = 3.0):
    """Fuse projection matching (reference: ORBmatcher.cc:977+): frustum,
    chi2 reprojection gate (5.99 mono / 7.8 stereo), level in [pred-1,
    pred], radius th * scale[pred], best <= TH_LOW."""
    fr = frustum_check(cam, R, t, lm, width, height)
    radius = th * scale_at(fr.level)
    in_win, du, dv = _in_window(feats, fr.uv[:, 0], fr.uv[:, 1], radius)
    lvl_ok = ((feats.octave[None, :] >= fr.level[:, None] - 1)
              & (feats.octave[None, :] <= fr.level[:, None]))
    err2 = du * du + dv * dv
    dur = fr.ur[:, None] - feats.ur[None, :]
    inv_s2 = inv_sigma2_at(feats.octave)[None, :]
    chi_ok = torch.where(feats.ur[None, :] >= 0,
                         (err2 + dur * dur) * inv_s2 <= 7.8,
                         err2 * inv_s2 <= 5.99)
    mask = (in_win & lvl_ok & chi_ok & fr.visible[:, None]
            & feats.valid[None, :])
    best, idx, _, _ = hamming.masked_best_two(lm.desc, feats.desc, mask)
    matched = best <= core.TH_LOW
    matched &= core.dedupe_matches(idx, best, matched, feats.desc.shape[0])
    return idx, best, matched


def search_by_sim3(cam, R12, t12, s12, R1w, t1w, R2w, t2w,
                   lm1: LandmarkSet, lm2: LandmarkSet, feats1: FeatureSet,
                   feats2: FeatureSet, th: float = 7.5):
    """Mutual Sim3 cross-projection matching (reference: ORBmatcher.cc:
    1285+ SearchBySim3) for per-feature landmark bundles (landmark row i
    is feature i of its keyframe, the loop closer's layout): keyframe 2's
    landmarks go into image 1 through S12 and keyframe 1's into image 2
    through S12^-1, radius th * scale[predicted level], TH_HIGH, no ratio
    test; only mutually consistent pairs are kept.
    Returns (idx [M1] feature of keyframe 2 per landmark of keyframe 1,
    mutual [M1])."""
    def project_side(Rrel, trel, srel, Rw, tw, lm_src: LandmarkSet,
                     feats_dst: FeatureSet):
        Xc_dst = srel * (se3.transform(Rw, tw, lm_src.pw) @ Rrel.T) + trel
        z = Xc_dst[:, 2]
        iz = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
        u = cam.fx * Xc_dst[:, 0] * iz + cam.cx
        v = cam.fy * Xc_dst[:, 1] * iz + cam.cy
        dist = torch.linalg.norm(Xc_dst, dim=-1)
        lvl = predict_scale(dist, lm_src.dmax)
        ok = (z > 0) & (dist >= lm_src.dmin) & (dist <= lm_src.dmax) \
            & lm_src.valid
        in_win, _, _ = _in_window(feats_dst, u, v, th * scale_at(lvl))
        ot = feats_dst.octave[None, :]
        mask = (in_win & (ot >= lvl[:, None] - 1) & (ot <= lvl[:, None] + 1)
                & ok[:, None] & feats_dst.valid[None, :])
        best, idx, _, _ = hamming.masked_best_two(lm_src.desc,
                                                  feats_dst.desc, mask)
        return idx, best <= core.TH_HIGH

    R21 = R12.T
    t21 = -(R21 @ t12) / s12
    idx_f1_of_lm2, ok21 = project_side(R12, t12, s12, R2w, t2w, lm2, feats1)
    idx_f2_of_lm1, ok12 = project_side(R21, t21, 1.0 / s12, R1w, t1w, lm1,
                                       feats2)
    lm2_of_lm1 = torch.where(ok12, idx_f2_of_lm1, -1)
    lm1_of_lm2 = torch.where(ok21, idx_f1_of_lm2, -1)
    back = lm1_of_lm2[lm2_of_lm1.clamp(0, lm1_of_lm2.shape[0] - 1).long()]
    ids = torch.arange(lm2_of_lm1.shape[0], dtype=torch.int32,
                       device=back.device)
    return lm2_of_lm1, (lm2_of_lm1 >= 0) & (back == ids)


def search_by_scw_projection(cam, Rcw, tcw, scw, lm: LandmarkSet,
                             feats: FeatureSet, already_matched, width: int,
                             height: int, th: float = 10.0):
    """Sim3 world->camera projection search (reference: ORBmatcher.cc:
    359-478, the loop-group projection of ComputeSim3, LoopClosing.cc:
    459-471): Rcw stays, tcw / scw is the SE3 translation; z > 0, in the
    image, distance within [dmin, dmax], viewing cos >= 0.5, feature level
    in [pred-1, pred], window th * scale[pred], TH_LOW, features already
    matched excluded. Returns (feat_idx [M], matched [M])."""
    t_se3 = tcw / scw.clamp(min=1e-12)
    z, u, v, _ = _project(cam, Rcw, t_se3, lm.pw)
    PO = lm.pw - (-(Rcw.T @ t_se3))
    dist = torch.linalg.norm(PO, dim=-1)
    view_cos = (PO * lm.normal).sum(-1) / dist.clamp(min=1e-9)
    lvl = predict_scale(dist, lm.dmax)
    ok = (lm.valid & (z > 0) & (u >= 0) & (u < width) & (v >= 0)
          & (v < height) & (dist >= lm.dmin) & (dist <= lm.dmax)
          & (view_cos >= 0.5))
    in_win, _, _ = _in_window(feats, u, v, th * scale_at(lvl))
    ot = feats.octave[None, :]
    mask = (in_win & (ot >= lvl[:, None] - 1) & (ot <= lvl[:, None])
            & ok[:, None] & feats.valid[None, :] & ~already_matched[None, :])
    best, idx, _, _ = hamming.masked_best_two(lm.desc, feats.desc, mask)
    return idx, best <= core.TH_LOW
