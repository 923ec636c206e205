"""Tracking and keyframe-maintenance steps (port of pipeline/steps.py).

Each function maps a MapState (and frame data) to a new MapState or a
measurement. Keyframe and landmark slots that the JAX package passes as
traced scalars are Python ints here: the host drives the state machine.
Reference call sites are noted per function.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3, triangulate
from ..mapstate.map import (MapState, add_observation, covisibility_weights,
                            landmark_obs_count, merge_landmarks, set_last)
from ..matching import search as msearch
from ..matching.search import FeatureSet, LandmarkSet, inv_sigma2_at, scale_at
from ..ops import hamming
from ..ops.fast import sort_top_k
from ..optim import ba, pose_opt
from ..optim.residuals import CamParams

N_LEVELS = 8
I32 = torch.int32
MAX_SCALE = float(msearch.SCALE_FACTORS[N_LEVELS - 1])


class FrameObs(NamedTuple):
    """Per-frame observation bundle."""
    feats: FeatureSet
    depth: torch.Tensor  # [N] depth or -1
    lm: torch.Tensor  # [N] int32 matched landmark or -1


def _rdiv(a: float, x: torch.Tensor) -> torch.Tensor:
    """a / x as a true division (``a / tensor`` multiplies by 1/x)."""
    return torch.div(x.new_tensor(a), x)


def make_feature_uvr(u, depth, bf: float):
    """mvuRight from depth (Frame::ComputeStereoFromRGBD): u - bf/d or -1."""
    return torch.where(depth > 0, u - _rdiv(bf, depth.clamp(min=1e-6)), -1.0)


def _ids(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


def _full(n: int, v: int, device) -> torch.Tensor:
    return torch.full((n,), v, dtype=I32, device=device)


def _kf_featureset(m: MapState, kf: int) -> FeatureSet:
    return FeatureSet(m.kf_xy[kf], m.kf_ur[kf], m.kf_octave[kf],
                      m.kf_angle[kf], m.kf_desc[kf], m.kf_feat_valid[kf])


def gather_mask_indices(mask: torch.Tensor, size: int):
    """Indices of the set entries of mask, lowest first, packed into a
    fixed [size] prefix: (idx, valid)."""
    idx = torch.argsort((~mask).to(torch.uint8), stable=True)[:size]
    return idx, mask[idx]


# ---------------------------------------------------------------------------
# keyframe insertion
# ---------------------------------------------------------------------------

def insert_keyframe(m: MapState, obs: FrameObs, R, t,
                    frame_id: int) -> MapState:
    """Copy the frame's features into keyframe slot n_kf and turn its
    landmark matches into observations (reference: CreateNewKeyFrame
    Tracking.cc:1251-1264)."""
    k = int(m.n_kf)
    f = obs.feats
    N = f.xy.shape[0]

    def put(a, v):
        a = a.clone()
        a[k] = v
        return a

    m = m._replace(
        kf_R=put(m.kf_R, R), kf_t=put(m.kf_t, t),
        kf_valid=put(m.kf_valid, True), kf_frame_id=put(m.kf_frame_id, frame_id),
        kf_xy=put(m.kf_xy, f.xy), kf_ur=put(m.kf_ur, f.ur),
        kf_depth=put(m.kf_depth, obs.depth), kf_octave=put(m.kf_octave, f.octave),
        kf_angle=put(m.kf_angle, f.angle), kf_desc=put(m.kf_desc, f.desc),
        kf_feat_valid=put(m.kf_feat_valid, f.valid), n_kf=m.n_kf + 1)
    dev = f.xy.device
    return add_observation(m, obs.lm.clamp(min=0), _full(N, k, dev),
                           _ids(N, dev), (obs.lm >= 0) & f.valid)


def _write_landmark_rows(m: MapState, slots, sel, pw, desc, normal, dmin,
                         dmax, ref_kf: int, n_new) -> MapState:
    """Masked write of new landmark rows into ``slots``."""
    def upd(a, v):
        keep = sel.reshape(-1, *([1] * (a.dim() - 1)))
        return set_last(a, slots, torch.where(keep, v, a[slots.long()]))

    return m._replace(
        lm_pw=upd(m.lm_pw, pw), lm_valid=upd(m.lm_valid, True),
        lm_desc=upd(m.lm_desc, desc), lm_normal=upd(m.lm_normal, normal),
        lm_dmin=upd(m.lm_dmin, dmin), lm_dmax=upd(m.lm_dmax, dmax),
        lm_first_kf=upd(m.lm_first_kf, ref_kf),
        lm_ref_kf=upd(m.lm_ref_kf, ref_kf),
        lm_visible=upd(m.lm_visible, 1), lm_found=upd(m.lm_found, 1),
        n_lm=m.n_lm + n_new)


def _insert_landmark_rows(m: MapState, pw, desc, normal, dmin, dmax,
                          ref_kf: int, create):
    """Append the rows selected by ``create`` into the first free landmark
    slots: (map, slot of each row, rows that found a slot)."""
    L = m.lm_pw.shape[0]
    slots = m.n_lm + torch.cumsum(create.to(I32), 0, dtype=I32) - 1
    create = create & (slots < L)
    safe = torch.where(create, slots, L - 1)
    m = _write_landmark_rows(m, safe, create, pw, desc, normal, dmin, dmax,
                             ref_kf, create.sum(dtype=I32))
    return m, safe, create


def create_depth_landmarks(m: MapState, cam: CamParams, kf: int,
                           th_depth: float) -> MapState:
    """Landmarks for keyframe ``kf``'s still-unmatched features with valid
    depth: all closer than th_depth, else the 100 closest (reference:
    Tracking.cc:1271-1324)."""
    N = m.kf_xy.shape[1]
    dev = m.kf_xy.device
    R, t = m.kf_R[kf], m.kf_t[kf]
    depth = m.kf_depth[kf]
    depth_ok = (depth > 0) & m.kf_feat_valid[kf] & (m.kf_lm[kf] < 0)
    is_close = depth_ok & (depth < th_depth)
    rank = torch.argsort(torch.argsort(torch.where(depth_ok, depth, 1e9),
                                       stable=True), stable=True)
    create = torch.where(is_close.sum() >= 100, is_close,
                         depth_ok & (rank < 100))
    xy = m.kf_xy[kf]
    z = depth
    x = (xy[:, 0] - cam.cx) / cam.fx * z
    y = (xy[:, 1] - cam.cy) / cam.fy * z
    Ow = -(R.T @ t)
    pw = torch.stack([x, y, z], -1) @ R + Ow
    dist = torch.linalg.norm(pw - Ow, dim=-1)
    normal = (pw - Ow) / dist.clamp(min=1e-9)[:, None]
    dmax = dist * scale_at(m.kf_octave[kf])
    m, slots, create = _insert_landmark_rows(
        m, pw, m.kf_desc[kf], normal, dmax / MAX_SCALE, dmax, kf, create)
    return add_observation(m, slots, _full(N, kf, dev), _ids(N, dev), create)


# ---------------------------------------------------------------------------
# two-view landmarks (the monocular map's only landmark source)
# ---------------------------------------------------------------------------

def insert_landmarks_two_view(m: MapState, cam, kf1: int, kf2: int, idx2, pw,
                              mask) -> MapState:
    """Insert triangulated landmarks anchored at kf1's features: row i is
    feature i of kf1 matched to feature idx2[i] of kf2, at world point
    pw[i] (reference: CreateInitialMapMonocular Tracking.cc:752-782 and the
    tail of LocalMapping::CreateNewMapPoints)."""
    N = idx2.shape[0]
    dev = idx2.device
    safe2 = idx2.clamp(min=0)
    mask = mask & (m.kf_lm[kf1] < 0) & (m.kf_lm[kf2, safe2.long()] < 0)
    R2, t2 = m.kf_R[kf2], m.kf_t[kf2]
    Ow2 = -(R2.T @ t2)
    dist = torch.linalg.norm(pw - Ow2, dim=-1)
    dmax = dist * scale_at(m.kf_octave[kf2, safe2.long()])
    normal = (pw - Ow2) / dist.clamp(min=1e-9)[:, None]
    m, slots, ok = _insert_landmark_rows(
        m, pw, m.kf_desc[kf1], normal, dmax / MAX_SCALE, dmax, kf2, mask)
    m = add_observation(m, slots, _full(N, kf1, dev), _ids(N, dev), ok)
    return add_observation(m, slots, _full(N, kf2, dev), safe2.to(I32), ok)


def _k_matrix(cam, like: torch.Tensor) -> torch.Tensor:
    return like.new_tensor([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy],
                            [0, 0, 1.0]])


def epipolar_geometry(m: MapState, cam, kf1: int, kf2: int):
    """(F12, the epipole of camera 1 in image 2) of a keyframe pair
    (LocalMapping::ComputeF12, LocalMapping.cc:676-714)."""
    R1, t1 = m.kf_R[kf1], m.kf_t[kf1]
    R2, t2 = m.kf_R[kf2], m.kf_t[kf2]
    R12 = R1 @ R2.T
    t12 = -(R12 @ t2) + t1
    Ki = torch.linalg.inv(_k_matrix(cam, R1))
    F12 = Ki.T @ se3.hat(t12) @ R12 @ Ki
    c2 = R2 @ -(R1.T @ t1) + t2
    z = torch.where(c2[2] == 0, 1e-9, c2[2])
    e2 = torch.stack([cam.fx * c2[0] / z + cam.cx,
                      cam.fy * c2[1] / z + cam.cy])
    return F12, e2


def triangulate_landmarks(m: MapState, cam, kf1: int, kf2: int) -> MapState:
    """CreateNewMapPoints for one keyframe pair (reference:
    LocalMapping.cc:290-577): epipolar-gated matching of landmark-free
    features, batched DLT triangulation, the parallax, cheirality,
    reprojection chi2 and scale-consistency gates, insertion with
    observations in both keyframes. A match that fails the
    scale-consistency gate is rejected, as upstream rejects it (the
    reference fork lost that ``continue``)."""
    R1, t1 = m.kf_R[kf1], m.kf_t[kf1]
    R2, t2 = m.kf_R[kf2], m.kf_t[kf2]
    F12, e2 = epipolar_geometry(m, cam, kf1, kf2)
    f1 = _kf_featureset(m, kf1)
    f2 = _kf_featureset(m, kf2)
    idx2, _, matched = msearch.search_for_triangulation(
        cam, f1, f2, m.kf_lm[kf1] < 0, m.kf_lm[kf2] < 0, F12, e2)
    safe2 = idx2.clamp(min=0).long()
    p1, p2 = f1.xy, f2.xy[safe2]
    Km = _k_matrix(cam, R1)
    P1 = Km @ torch.cat([R1, t1[:, None]], 1)
    P2 = Km @ torch.cat([R2, t2[:, None]], 1)
    N = p1.shape[0]
    X = triangulate.triangulate_dlt(P1.expand(N, 3, 4), P2.expand(N, 3, 4),
                                    p1, p2)
    Ow1, Ow2 = -(R1.T @ t1), -(R2.T @ t2)
    cos_par = triangulate.rays_parallax_cos(Ow1, Ow2, X)
    finite = torch.isfinite(X).all(-1)
    par_ok = (cos_par > 0) & (cos_par < 0.9998)
    Xc1 = X @ R1.T + t1
    Xc2 = X @ R2.T + t2
    chei = (Xc1[:, 2] > 0) & (Xc2[:, 2] > 0)

    def reproj_ok(Xc, xy, ur, inv):
        zc = Xc[:, 2].clamp(min=1e-9)
        u = cam.fx * Xc[:, 0] / zc + cam.cx
        v = cam.fy * Xc[:, 1] / zc + cam.cy
        e_mono = ((u - xy[:, 0]) ** 2 + (v - xy[:, 1]) ** 2) * inv
        e_st = e_mono + ((u - cam.bf / zc - ur) ** 2) * inv
        return torch.where(ur >= 0, e_st < 7.8, e_mono < 5.991)

    reproj = (reproj_ok(Xc1, p1, f1.ur, inv_sigma2_at(f1.octave))
              & reproj_ok(Xc2, p2, f2.ur[safe2],
                          inv_sigma2_at(f2.octave[safe2])))
    d1 = torch.linalg.norm(X - Ow1, dim=-1)
    d2 = torch.linalg.norm(X - Ow2, dim=-1)
    ratio_dist = d2 / d1.clamp(min=1e-9)
    ratio_oct = scale_at(f1.octave) / scale_at(f2.octave[safe2])
    ratio_factor = 1.5 * msearch.SCALE
    scale_ok = ((ratio_dist * ratio_factor >= ratio_oct)
                & (ratio_dist <= ratio_oct * ratio_factor))
    ok = (matched & finite & par_ok & chei & reproj & scale_ok & (d1 > 0)
          & (d2 > 0))
    return insert_landmarks_two_view(m, cam, kf1, kf2, idx2, X, ok)


def scene_median_depth(m: MapState, kf: int) -> torch.Tensor:
    """KeyFrame::ComputeSceneMedianDepth(2) (reference KeyFrame.cc:647-677):
    the lower median of the keyframe's landmark depths; +inf without
    landmarks."""
    lm = m.kf_lm[kf]
    safe = lm.clamp(min=0).long()
    has = (lm >= 0) & m.kf_feat_valid[kf] & m.lm_valid[safe]
    z = m.lm_pw[safe] @ m.kf_R[kf][2] + m.kf_t[kf][2]
    zs = torch.sort(torch.where(has, z, float("inf")), stable=True).values
    return zs[max((int(has.sum()) - 1) // 2, 0)]


def triangulate_with_neighbors(m: MapState, cam, kf: int,
                               neighbors) -> MapState:
    """CreateNewMapPoints over the covisible neighbors (-1 padded), skipping
    a neighbor whose baseline is below 1% of its median scene depth (the
    monocular rule, LocalMapping.cc:336-358)."""
    Ow = -(m.kf_R[kf].T @ m.kf_t[kf])
    for j in neighbors:
        if j < 0:
            continue
        baseline = torch.linalg.norm(-(m.kf_R[j].T @ m.kf_t[j]) - Ow)
        med = scene_median_depth(m, j)
        if bool(baseline / med.clamp(min=1e-9) > 0.01):
            m = triangulate_landmarks(m, cam, kf, j)
    return m


def scale_map(m: MapState, s) -> MapState:
    """Rescale the whole map (the monocular gauge, CreateInitialMapMonocular
    Tracking.cc:791-817): landmark positions, their scale bands, keyframe
    translations and positive depths multiply by s."""
    return m._replace(
        kf_t=m.kf_t * s, lm_pw=m.lm_pw * s, lm_dmin=m.lm_dmin * s,
        lm_dmax=m.lm_dmax * s,
        kf_depth=torch.where(m.kf_depth > 0, m.kf_depth * s, m.kf_depth))


# ---------------------------------------------------------------------------
# tracking
# ---------------------------------------------------------------------------

class TrackResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    lm: torch.Tensor  # [.., N] per-feature landmark after optimization
    n_matches: torch.Tensor  # matches fed to the optimizer
    n_inliers: torch.Tensor  # inliers after optimization


def _pose_optimize_from_matches(cam, m: MapState, feats: FeatureSet,
                                frame_lm, R0, t0) -> TrackResult:
    """Pose-only optimization over frame<->landmark matches, batched over
    the leading axis of frame_lm [B, N], R0 [B, 3, 3], t0 [B, 3]."""
    valid = (frame_lm >= 0) & feats.valid
    Xw = m.lm_pw[frame_lm.clamp(min=0).long()]
    obs_uvr = torch.cat([feats.xy, feats.ur[:, None]], -1)
    res = pose_opt.optimize_pose(cam, R0, t0, Xw, obs_uvr,
                                 inv_sigma2_at(feats.octave), valid)
    return TrackResult(res.R, res.t, torch.where(res.inliers, frame_lm, -1),
                       valid.sum(-1, dtype=I32), res.n_inliers)


def pose_optimize_one(cam, m: MapState, feats: FeatureSet, frame_lm, R0,
                      t0) -> TrackResult:
    """_pose_optimize_from_matches for one frame: frame_lm [N], R0 [3, 3],
    t0 [3]."""
    res = _pose_optimize_from_matches(cam, m, feats, frame_lm[None], R0[None],
                                      t0[None])
    return TrackResult(*(a[0] for a in res))


def _assign(frame_lm, matched, idx, values):
    """frame_lm with frame_lm[idx] = values for matched queries (unmatched
    queries rewrite slot 0 with its own value, last write winning)."""
    safe = torch.where(matched, idx, 0)
    return set_last(frame_lm, safe, torch.where(
        matched, values, frame_lm[safe.long()]))


def _match_motion_model(cam, m: MapState, prev: FrameObs, feats: FeatureSet,
                        R_pred, t_pred, th, width, height, desc_th):
    """SearchByProjection vs the last frame (ORBmatcher.cc:1540+) ->
    frame_lm [N]."""
    pl = prev.lm.clamp(min=0).long()
    ok_lm = m.lm_valid[pl] & (prev.lm >= 0) & prev.feats.valid
    idx, _, matched = msearch.search_by_projection_frame(
        cam, R_pred, t_pred, m.lm_pw[pl], prev.feats, ok_lm, feats, th,
        width, height, desc_th=desc_th)
    N = feats.xy.shape[0]
    return _assign(_full(N, -1, feats.xy.device), matched, idx, prev.lm)


def _match_reference_kf(m: MapState, ref_kf: int, feats: FeatureSet):
    """Reference-keyframe association (SearchByBoW, ratio 0.7, as a full
    masked Hamming sweep) -> frame_lm [N]."""
    kf_lm = m.kf_lm[ref_kf]
    kf_has = ((kf_lm >= 0) & m.kf_feat_valid[ref_kf]
              & m.lm_valid[kf_lm.clamp(min=0).long()])
    idx, _, matched = msearch.search_brute(
        m.kf_desc[ref_kf], feats.desc, kf_has, feats.valid, ratio=0.7,
        angle_q=m.kf_angle[ref_kf], angle_t=feats.angle)
    N = feats.xy.shape[0]
    return _assign(_full(N, -1, feats.xy.device), matched, idx, kf_lm)


def track_motion_model(cam, m: MapState, prev: FrameObs, prev_R, prev_t,
                       feats: FeatureSet, R_pred, t_pred, th, width, height,
                       desc_th=100) -> TrackResult:
    """TrackWithMotionModel (Tracking.cc:997-1063): the last frame's
    landmarks projected with the constant-velocity prediction, a windowed
    match, then pose-only BA from the prediction."""
    frame_lm = _match_motion_model(cam, m, prev, feats, R_pred, t_pred, th,
                                   width, height, desc_th)
    return pose_optimize_one(cam, m, feats, frame_lm, R_pred, t_pred)


def track_reference_keyframe(cam, m: MapState, ref_kf: int,
                             feats: FeatureSet, R0, t0) -> TrackResult:
    """TrackReferenceKeyFrame (Tracking.cc:871-917): the frame matched
    against the reference keyframe's landmarks, then pose-only BA from the
    last frame's pose."""
    frame_lm = _match_reference_kf(m, ref_kf, feats)
    return pose_optimize_one(cam, m, feats, frame_lm, R0, t0)


def track_local_map(cam, m: MapState, feats: FeatureSet, frame_lm, R, t,
                    local_lm_mask, th, width, height, desc_th=100,
                    lm_cap: int = 4096):
    """TrackLocalMap (Tracking.cc:1075-1127 + SearchLocalPoints
    1345-1403): project unmatched local landmarks (the first ``lm_cap``
    candidates), add matches, re-optimize, update visible/found counts.
    Returns (TrackResult, MapState)."""
    L = m.lm_pw.shape[0]
    lm_cap = min(lm_cap, L)
    dev = frame_lm.device
    already_lm = torch.zeros(L, dtype=I32, device=dev).index_add(
        0, frame_lm.clamp(min=0).long(), (frame_lm >= 0).to(I32)) > 0
    cand = local_lm_mask & m.lm_valid & ~already_lm
    sel, g_ok = gather_mask_indices(cand, lm_cap)
    lmset = LandmarkSet(m.lm_pw[sel], m.lm_normal[sel], m.lm_dmin[sel],
                        m.lm_dmax[sel], m.lm_desc[sel], g_ok)
    fr = msearch.frustum_check(cam, R, t, lmset, width, height)
    idx, _, matched = msearch.search_local_points(
        cam, R, t, lmset, fr, feats, th=th, already_matched=frame_lm >= 0,
        desc_th=desc_th)
    frame_lm = _assign(frame_lm, matched, idx, sel.to(I32))
    res = pose_optimize_one(cam, m, feats, frame_lm, R, t)
    vis_inc = (torch.zeros(L, dtype=I32, device=dev).index_add(
        0, sel, fr.visible.to(I32)) + already_lm.to(I32))
    found = torch.zeros(L, dtype=I32, device=dev).index_add(
        0, res.lm.clamp(min=0).long(), (res.lm >= 0).to(I32)) > 0
    m = m._replace(lm_visible=m.lm_visible + vis_inc,
                   lm_found=m.lm_found + found.to(I32))
    return res, m


def local_landmark_mask(m: MapState, ref_kf: int) -> torch.Tensor:
    """Landmarks observed by keyframes covisible with ref_kf
    (UpdateLocalKeyFrames/Points, Tracking.cc:1421-1570)."""
    K = m.kf_R.shape[0]
    w = covisibility_weights(m, ref_kf)
    local_kf = (w > 0) | (torch.arange(K, device=w.device) == ref_kf)
    obs = m.lm_obs_kf
    return ((local_kf[obs.clamp(min=0).long()] & (obs >= 0)).any(1)
            & m.lm_valid)


class FrameStepResult(NamedTuple):
    map: MapState
    R: torch.Tensor
    t: torch.Tensor
    lm: torch.Tensor  # [N] landmark per feature after local-map tracking
    feats: FeatureSet
    depth: torch.Tensor
    stats: torch.Tensor  # int32 [6]: mm_inliers, used_mm, track1_inliers,
    #                      local_inliers, ref_matches,
    #                      tracked_close * 10000 + non_tracked_close
    vel_R: torch.Tensor  # T_cur * T_prev^-1
    vel_t: torch.Tensor
    Rcr: torch.Tensor  # T_cur * T_ref^-1
    tcr: torch.Tensor


def extract_rgbd_features(extractor, cam: CamParams, img, depth_map,
                          depth_factor: float, width: int, height: int,
                          undist_cam=None):
    """ORB extraction + depth sampling with the occlusion-edge gate +
    mvuRight synthesis. The gate's 3x3 min/max wraps around the image
    border (the JAX package builds it from rolls). ``undist_cam``, a
    models.camera.PinholeCamera with distortion, undistorts the keypoints
    after the depth sampling (the depth image is aligned with the raw one)
    and before mvuRight (Frame.cc:434-469, 687-698). Returns (feats, d)."""
    depth_map = depth_map.to(torch.float32) * depth_factor
    raw = extractor._extract(img)
    xy = raw.xy
    yi = torch.round(xy[:, 1]).long().clamp(0, height - 1)
    xi = torch.round(xy[:, 0]).long().clamp(0, width - 1)
    dmin_map = dmax_map = depth_map
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                sh = torch.roll(depth_map, (dy, dx), (0, 1))
                dmin_map = torch.minimum(dmin_map, sh)
                dmax_map = torch.maximum(dmax_map, sh)
    d, dmin, dmax = depth_map[yi, xi], dmin_map[yi, xi], dmax_map[yi, xi]
    edge = (dmin <= 0) | ((dmax - dmin) > 0.04 * d.clamp(min=1e-6))
    d = torch.where((d > 0) & ~edge, d, -1.0)
    if undist_cam is not None:
        xy = undist_cam.undistort_points(xy)
    feats = FeatureSet(xy, make_feature_uvr(xy[:, 0], d, cam.bf), raw.octave,
                       raw.angle, raw.desc, raw.valid)
    return feats, d


def track_frame_core(cam, m: MapState, prev: FrameObs, last_R, last_t,
                     vel_R, vel_t, have_vel: bool, ref_kf: int,
                     feats: FeatureSet, d, th_depth: float, desc_th: int,
                     desc_th_local: int, min_obs: int, width: int,
                     height: int, th_local: float = 3.0,
                     static_vel: bool = False) -> FrameStepResult:
    """Motion model at 7 and 14 px plus the reference-keyframe search, the
    three pose solves batched; the stronger accepted result seeds local-map
    tracking (radius ``th_local``); then the keyframe-decision statistics
    (Tracking.cc:341-352, 1140-1244). With static_vel and no velocity only
    the reference-keyframe search runs and the motion-model statistics are
    0, as the JAX package's step with a static have_vel."""
    if static_vel and not have_vel:
        res = track_reference_keyframe(cam, m, ref_kf, feats, last_R, last_t)
        zero = torch.zeros((), dtype=I32, device=d.device)
        mm_inliers, used_mm = zero, zero
    else:
        R_pred, t_pred = se3.compose(vel_R, vel_t, last_R, last_t)
        lm_mm1 = _match_motion_model(cam, m, prev, feats, R_pred, t_pred,
                                     7.0, float(width), float(height),
                                     desc_th)
        lm_mm2 = _match_motion_model(cam, m, prev, feats, R_pred, t_pred,
                                     14.0, float(width), float(height),
                                     desc_th)
        lm_ref = _match_reference_kf(m, ref_kf, feats)
        b = _pose_optimize_from_matches(
            cam, m, feats, torch.stack([lm_mm1, lm_mm2, lm_ref]),
            torch.stack([R_pred, R_pred, last_R]),
            torch.stack([t_pred, t_pred, last_t]))
        mm1, mm2, ref = (TrackResult(*(a[i] for a in b)) for i in range(3))
        mm_ok1 = mm1.n_inliers >= 10
        mm = TrackResult(*(torch.where(mm_ok1, a, c)
                           for a, c in zip(mm1, mm2)))
        mm_ok = (mm.n_matches >= 20) & (mm.n_inliers >= 10) & have_vel
        ref_ok = (ref.n_matches >= 15) & (ref.n_inliers >= 10)
        use_mm = mm_ok & (~ref_ok | (mm.n_inliers >= ref.n_inliers))
        res = TrackResult(*(torch.where(use_mm, a, c)
                            for a, c in zip(mm, ref)))
        mm_inliers, used_mm = mm.n_inliers, use_mm.to(I32)
    local_mask = local_landmark_mask(m, ref_kf)
    res2, m = track_local_map(cam, m, feats, res.lm, res.R, res.t,
                              local_mask, th_local, width, height,
                              desc_th_local)
    ref_lm = m.kf_lm[ref_kf]
    rl = ref_lm.clamp(min=0).long()
    nobs = landmark_obs_count(m)[rl]
    ref_matches = ((ref_lm >= 0) & m.kf_feat_valid[ref_kf] & (nobs >= min_obs)
                   & m.lm_valid[rl]).sum(dtype=I32)
    close = (d > 0) & (d < th_depth)
    tracked_close = (close & (res2.lm >= 0)).sum(dtype=I32)
    non_tracked_close = (close & (res2.lm < 0)).sum(dtype=I32)
    stats = torch.stack([mm_inliers, used_mm, res.n_inliers,
                         res2.n_inliers, ref_matches,
                         tracked_close * 10000 + non_tracked_close]).to(I32)
    vel = se3.compose(res2.R, res2.t, *se3.inverse(last_R, last_t))
    rel = se3.compose(res2.R, res2.t,
                      *se3.inverse(m.kf_R[ref_kf], m.kf_t[ref_kf]))
    return FrameStepResult(m, res2.R, res2.t, res2.lm, feats, d, stats,
                           vel[0], vel[1], rel[0], rel[1])


def build_track_frame_step(extractor, width: int, height: int,
                           undist_cam=None):
    """The fused per-frame step of the host tracker: extract_rgbd_features,
    then track_frame_core with a static have_vel, as one callable that
    returns FrameStepResult."""

    def step(cam, m: MapState, prev: FrameObs, last_R, last_t, vel_R, vel_t,
             have_vel: bool, ref_kf: int, img, depth_map, depth_factor: float,
             th_depth: float, desc_th: int, desc_th_local: int, min_obs: int,
             th_local: float) -> FrameStepResult:
        feats, d = extract_rgbd_features(extractor, cam, img, depth_map,
                                         depth_factor, width, height,
                                         undist_cam)
        return track_frame_core(cam, m, prev, last_R, last_t, vel_R, vel_t,
                                have_vel, ref_kf, feats, d, th_depth, desc_th,
                                desc_th_local, min_obs, width, height,
                                th_local=th_local, static_vel=True)

    return step


# ---------------------------------------------------------------------------
# keyframe maintenance
# ---------------------------------------------------------------------------

def fuse_neighbors(m: MapState, cam, kf: int, neighbors: list[int],
                   width: int, height: int, into: bool) -> MapState:
    """SearchInNeighbors, one direction over the covisible neighbors (-1
    padded): into=True projects each neighbor's landmarks into ``kf``,
    into=False projects ``kf``'s landmarks into each neighbor
    (LocalMapping.cc:589-674, ORBmatcher::Fuse 977+). Observations are
    added per neighbor; duplicate merges are collected and resolved by one
    merge_landmarks at the end, direction by (observation count at pass
    start, then lower slot)."""
    N = m.kf_lm.shape[1]
    dev = m.kf_lm.device
    nobs0 = landmark_obs_count(m)
    zeros = torch.zeros(N, dtype=I32, device=dev)
    keeps, kills, oks = [], [], []
    for j in neighbors:
        if j < 0:
            keeps.append(zeros)
            kills.append(zeros)
            oks.append(zeros.bool())
            continue
        src, dst = (j, kf) if into else (kf, j)
        lm_ids = m.kf_lm[src]
        safe = lm_ids.clamp(min=0).long()
        has = (lm_ids >= 0) & m.kf_feat_valid[src] & m.lm_valid[safe]
        lmset = LandmarkSet(m.lm_pw[safe], m.lm_normal[safe], m.lm_dmin[safe],
                            m.lm_dmax[safe], m.lm_desc[safe], has)
        idx, _, matched = msearch.fuse_candidates(
            cam, m.kf_R[dst], m.kf_t[dst], lmset, _kf_featureset(m, dst),
            width, height)
        feat_free = m.kf_lm[dst, idx.long()] < 0
        already = (m.lm_obs_kf[safe] == dst).any(1)
        ok = matched & feat_free & ~already & has
        m = add_observation(m, safe.to(I32), _full(N, dst, dev), idx, ok)
        other = m.kf_lm[dst, idx.long()]
        dup = matched & has & (other >= 0) & (other != lm_ids)
        so = other.clamp(min=0).long()
        self_wins = (nobs0[safe] > nobs0[so]) | (
            (nobs0[safe] == nobs0[so]) & (safe < so))
        keeps.append(torch.where(self_wins, lm_ids, other).clamp(min=0))
        kills.append(torch.where(self_wins, other, lm_ids).clamp(min=0))
        oks.append(dup)
    return merge_landmarks(m, torch.cat(keeps), torch.cat(kills),
                           torch.cat(oks))


def merge_duplicate_landmarks(m: MapState, cur_kf: int,
                              block: int = 1024) -> MapState:
    """Merge this keyframe's fresh landmarks (a suffix block ending at
    n_lm) into the closest strictly-lower-slot landmark within a
    scale-aware radius whose descriptor agrees (Hamming <= 50)."""
    L = m.lm_pw.shape[0]
    dev = m.lm_pw.device
    Rb = min(block, L)
    n_lm = int(m.n_lm)
    start = min(max(n_lm - Rb, 0), L - Rb)
    slot = start + _ids(Rb, dev)
    pw_r = m.lm_pw[start:start + Rb]
    desc_r = m.lm_desc[start:start + Rb]
    recent = (m.lm_valid[start:start + Rb]
              & (m.lm_first_kf[start:start + Rb] == cur_kf) & (slot < n_lm))
    CH = 16384
    best_d2 = torch.full((Rb,), float("inf"), device=dev)
    best_tgt = torch.zeros(Rb, dtype=I32, device=dev)
    for sc in range(0, L, CH):
        n_c = min(CH, L - sc)
        pw_c = m.lm_pw[sc:sc + n_c]
        ids_c = sc + _ids(n_c, dev)
        d2 = ((pw_r[:, 0:1] - pw_c[None, :, 0]) ** 2
              + (pw_r[:, 1:2] - pw_c[None, :, 1]) ** 2
              + (pw_r[:, 2:3] - pw_c[None, :, 2]) ** 2)
        ham = hamming.distance_matrix(desc_r, m.lm_desc[sc:sc + n_c])
        tol = (0.015 * m.lm_dmax[sc:sc + n_c]).clamp(0.005, 0.05)[None, :]
        lower = (m.lm_valid[sc:sc + n_c][None, :]
                 & (ids_c[None, :] < slot[:, None]))
        ok = lower & (d2 < tol * tol) & (ham <= 50) & recent[:, None]
        d2m = torch.where(ok, d2, float("inf"))
        arg_c = torch.argmin(d2m, 1)
        min_c = d2m.gather(1, arg_c[:, None])[:, 0]
        better = min_c < best_d2
        best_tgt = torch.where(better, ids_c[arg_c], best_tgt)
        best_d2 = torch.where(better, min_c, best_d2)
    return merge_landmarks(m, best_tgt, slot,
                           torch.isfinite(best_d2) & recent)


def refresh_landmarks_for_kf(m: MapState, kf: int) -> MapState:
    """refresh_landmarks restricted to the landmarks keyframe ``kf``
    observes, the set a maintenance step touches."""
    ids = m.kf_lm[kf]
    sel = ids.clamp(min=0).long()
    return _refresh_rows(
        m, sel, (ids >= 0) & m.kf_feat_valid[kf] & m.lm_valid[sel])


def refresh_landmarks(m: MapState) -> MapState:
    """Representative descriptors, normals and scale bands of every
    landmark that has an observation, from the observation table."""
    L = m.lm_pw.shape[0]
    dev = m.lm_pw.device
    return _refresh_rows(m, torch.arange(L, device=dev),
                         torch.ones(L, dtype=torch.bool, device=dev))


def _refresh_rows(m: MapState, sel, g_ok) -> MapState:
    """Representative descriptor (min median Hamming), mean viewing
    direction and scale band of the landmarks ``sel`` [B] long where
    ``g_ok`` [B] (MapPoint::ComputeDistinctiveDescriptors MapPoint.cc:
    247-316, UpdateNormalAndDepth 339-390)."""
    D = m.lm_obs_kf.shape[1]
    obs_kf = m.lm_obs_kf[sel]
    obs_feat = m.lm_obs_feat[sel].long()
    valid_obs = (obs_kf >= 0) & g_ok[:, None]
    kf_idx = obs_kf.clamp(min=0).long()
    descs = m.kf_desc[kf_idx, obs_feat]  # [N, D, 8]
    dmat = hamming.hamming_pair(descs[:, :, None, :], descs[:, None, :, :])
    pair_ok = valid_obs[:, :, None] & valid_obs[:, None, :]
    srt = torch.sort(torch.where(pair_ok, dmat, hamming.BIG), dim=2).values
    cnt = valid_obs.sum(1)
    mid = ((cnt - 1) // 2).clamp(0, D - 1)
    med = srt.gather(2, mid[:, None, None].expand(-1, D, 1))[..., 0]
    best = torch.argmin(torch.where(valid_obs, med, hamming.BIG), 1)
    new_desc = descs.gather(1, best[:, None, None].expand(-1, 1, 8))[:, 0]
    Ow = -(m.kf_R.transpose(1, 2) @ m.kf_t[..., None])[..., 0]
    pw = m.lm_pw[sel]
    dirs = pw[:, None, :] - Ow[kf_idx]
    norms = torch.linalg.norm(dirs, dim=-1).clamp(min=1e-9)
    dirs = torch.where(valid_obs[..., None], dirs / norms[..., None], 0.0)
    nsum = dirs.sum(1)
    normal = nsum / torch.linalg.norm(nsum, dim=-1, keepdim=True).clamp(
        min=1e-9)
    # the scale band comes from the reference observation (slot 0)
    dist_ref = torch.linalg.norm(pw - Ow[kf_idx[:, 0]], dim=-1)
    dmax = dist_ref * scale_at(m.kf_octave[kf_idx[:, 0], obs_feat[:, 0]])
    upd = g_ok & (cnt > 0)

    def put(a, v):
        keep = upd.reshape(-1, *([1] * (a.dim() - 1)))
        return set_last(a, sel, torch.where(keep, v, a[sel]))

    return m._replace(lm_desc=put(m.lm_desc, new_desc),
                      lm_normal=put(m.lm_normal, normal),
                      lm_dmax=put(m.lm_dmax, dmax),
                      lm_dmin=put(m.lm_dmin, dmax / MAX_SCALE))


def cull_landmarks(m: MapState, cur_kf: int) -> MapState:
    """MapPointCulling (LocalMapping.cc:219-263) on recent landmarks."""
    nobs = landmark_obs_count(m)
    age = cur_kf - m.lm_first_kf
    ratio_bad = (m.lm_found.float() / m.lm_visible.float().clamp(min=1.0)
                 ) < 0.25
    bad = m.lm_valid & (((age <= 3) & (ratio_bad | ((age >= 2) & (nobs <= 1))))
                        | (nobs == 0))
    return m._replace(lm_valid=m.lm_valid & ~bad)


def repack_obs_rows(m: MapState) -> MapState:
    """Make each observation row's valid entries an in-order prefix again."""
    order = torch.argsort((m.lm_obs_kf < 0).to(torch.uint8), dim=1,
                          stable=True)
    return m._replace(lm_obs_kf=m.lm_obs_kf.gather(1, order),
                      lm_obs_feat=m.lm_obs_feat.gather(1, order))


def cull_keyframes(m: MapState, cur_kf: int, candidates: list[int]
                   ) -> MapState:
    """KeyFrameCulling (LocalMapping.cc:775-841): a candidate keyframe is
    redundant when > 90% of its landmarks are seen by >= 3 other keyframes
    at the same or finer scale. Keyframe 0 and ``cur_kf`` are kept."""
    dev = m.kf_lm.device
    cands = torch.as_tensor(candidates, dtype=torch.long, device=dev)
    cand = cands.clamp(min=0)
    kf_lm = m.kf_lm[cand]
    lm = kf_lm.clamp(min=0).long()
    kv = m.kf_valid[cand]
    has = (kf_lm >= 0) & m.kf_feat_valid[cand] & m.lm_valid[lm] & kv[:, None]
    obs_kf = m.lm_obs_kf[lm]  # [C, N, D]
    ok_c = obs_kf.clamp(min=0).long()
    obs_oct = m.kf_octave[ok_c, m.lm_obs_feat[lm].long()]
    counted = ((obs_kf >= 0) & (obs_kf != cand[:, None, None])
               & m.kf_valid[ok_c] & (obs_oct <= m.kf_octave[cand][:, :, None] + 1))
    redundant = has & (counted.sum(2) >= 3)
    n_has = has.sum(1)
    cull = (kv & (n_has > 0)
            & (redundant.sum(1).float() > 0.9 * n_has.float())
            & (cands >= 0) & (cand != 0) & (cand != cur_kf))
    kf_valid = set_last(m.kf_valid, cand, kv & ~cull)
    obs_dead = (m.lm_obs_kf >= 0) & ~kf_valid[m.lm_obs_kf.clamp(min=0).long()]
    return repack_obs_rows(m._replace(
        kf_valid=kf_valid, lm_obs_kf=torch.where(obs_dead, -1, m.lm_obs_kf)))


def local_bundle_adjustment(m: MapState, cam, cur_kf: int, iters_a: int = 5,
                            free_cap: int = 16, fixed_cap: int = 8,
                            lm_cap: int = 8192, erase_outliers: bool = True,
                            init_lambda=1e-4):
    """LocalBundleAdjustment (Optimizer.cc:483-808) on a gathered window:
    free poses = cur_kf + top covisible keyframes (keyframe 0 always
    fixed), fixed anchors = the keyframes with the most observations of
    the window's landmarks, landmarks = the first ``lm_cap`` local ones.
    With erase_outliers, observations over chi2 5.991 / 7.815 are erased
    and landmarks left without observations invalidated.
    Returns (MapState, final LM damping)."""
    K = m.kf_lm.shape[0]
    L = m.lm_obs_kf.shape[0]
    dev = m.kf_lm.device
    free_cap, fixed_cap, lm_cap = min(free_cap, K), min(fixed_cap, K), min(
        lm_cap, L)
    P = free_cap + fixed_cap
    w = covisibility_weights(m, cur_kf).clone()
    w[0] = 0
    top_w, top_i = sort_top_k(w, free_cap - 1)
    free_list = torch.cat([_full(1, cur_kf, dev), top_i.to(I32)])
    free_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         (top_w > 0) & (top_i != cur_kf)])
    free_mask = torch.zeros(K, dtype=I32, device=dev).scatter_reduce(
        0, torch.where(free_ok, free_list, 0).long(), free_ok.to(I32),
        "amax") > 0
    obs_valid = m.lm_obs_kf >= 0
    lm_local = ((free_mask[m.lm_obs_kf.clamp(min=0).long()] & obs_valid).any(1)
                & m.lm_valid)
    sel, g_ok = gather_mask_indices(lm_local, lm_cap)
    obs_kf_g = m.lm_obs_kf[sel]
    obs_feat_g = m.lm_obs_feat[sel].long()
    contrib = ((obs_kf_g >= 0) & g_ok[:, None]).to(I32)
    cnt = torch.zeros(K, dtype=I32, device=dev).index_add(
        0, obs_kf_g.clamp(min=0).reshape(-1).long(), contrib.reshape(-1))
    cnt = torch.where(free_mask | ~m.kf_valid, 0, cnt)
    fix_w, fix_i = sort_top_k(cnt, fixed_cap)
    sel_pose = torch.cat([free_list, fix_i.to(I32)])
    pose_ok = torch.cat([free_ok, fix_w > 0])
    pose_fixed = torch.cat([torch.zeros(free_cap, dtype=torch.bool, device=dev),
                            torch.ones(fixed_cap, dtype=torch.bool, device=dev)]
                           ) | ~pose_ok
    safe_pose = torch.where(pose_ok, sel_pose, 0).long()
    g2l = torch.full((K,), -1, dtype=I32, device=dev).scatter_reduce(
        0, safe_pose, torch.where(pose_ok, _ids(P, dev), -1), "amax")
    lp = g2l[obs_kf_g.clamp(min=0).long()]
    act = (obs_kf_g >= 0) & (lp >= 0) & g_ok[:, None]
    kf_i = obs_kf_g.clamp(min=0).long()
    uvr = torch.cat([m.kf_xy[kf_i, obs_feat_g],
                     m.kf_ur[kf_i, obs_feat_g][..., None]], -1)
    wgt = torch.where(act, inv_sigma2_at(m.kf_octave[kf_i, obs_feat_g]), 0.0)
    prob = ba.BAProblem(R=m.kf_R[safe_pose], t=m.kf_t[safe_pose],
                        X=m.lm_pw[sel], obs_pose=lp.clamp(min=0).long(),
                        obs_uvr=uvr, obs_w=wgt, pose_fixed=pose_fixed,
                        point_valid=g_ok)
    res = ba.ba_solve(cam, prob, iters=iters_a, robust=True,
                      init_lambda=init_lambda)
    upd = pose_ok & ~pose_fixed
    m = m._replace(
        kf_R=set_last(m.kf_R, safe_pose, torch.where(
            upd[:, None, None], res.R, m.kf_R[safe_pose])),
        kf_t=set_last(m.kf_t, safe_pose, torch.where(
            upd[:, None], res.t, m.kf_t[safe_pose])),
        lm_pw=set_last(m.lm_pw, sel, torch.where(
            g_ok[:, None], res.X, m.lm_pw[sel])))
    if erase_outliers:
        chi_th = torch.where(uvr[..., 2] >= 0, 7.815, 5.991)
        outlier = (res.obs_chi2 > chi_th) & (wgt > 0)
        new_rows = torch.where(outlier, -1, obs_kf_g)
        old = m.kf_lm[kf_i, obs_feat_g]
        clear = outlier & (old == sel[:, None])
        kf_lm = set_last(m.kf_lm, (kf_i.reshape(-1), obs_feat_g.reshape(-1)),
                         torch.where(clear, -1, old).reshape(-1))
        nobs_after = (new_rows >= 0).sum(1)
        m = m._replace(
            lm_obs_kf=set_last(m.lm_obs_kf, sel, new_rows), kf_lm=kf_lm,
            lm_valid=set_last(m.lm_valid, sel, m.lm_valid[sel] & torch.where(
                g_ok, nobs_after > 0, True)))
    return m, res.final_lambda


def loop_search_and_fuse(m: MapState, cam, loop_lm_mask, group_kfs: list[int],
                         width: int, height: int,
                         lm_cap: int = 4096) -> MapState:
    """SearchAndFuse (reference: LoopClosing.cc:725-754): project the loop
    group's landmarks (the first ``lm_cap`` of ``loop_lm_mask`` [L]) into
    each corrected keyframe of ``group_kfs`` (-1 padded), radius th=4;
    observations go onto free features, and a conflicting landmark is
    always replaced by the loop landmark (:746-752)."""
    L = m.lm_pw.shape[0]
    dev = m.lm_pw.device
    sel, g_ok = gather_mask_indices(loop_lm_mask & m.lm_valid, min(lm_cap, L))
    C = sel.shape[0]
    sel_i = sel.to(I32)
    for j in group_kfs:
        if j < 0:
            continue
        ok_lm = g_ok & m.lm_valid[sel]
        lmset = LandmarkSet(m.lm_pw[sel], m.lm_normal[sel], m.lm_dmin[sel],
                            m.lm_dmax[sel], m.lm_desc[sel], ok_lm)
        idx, _, matched = msearch.fuse_candidates(
            cam, m.kf_R[j], m.kf_t[j], lmset, _kf_featureset(m, j), width,
            height, th=4.0)
        feat_free = m.kf_lm[j, idx.long()] < 0
        already = (m.lm_obs_kf[sel] == j).any(1)
        ok = matched & feat_free & ~already & ok_lm
        m = add_observation(m, sel_i, _full(C, j, dev), idx, ok)
        other = m.kf_lm[j, idx.long()]
        dup = (matched & ok_lm & (other >= 0) & (other != sel_i)
               & m.lm_valid[sel])
        m = merge_landmarks(m, sel_i, other.clamp(min=0), dup)
    return m


def _keyframe_chunk(m: MapState, cam, obs: FrameObs, R, t, frame_id: int,
                    width: int, height: int, new_landmarks) -> MapState:
    """A whole keyframe maintenance chunk at once: insertion, the top-5
    covisible neighbors, inward fusion, ``new_landmarks(map, slot,
    neighbors)``, outward fusion, duplicate merge, landmark refresh and
    culling, local BA (when the keyframe has a neighbor) and keyframe
    culling over the top-10."""
    k = int(m.n_kf)
    m = insert_keyframe(m, obs, R, t, frame_id)
    top_w, top_i = sort_top_k(covisibility_weights(m, k), 10)
    window = torch.where(top_w > 0, top_i, -1).tolist()
    neighbors = window[:5]
    m = fuse_neighbors(m, cam, k, neighbors, width, height, into=True)
    m = new_landmarks(m, k, neighbors)
    m = fuse_neighbors(m, cam, k, neighbors, width, height, into=False)
    m = merge_duplicate_landmarks(m, k)
    m = refresh_landmarks_for_kf(m, k)
    m = cull_landmarks(m, k)
    if max(neighbors) >= 0:
        m, _ = local_bundle_adjustment(m, cam, k)
    return cull_keyframes(m, k, window)


def keyframe_step(m: MapState, cam, obs: FrameObs, R, t, frame_id: int,
                  th_depth: float, width: int, height: int) -> MapState:
    """The maintenance chunk of an RGB-D or stereo keyframe: its new
    landmarks come from depth."""
    return _keyframe_chunk(
        m, cam, obs, R, t, frame_id, width, height,
        lambda mm, k, _: create_depth_landmarks(mm, cam, k, th_depth))


def keyframe_step_mono(m: MapState, cam, obs: FrameObs, R, t, frame_id: int,
                       width: int, height: int) -> MapState:
    """The maintenance chunk of a monocular keyframe: its new landmarks
    are triangulated against the top-5 covisible neighbors."""
    return _keyframe_chunk(
        m, cam, obs, R, t, frame_id, width, height,
        lambda mm, k, nb: triangulate_with_neighbors(mm, cam, k, nb))
