"""The plain reference of the map's table-wide passes, written from
ORB-SLAM2 (not from the port): the covisibility weights of one keyframe
and of every pair, the local landmarks of a reference keyframe, and the
L1 BoW score of loop detection.

The map is given as a dict of tensors under the port's names (the
reference imports nothing of the port):

- ``kf_valid`` [K] bool, ``kf_lm`` [K, N] int (a feature's landmark or
  -1), ``kf_feat_valid`` [K, N] bool;
- ``lm_valid`` [L] bool, ``lm_obs_kf`` [L, D] and ``lm_obs_feat`` [L, D]
  int, a landmark's observations as (keyframe, feature) slots, -1 where
  empty.

A keyframe's map points are the landmarks of its valid features that are
live (``KeyFrame::GetMapPointMatches`` without the bad points); a
landmark's observations are its slots whose keyframe is live
(``MapPoint::GetObservations``: a culled keyframe erases its
observations). The passes:

- ``covisibility_weights`` (``KeyFrame::UpdateConnections``,
  KeyFrame.cc:255-291): for each map point of the keyframe, each other
  keyframe observing it gains one. A point counts only through its
  registered observation: the feature its observation of the keyframe
  names (``mObservations[pKF]``); another feature holding the same point
  (a back-reference left by a fusion) does not count it again.
- ``covisibility_matrix``: that for every live keyframe, a row each.
- ``local_landmarks`` (``Tracking::UpdateLocalKeyFrames`` and
  ``UpdateLocalPoints``, Tracking.cc:1421-1570): the local keyframes, and
  the union of their map points, walked from each keyframe's features.
- ``loop_candidate_scores`` (``KeyFrameDatabase::DetectLoopCandidates``,
  KeyFrameDatabase.cc:83-150, with ``L1Scoring::score`` of DBoW2): the
  keyframes that share a word with the query, and the L1 score of each,
  sum over the shared words of min(q_w, r_w) (DBoW2's -1/2 sum(|q - r| -
  |q| - |r|) for normalized non-negative vectors), in float64.

Departures of the port's AutoTracker by design (the reference follows
ORB-SLAM2 and leaves them out):

- the local keyframes are those covisible with the tracker's reference
  keyframe, and the reference keyframe itself, not those observing the
  current frame's points with their neighbors, children and parent (80 at
  most); the AutoTracker keeps its reference keyframe until its next
  insertion (ORB-SLAM2 moves it to the keyframe sharing most points);
- the port walks the landmarks' observation rows, not the keyframes'
  features: the two agree while each back-reference has its keyframe in
  the landmark's row. A row holds at most D observations; one more is
  dropped and counted (``n_obs_drop``), and its keyframe's back-reference
  stays (ORB-SLAM2's observation map is unbounded);
- landmark slot 0 is where ``add_observation`` sends the writes it masks
  out, and they can overwrite that landmark's first observations while
  its back-references stay;
- the port includes the reference keyframe's points even when that
  keyframe is culled (ORB-SLAM2 skips a bad keyframe), and counts a
  landmark once a row slot, where ORB-SLAM2's observation map holds one
  entry a keyframe (the port's rows hold one a keyframe by construction).
"""
from __future__ import annotations

import torch


def _registered_points(t: dict, kf: int) -> torch.Tensor:
    """The keyframe's map points counted through their registered
    observation: sorted distinct landmark ids."""
    lms = t["kf_lm"][kf].long()
    feats = torch.arange(lms.shape[0], device=lms.device)
    safe = lms.clamp(min=0)
    live = (lms >= 0) & t["kf_feat_valid"][kf] & t["lm_valid"][safe]
    rows_kf = t["lm_obs_kf"][safe].long()
    rows_ft = t["lm_obs_feat"][safe].long()
    names = ((rows_kf == kf) & (rows_ft == feats[:, None])).any(1)
    return torch.unique(lms[live & names])


def _observers(t: dict, points: torch.Tensor) -> torch.Tensor:
    """[P, K] bool: keyframe k holds a live observation of point p."""
    K = t["kf_valid"].shape[0]
    rows = t["lm_obs_kf"][points].long()
    seen = torch.zeros((points.shape[0], K + 1), dtype=torch.bool,
                       device=rows.device)
    seen.scatter_(1, torch.where(rows >= 0, rows, K), True)
    return seen[:, :K] & t["kf_valid"][None, :]


def covisibility_weights(t: dict, kf: int) -> torch.Tensor:
    """[K] int64: the points of keyframe ``kf`` each other live keyframe
    observes (0 for ``kf`` itself and for culled keyframes)."""
    w = _observers(t, _registered_points(t, kf)).sum(0)
    w[kf] = 0
    return w


def covisibility_matrix(t: dict) -> torch.Tensor:
    """[K, K] int64: row k the covisibility weights of live keyframe k, a
    zero row for a culled one."""
    K = t["kf_valid"].shape[0]
    out = torch.zeros((K, K), dtype=torch.int64,
                      device=t["kf_valid"].device)
    for k in torch.nonzero(t["kf_valid"])[:, 0].tolist():
        out[k] = covisibility_weights(t, k)
    return out


def local_landmarks(t: dict, ref_kf: int) -> torch.Tensor:
    """Sorted distinct landmark ids: the map points of the local keyframes
    (``ref_kf`` and the live keyframes covisible with it)."""
    local = covisibility_weights(t, ref_kf) > 0
    local[ref_kf] = True
    lms = t["kf_lm"][local].long()
    safe = lms.clamp(min=0)
    live = (lms >= 0) & t["kf_feat_valid"][local] & t["lm_valid"][safe]
    return torch.unique(lms[live])


def loop_candidate_scores(bow_idx: torch.Tensor, bow_w: torch.Tensor,
                          kf: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids, scores): the keyframes other than ``kf`` whose BoW row shares
    a word with ``kf``'s (the inverted file's hits), sorted, and the L1
    score of each against ``kf``'s row, float64. Rows are sparse: word ids
    [K, T], -1 padded, and their weights; a word's weights in one row add
    up (a BowVector holds one value a word)."""
    K, T = bow_idx.shape
    n = int(bow_idx.max()) + 1
    rows = torch.arange(K, device=bow_idx.device)[:, None].expand(K, T)
    has = bow_idx >= 0
    key = rows[has] * n + bow_idx[has].long()
    key, inv = torch.unique(key, return_inverse=True)
    w = torch.zeros(key.shape[0], dtype=torch.float64,
                    device=bow_idx.device).index_add_(0, inv,
                                                      bow_w[has].double())
    row, word = key // n, key % n
    q = torch.zeros(n, dtype=torch.float64, device=bow_idx.device)
    q.index_put_((word[row == kf],), w[row == kf])
    shared = (q[word] > 0) & (w > 0) & (row != kf)
    score = torch.zeros(K, dtype=torch.float64, device=bow_idx.device)
    score.index_add_(0, row[shared], torch.minimum(q[word], w)[shared])
    hit = torch.zeros(K, dtype=torch.bool, device=bow_idx.device)
    hit[row[shared]] = True
    ids = torch.nonzero(hit)[:, 0]
    return ids, score[ids]
