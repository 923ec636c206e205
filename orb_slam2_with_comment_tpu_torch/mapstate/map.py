"""Fixed-capacity structure-of-arrays map (port of mapstate/map.py).

Keyframes [K] with their feature bundles [K, N], landmarks [L] and the
landmark-major observation table [L, D] of (keyframe, feature) pairs, plus
the keyframe -> landmark back-references [K, N]. Liveness is a mask and
covisibility is recomputed from the observation table on demand.

Functions return a new MapState; the tensors they do not change are shared
with the input. Scatters whose indices may repeat resolve the repeats like
the JAX package does on the CPU: the last write in index order wins
(``set_last``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

I32 = torch.int32
F32 = torch.float32


class MapConfig(NamedTuple):
    k_max: int = 64  # keyframe capacity
    n_feat: int = 1000  # feature slots per keyframe
    l_max: int = 20000  # landmark capacity
    d_max: int = 12  # observation slots per landmark


class MapState(NamedTuple):
    kf_R: torch.Tensor  # [K, 3, 3] world->camera
    kf_t: torch.Tensor  # [K, 3]
    kf_valid: torch.Tensor  # [K] bool
    kf_frame_id: torch.Tensor  # [K] int32
    kf_xy: torch.Tensor  # [K, N, 2]
    kf_ur: torch.Tensor  # [K, N]
    kf_depth: torch.Tensor  # [K, N]
    kf_octave: torch.Tensor  # [K, N] int32
    kf_angle: torch.Tensor  # [K, N]
    kf_desc: torch.Tensor  # [K, N, 8] int32
    kf_feat_valid: torch.Tensor  # [K, N] bool
    kf_lm: torch.Tensor  # [K, N] int32 landmark or -1
    lm_pw: torch.Tensor  # [L, 3]
    lm_valid: torch.Tensor  # [L] bool
    lm_desc: torch.Tensor  # [L, 8] int32
    lm_normal: torch.Tensor  # [L, 3]
    lm_dmin: torch.Tensor  # [L]
    lm_dmax: torch.Tensor  # [L]
    lm_visible: torch.Tensor  # [L] int32
    lm_found: torch.Tensor  # [L] int32
    lm_first_kf: torch.Tensor  # [L] int32
    lm_ref_kf: torch.Tensor  # [L] int32
    lm_obs_kf: torch.Tensor  # [L, D] int32, -1 = empty
    lm_obs_feat: torch.Tensor  # [L, D] int32
    n_kf: torch.Tensor  # [] int32 next free keyframe slot
    n_lm: torch.Tensor  # [] int32 next free landmark slot
    n_obs_drop: torch.Tensor  # [] int32 observations dropped (full rows)


def empty_map(cfg: MapConfig, device) -> MapState:
    K, N, L, D = cfg.k_max, cfg.n_feat, cfg.l_max, cfg.d_max

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    return MapState(
        kf_R=torch.eye(3, dtype=F32, device=device).repeat(K, 1, 1),
        kf_t=full((K, 3), 0.0, F32), kf_valid=full((K,), False, torch.bool),
        kf_frame_id=full((K,), -1, I32), kf_xy=full((K, N, 2), 0.0, F32),
        kf_ur=full((K, N), -1.0, F32), kf_depth=full((K, N), -1.0, F32),
        kf_octave=full((K, N), 0, I32), kf_angle=full((K, N), 0.0, F32),
        kf_desc=full((K, N, 8), 0, I32),
        kf_feat_valid=full((K, N), False, torch.bool),
        kf_lm=full((K, N), -1, I32),
        lm_pw=full((L, 3), 0.0, F32), lm_valid=full((L,), False, torch.bool),
        lm_desc=full((L, 8), 0, I32), lm_normal=full((L, 3), 0.0, F32),
        lm_dmin=full((L,), 0.1, F32), lm_dmax=full((L,), 100.0, F32),
        lm_visible=full((L,), 1, I32), lm_found=full((L,), 1, I32),
        lm_first_kf=full((L,), -1, I32), lm_ref_kf=full((L,), 0, I32),
        lm_obs_kf=full((L, D), -1, I32), lm_obs_feat=full((L, D), 0, I32),
        n_kf=full((), 0, I32), n_lm=full((), 0, I32),
        n_obs_drop=full((), 0, I32))


def set_last(dst: torch.Tensor, index, values) -> torch.Tensor:
    """``dst`` with ``dst[index] = values`` where, among writes to the same
    element, the last one in batch order wins. ``index`` is one index
    tensor [B] or a tuple of them (multi-dimensional indexing); ``values``
    is [B, ...] or broadcastable to it. Deterministic on every device."""
    if not isinstance(index, tuple):
        index = (index,)
    index = tuple(i.long() for i in index)
    flat = index[0]
    for dim, i in zip(dst.shape[1:len(index)], index[1:]):
        flat = flat * dim + i
    B = flat.shape[0]
    order = torch.arange(B, device=flat.device)
    n = 1
    for s in dst.shape[:len(index)]:
        n *= s
    winner = torch.full((n,), -1, dtype=torch.long, device=flat.device)
    winner = winner.scatter_reduce(0, flat, order, "amax")
    last = winner[flat] == order
    values = torch.as_tensor(values, dtype=dst.dtype, device=dst.device)
    values = values.expand(B, *dst.shape[len(index):])
    out = dst.clone()
    out[tuple(i[last] for i in index)] = values[last]
    return out


def covisibility_weights(m: MapState, kf_idx) -> torch.Tensor:
    """[K] int32 count of landmarks each keyframe shares with ``kf_idx``
    (self zeroed), counting a feature only where it is its landmark's
    registered observation (KeyFrame::UpdateConnections)."""
    K = m.kf_R.shape[0]
    N = m.kf_lm.shape[1]
    lms = m.kf_lm[kf_idx]
    safe = lms.clamp(min=0).long()
    ok = (lms >= 0) & m.kf_feat_valid[kf_idx] & m.lm_valid[safe]
    rows = m.lm_obs_kf[safe]
    feat = m.lm_obs_feat[safe]
    feat_ids = torch.arange(N, dtype=I32, device=lms.device)[:, None]
    primary = ((rows == kf_idx) & (feat == feat_ids)).any(1)
    contrib = ((ok & primary)[:, None] & (rows >= 0)).to(I32)
    w = torch.zeros(K, dtype=I32, device=lms.device).index_add(
        0, rows.clamp(min=0).reshape(-1).long(), contrib.reshape(-1))
    ids = torch.arange(K, device=lms.device)
    w = torch.where(ids == kf_idx, 0, w)
    return w * m.kf_valid.to(I32)


def observation_matrix(m: MapState) -> torch.Tensor:
    """[L, K] float32 incidence: landmark l observed by keyframe k, built
    by scatter. For small-map utilities only (covisibility_weights and
    covisibility_matrix serve the tracker)."""
    L, D = m.lm_obs_kf.shape
    K = m.kf_R.shape[0]
    rows = torch.arange(L, device=m.lm_obs_kf.device)[:, None].expand(L, D)
    vals = ((m.lm_obs_kf >= 0) & m.lm_valid[:, None]).to(torch.float32)
    flat = rows * K + m.lm_obs_kf.clamp(min=0).long()
    return torch.zeros(L * K, dtype=torch.float32,
                       device=m.lm_obs_kf.device).scatter_reduce(
        0, flat.reshape(-1), vals.reshape(-1), "amax").reshape(L, K)


def covisibility_matrix(m: MapState) -> torch.Tensor:
    """[K, K] int32 covisibility weights of every keyframe pair, by the
    same registered-observation rule as covisibility_weights; zero on the
    diagonal and for dead keyframes."""
    K, N = m.kf_lm.shape
    dev = m.kf_lm.device
    safe = m.kf_lm.clamp(min=0).long()
    ok = (m.kf_lm >= 0) & m.kf_feat_valid & m.lm_valid[safe]  # [K, N]
    rows = m.lm_obs_kf[safe]  # [K, N, D]
    feat = m.lm_obs_feat[safe]
    kf_ids = torch.arange(K, dtype=I32, device=dev)
    primary = ((rows == kf_ids[:, None, None])
               & (feat == torch.arange(N, dtype=I32, device=dev)[None, :, None])
               ).any(2)
    contrib = ((ok & primary)[:, :, None] & (rows >= 0)).to(I32)
    flat = kf_ids[:, None, None].long() * K + rows.clamp(min=0).long()
    W = torch.zeros(K * K, dtype=I32, device=dev).index_add(
        0, flat.reshape(-1), contrib.reshape(-1)).reshape(K, K)
    W = W * (1 - torch.eye(K, dtype=I32, device=dev))
    kv = m.kf_valid.to(I32)
    return W * kv[:, None] * kv[None, :]


def landmark_obs_count(m: MapState) -> torch.Tensor:
    """[L] number of observations per landmark."""
    return (m.lm_obs_kf >= 0).sum(1, dtype=I32)


def rank_in_group(key: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """rank[i] = number of j < i with key[j] == key[i] (both valid)."""
    eq = (key[None, :] == key[:, None]) & valid[None, :] & valid[:, None]
    return torch.tril(eq, diagonal=-1).sum(1, dtype=I32)


def add_observation(m: MapState, lm_idx, kf_idx, feat_idx, mask) -> MapState:
    """Append (kf, feat) to each landmark's first free slot and set the
    keyframe back-reference (MapPoint::AddObservation). All args [B];
    observations that find the row full are dropped and counted."""
    D = m.lm_obs_kf.shape[1]
    rows = m.lm_obs_kf[lm_idx.long()]
    slot = (rows >= 0).sum(1, dtype=I32) + rank_in_group(lm_idx, mask)
    ok = mask & (slot < D)
    slot = slot.clamp(0, D - 1)
    safe_lm = torch.where(ok, lm_idx, 0)
    old_kf = m.lm_obs_kf[safe_lm.long(), slot.long()]
    old_ft = m.lm_obs_feat[safe_lm.long(), slot.long()]
    obs_kf = set_last(m.lm_obs_kf, (safe_lm, slot),
                      torch.where(ok, kf_idx, old_kf))
    obs_feat = set_last(m.lm_obs_feat, (safe_lm, slot),
                        torch.where(ok, feat_idx, old_ft))
    safe_kf = torch.where(mask, kf_idx, 0)
    safe_ft = torch.where(mask, feat_idx, 0)
    kf_lm = set_last(m.kf_lm, (safe_kf, safe_ft), torch.where(
        mask, lm_idx, m.kf_lm[safe_kf.long(), safe_ft.long()]))
    n_drop = m.n_obs_drop + (mask & ~ok).sum(dtype=I32)
    return m._replace(lm_obs_kf=obs_kf, lm_obs_feat=obs_feat, kf_lm=kf_lm,
                      n_obs_drop=n_drop)


def rebuild_observations(m: MapState) -> MapState:
    """Rebuild the observation table from the back-references kf_lm: per
    landmark up to D observations in (keyframe, feature) order, one per
    keyframe; entries of dead landmarks, features or keyframes cleared."""
    K, N = m.kf_lm.shape
    L, D = m.lm_obs_kf.shape
    dev = m.kf_lm.device
    kf_lm = torch.where(
        (m.kf_lm >= 0) & m.lm_valid[m.kf_lm.clamp(min=0).long()]
        & m.kf_feat_valid & m.kf_valid[:, None], m.kf_lm, -1)
    flat = torch.where(kf_lm >= 0, kf_lm, L).reshape(-1)
    ids = torch.arange(K * N, dtype=I32, device=dev)
    order = torch.argsort(flat, stable=True)
    slm, skf, sft = flat[order], (ids // N)[order], (ids % N)[order]
    changed = torch.ones_like(slm, dtype=torch.bool)
    changed[1:] = slm[1:] != slm[:-1]
    first = torch.cummax(torch.where(changed, ids, 0), 0).values
    rank = ids - first
    same_kf_as_prev = (slm == torch.roll(slm, 1)) & (skf == torch.roll(skf, 1))
    same_kf_as_prev[0] = False
    ok = (slm < L) & (rank < D) & ~same_kf_as_prev
    tgt_lm = torch.where(ok, slm, L - 1)
    tgt_slot = rank.clamp(0, D - 1)
    obs_kf = set_last(torch.full((L, D), -1, dtype=I32, device=dev),
                      (tgt_lm, tgt_slot), torch.where(ok, skf, -1))
    obs_feat = set_last(torch.zeros((L, D), dtype=I32, device=dev),
                        (tgt_lm, tgt_slot), torch.where(ok, sft, 0))
    n_drop = m.n_obs_drop + ((slm < L) & ~same_kf_as_prev & (rank >= D)).sum(
        dtype=I32)
    return m._replace(kf_lm=kf_lm, lm_obs_kf=obs_kf, lm_obs_feat=obs_feat,
                      n_obs_drop=n_drop)


def merge_landmarks(m: MapState, keep, kill, mask) -> MapState:
    """Replace each kill[i] by keep[i] where mask (MapPoint::Replace):
    remap back-references, invalidate the killed landmarks, merge their
    found/visible counts, rebuild the observation table."""
    L = m.lm_pw.shape[0]
    dev = m.lm_pw.device
    remap = torch.arange(L, dtype=I32, device=dev)
    safe_kill = torch.where(mask, kill, L - 1)
    remap = set_last(remap, safe_kill,
                     torch.where(mask, keep, remap[safe_kill.long()]))
    remap = remap[remap.long()]  # one level of path compression
    kf_lm = torch.where(m.kf_lm >= 0, remap[m.kf_lm.clamp(min=0).long()], -1)
    lm_valid = set_last(m.lm_valid, safe_kill, torch.where(
        mask, False, m.lm_valid[safe_kill.long()]))
    safe_keep = torch.where(mask, keep, 0).long()
    kill_c = kill.clamp(min=0).long()
    found = m.lm_found.index_add(
        0, safe_keep, torch.where(mask, m.lm_found[kill_c], 0))
    visible = m.lm_visible.index_add(
        0, safe_keep, torch.where(mask, m.lm_visible[kill_c], 0))
    m = m._replace(kf_lm=kf_lm, lm_valid=lm_valid, lm_found=found,
                   lm_visible=visible)
    return rebuild_observations(m)


def landmark_compaction_order(lm_valid: torch.Tensor) -> torch.Tensor:
    """new->old landmark permutation of compact_landmarks: live rows
    first, in slot order."""
    return torch.argsort((~lm_valid).to(torch.uint8), stable=True)


def compact_landmarks(m: MapState) -> MapState:
    """Pack live landmarks to the front of the slot arrays, remap the
    keyframe back-references and rewind n_lm to the live count (slots are
    append-only; culls and merges only clear lm_valid)."""
    L = m.lm_pw.shape[0]
    order = landmark_compaction_order(m.lm_valid)
    inv = torch.empty(L, dtype=I32, device=order.device)
    inv[order] = torch.arange(L, dtype=I32, device=order.device)

    def take(a):
        return a[order]

    return m._replace(
        lm_pw=take(m.lm_pw), lm_valid=take(m.lm_valid),
        lm_desc=take(m.lm_desc), lm_normal=take(m.lm_normal),
        lm_dmin=take(m.lm_dmin), lm_dmax=take(m.lm_dmax),
        lm_visible=take(m.lm_visible), lm_found=take(m.lm_found),
        lm_first_kf=take(m.lm_first_kf), lm_ref_kf=take(m.lm_ref_kf),
        lm_obs_kf=take(m.lm_obs_kf), lm_obs_feat=take(m.lm_obs_feat),
        kf_lm=torch.where(m.kf_lm >= 0, inv[m.kf_lm.clamp(min=0).long()], -1),
        n_lm=m.lm_valid.sum(dtype=I32))


def keyframe_compaction(kf_valid: torch.Tensor):
    """(order, rank) of compact_keyframes: the new->old permutation (live
    slots first, in slot order) and, for every old slot, the number of
    live slots before it (its new slot when it is live)."""
    order = torch.argsort((~kf_valid).to(torch.uint8), stable=True)
    live = kf_valid.to(I32)
    return order, torch.cumsum(live, 0, dtype=I32) - live


def compact_keyframes(m: MapState) -> MapState:
    """Pack live keyframes to the front of the slot arrays (order kept)
    and reset n_kf. Observation rows are remapped and repacked (entries
    of evicted keyframes dropped), and landmark first/ref anchors move to
    the live rank, which keeps their order. Holders of keyframe slots
    outside the map remap them with keyframe_compaction's rank."""
    K = m.kf_R.shape[0]
    order, rank = keyframe_compaction(m.kf_valid)
    n_live = m.kf_valid.sum(dtype=I32)

    def take(a):
        return a[order]

    def remap_anchor(a):
        return torch.minimum(rank[a.clamp(0, K - 1).long()],
                             (n_live - 1).clamp(min=0))

    obs = m.lm_obs_kf.clamp(min=0).long()
    alive = (m.lm_obs_kf >= 0) & m.kf_valid[obs]
    new_obs_kf = torch.where(alive, rank[obs], -1)
    holes = torch.argsort((new_obs_kf < 0).to(torch.uint8), dim=1,
                          stable=True)
    return m._replace(
        kf_R=take(m.kf_R), kf_t=take(m.kf_t), kf_valid=take(m.kf_valid),
        kf_frame_id=take(m.kf_frame_id), kf_xy=take(m.kf_xy),
        kf_ur=take(m.kf_ur), kf_depth=take(m.kf_depth),
        kf_octave=take(m.kf_octave), kf_angle=take(m.kf_angle),
        kf_desc=take(m.kf_desc), kf_feat_valid=take(m.kf_feat_valid),
        kf_lm=take(m.kf_lm),
        lm_obs_kf=new_obs_kf.gather(1, holes),
        lm_obs_feat=m.lm_obs_feat.gather(1, holes),
        lm_first_kf=remap_anchor(m.lm_first_kf),
        lm_ref_kf=remap_anchor(m.lm_ref_kf), n_kf=n_live)


def grow_map(m: MapState, k_max: int | None = None,
             l_max: int | None = None) -> MapState:
    """Re-pad the map to a larger keyframe / landmark capacity (between
    frames; the reference's map is unbounded, Map.cc:32-44). New keyframe
    rows are invalid, new landmark rows invalid with empty observation
    slots; the counters are kept. Refuses to shrink."""
    K0, N = m.kf_lm.shape
    L0, D = m.lm_obs_kf.shape
    K, L = int(k_max or K0), int(l_max or L0)
    if K < K0 or L < L0:
        raise ValueError("grow_map cannot shrink capacities")
    if K == K0 and L == L0:
        return m
    fresh = empty_map(MapConfig(K, N, L, D), m.kf_R.device)
    out = {}
    for name in MapState._fields:
        a = getattr(m, name)
        if name in ("n_kf", "n_lm", "n_obs_drop"):
            out[name] = a
            continue
        f = getattr(fresh, name)
        f[tuple(slice(0, s) for s in a.shape)] = a
        out[name] = f
    return MapState(**out)
