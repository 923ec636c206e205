"""Keyframe database: sparse BoW rows and candidate retrieval (port of
place/database.py).

The reference's word -> keyframe inverted file (KeyFrameDatabase.cc)
becomes sparse (word id, tf-idf weight) rows [K, T], one per keyframe
slot. Loop and relocalization candidates come from one batched L1 score
against every keyframe, then the reference's gating on the host: covisible
keyframes excluded, a minimum score, scores accumulated over each
candidate's top-10 covisibility group and kept above 0.75 of the best
(DetectLoopCandidates :76-197, DetectRelocalizationCandidates :199-309).
"""
from __future__ import annotations

import numpy as np
import torch

from ..mapstate.map import MapState, covisibility_matrix
from . import vocabulary as V


def to_numpy(a) -> np.ndarray:
    """A tensor on any device, or an array, as numpy."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class KeyFrameDatabase:
    """Sparse BoW rows aligned with the map's keyframe slots, on the
    vocabulary's device."""

    def __init__(self, voc: V.Vocabulary, k_max: int, bow_cap: int = 1024):
        self.voc = voc
        self.bow_cap = bow_cap
        dev = voc.node_desc.device
        self.bow_idx = torch.full((k_max, bow_cap), -1, dtype=torch.int32,
                                  device=dev)
        self.bow_w = torch.zeros((k_max, bow_cap), device=dev)

    def add(self, kf: int, desc: torch.Tensor, valid: torch.Tensor):
        """KeyFrame::ComputeBoW + KeyFrameDatabase::add for slot ``kf``."""
        idx, w = self.frame_vector(desc, valid)
        self.bow_idx = self.bow_idx.clone()
        self.bow_w = self.bow_w.clone()
        self.bow_idx[kf] = idx
        self.bow_w[kf] = w

    def permute(self, live_slots: np.ndarray, n_live: int):
        """Mirror compact_keyframes: live rows move to the front in order,
        evicted rows are cleared (KeyFrameDatabase::erase)."""
        k_max = self.bow_idx.shape[0]
        dev = self.bow_idx.device
        order = np.zeros(k_max, np.int64)
        order[:n_live] = live_slots[:n_live]
        order = torch.as_tensor(order, device=dev)
        mask = (torch.arange(k_max, device=dev) < n_live)[:, None]
        self.bow_idx = torch.where(mask, self.bow_idx[order], -1)
        self.bow_w = torch.where(mask, self.bow_w[order], 0.0)

    def grow(self, k_max: int):
        """Re-pad the rows after map capacity growth."""
        k0 = self.bow_idx.shape[0]
        if k_max > k0:
            pad = k_max - k0
            self.bow_idx = torch.cat([self.bow_idx, self.bow_idx.new_full(
                (pad, self.bow_cap), -1)])
            self.bow_w = torch.cat([self.bow_w, self.bow_w.new_zeros(
                (pad, self.bow_cap))])

    def frame_vector(self, desc: torch.Tensor, valid: torch.Tensor):
        voc = self.voc
        return V.bow_sparse(voc, V.transform(voc, desc, valid), valid,
                            self.bow_cap)

    def scores(self, vec, kf_valid: torch.Tensor) -> torch.Tensor:
        """vec: a sparse (idx, w) pair from frame_vector or a stored row."""
        qi, qw = vec
        return torch.where(kf_valid, V.score_l1_sparse(
            qi, qw, self.bow_idx, self.bow_w, self.voc.n_words), -1.0)

    def detect_loop_candidates(self, m: MapState, kf: int, min_score: float,
                               max_candidates: int = 5,
                               covis: np.ndarray | None = None,
                               scores: np.ndarray | None = None) -> list[int]:
        """The reference's gating (KeyFrameDatabase.cc:76-197) over the
        scores. covis / scores: the covisibility matrix and this
        keyframe's score vector as numpy, when the caller has them."""
        if covis is None:
            covis = to_numpy(covisibility_matrix(m))
        s = (np.array(scores) if scores is not None
             else np.array(to_numpy(self.scores(
                 (self.bow_idx[kf], self.bow_w[kf]), m.kf_valid))))
        s[kf] = -1
        s[covis[kf] > 0] = -1
        s[~to_numpy(m.kf_valid)] = -1
        cand = np.where(s >= min_score)[0]
        if len(cand) == 0:
            return []
        acc = {}
        for c in cand:
            wc = covis[int(c)]
            group = np.argsort(-wc)[:10]
            group = [int(g) for g in group if wc[g] > 0] + [int(c)]
            group_scores = [s[g] for g in group if s[g] > 0]
            acc[int(c)] = (float(sum(group_scores)) if group_scores
                           else float(s[c]))
        best_acc = max(acc.values())
        keep = [c for c, a in acc.items() if a > 0.75 * best_acc]
        keep.sort(key=lambda c: -s[c])
        return keep[:max_candidates]

    def detect_reloc_candidates(self, m: MapState, desc: torch.Tensor,
                                valid: torch.Tensor,
                                max_candidates: int = 5) -> list[int]:
        """Relocalization candidates (DetectRelocalizationCandidates
        :199-309): each candidate's score accumulated over its top-10
        covisibility group, groups above 0.75 of the best accumulated
        score kept, each surviving group's best member returned in
        accumulated-score order. Candidates below 0.05 of the best raw
        score are dropped first (a bound on the host loop, not a gate the
        reference has)."""
        kf_valid = to_numpy(m.kf_valid)
        s = to_numpy(self.scores(self.frame_vector(desc, valid), m.kf_valid))
        s = np.where(kf_valid, s, -1.0)
        cand = np.where(s > 0)[0]
        if len(cand) == 0:
            return []
        cand = cand[s[cand] >= 0.05 * s[cand].max()]
        covis = to_numpy(covisibility_matrix(m))
        acc: dict[int, float] = {}
        best_of_group: dict[int, int] = {}
        for c in cand:
            wc = covis[int(c)]
            group = np.argsort(-wc)[:10]
            group = [int(g) for g in group if wc[g] > 0] + [int(c)]
            g_scores = [(s[g], g) for g in group if s[g] > 0]
            acc[int(c)] = (float(sum(v for v, _ in g_scores))
                           if g_scores else float(s[c]))
            best_of_group[int(c)] = (max(g_scores)[1] if g_scores
                                     else int(c))
        best_acc = max(acc.values())
        keep = [(a, best_of_group[c]) for c, a in acc.items()
                if a >= 0.75 * best_acc]
        keep.sort(key=lambda x: -x[0])
        out: list[int] = []
        for _, g in keep:
            if g not in out:
                out.append(g)
        return out[:max_candidates]
