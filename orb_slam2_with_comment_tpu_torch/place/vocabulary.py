"""Binary BoW vocabulary, its training, and tf-idf scoring (port of
place/vocabulary.py).

DBoW2's TemplatedVocabulary (reference: TemplatedVocabulary.h:1218-1259
transform, :1127-1194 tf-idf and L1 scoring) as flat tensors: node
descriptors, a children table and leaf word ids. ``transform`` descends
all descriptors through all levels at once (argmin Hamming over the k
children, first minimum wins). A keyframe's tf-idf vector is kept sparse
as (word id, weight) pairs, and the L1 score of two L1-normalized vectors
is the histogram intersection over their common words; ``bow_vectors`` and
``score_l1`` are the dense forms, [..., n_words] rows.

``train_vocabulary`` builds a tree by hierarchical binary k-means with
bitwise-majority means (DBoW2's create()); it is numpy, a copy of the JAX
package's, so the two train the same tree from the same descriptors and
seed, and ``save_vocabulary`` writes the JAX package's file format.

The packaged vocabulary, ``data/vocab_default.npz`` beside this module, is
a byte-for-byte copy of the JAX package's data file.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .. import spans
from ..ops.hamming import BIG, hamming_pair

DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data", "vocab_default.npz")
# the earlier 10k-word tree (24 training worlds), for examples/eval_vocab.py
VOCAB_10K_PATH = os.path.join(os.path.dirname(DEFAULT_PATH), "vocab_10k.npz")
_NO_WORD = torch.iinfo(torch.int32).max


class Vocabulary(NamedTuple):
    node_desc: torch.Tensor  # [n_nodes, 8] int32 (uint32 bit patterns)
    children: torch.Tensor  # [n_nodes, k] int32, -1 = none (root = node 0)
    leaf_word: torch.Tensor  # [n_nodes] int32 word id or -1
    word_weight: torch.Tensor  # [n_words] float32 idf weight
    k: int
    levels: int
    n_words: int


_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _kmajority(descs: np.ndarray, k: int, rng, iters: int = 8):
    """Binary k-means with bitwise-majority means (FORB::meanValue
    semantics, reference: FORB.cpp:107-143). descs [M, 8] uint32.

    Distances run on packed bytes through a popcount table: peak memory is
    [M, k, 32] uint8 instead of the [M, k, 256] bool of the unpacked
    form."""
    M = len(descs)
    k = min(k, M)
    centers = descs[rng.choice(M, k, replace=False)]
    dbytes = descs.view(np.uint8).reshape(M, 32)
    assign = np.zeros(M, np.int64)
    for _ in range(iters):
        cbytes = centers.view(np.uint8).reshape(k, 32)
        d = _POPCNT8[np.bitwise_xor(dbytes[:, None, :],
                                    cbytes[None, :, :])].sum(
            -1, dtype=np.int32)  # [M, k]
        assign = d.argmin(1)
        new = []
        for j in range(k):
            sel = dbytes[assign == j]
            if len(sel) == 0:
                new.append(descs[rng.randint(M)].view(np.uint8).reshape(32))
                continue
            selbits = np.unpackbits(sel, axis=-1)
            new.append(np.packbits(
                (selbits.mean(0) >= 0.5).astype(np.uint8)))
        centers = np.stack(new).view(np.uint32).reshape(k, 8)
    return centers, assign


def train_vocabulary(descs, k: int = 10, levels: int = 3, seed: int = 0,
                     device="cuda") -> Vocabulary:
    """Hierarchical k-majority training (reference DBoW2 create()) of
    descriptors [M, 8] (uint32, or int32 holding the same bits; numpy or a
    tensor). The tree is built on the host; the vocabulary lands on
    ``device``."""
    if isinstance(descs, torch.Tensor):
        descs = descs.cpu().numpy()
    descs = np.asarray(descs)
    if descs.dtype == np.int32:
        descs = descs.view(np.uint32)
    rng = np.random.RandomState(seed)
    descs = np.asarray(descs, np.uint32).reshape(-1, 8)
    node_desc = [np.zeros(8, np.uint32)]  # root placeholder
    children: list[list[int]] = [[]]
    leaf_word = [-1]
    leaf_counts: list[int] = []

    def split(node_id, subset, depth):
        if depth == levels or len(subset) <= k:
            # the node is a leaf: a word
            leaf_id = len(leaf_counts)
            leaf_word[node_id] = leaf_id
            leaf_counts.append(max(len(subset), 1))
            return
        centers, assign = _kmajority(subset, k, rng)
        for j in range(len(centers)):
            child_id = len(node_desc)
            node_desc.append(centers[j])
            children.append([])
            leaf_word.append(-1)
            children[node_id].append(child_id)
            split(child_id, subset[assign == j], depth + 1)

    split(0, descs, 0)
    n_nodes = len(node_desc)
    n_words = len(leaf_counts)
    ch = np.full((n_nodes, k), -1, np.int32)
    for i, c in enumerate(children):
        ch[i, :len(c)] = c
    # idf weights (reference: TemplatedVocabulary TF_IDF weighting)
    counts = np.asarray(leaf_counts, np.float64)
    idf = np.log(len(descs) / np.clip(counts, 1, None)).astype(np.float32)
    return Vocabulary(
        torch.tensor(np.stack(node_desc).view(np.int32), device=device),
        torch.tensor(ch, device=device),
        torch.tensor(np.asarray(leaf_word, np.int32), device=device),
        torch.tensor(idf, device=device), k, levels, n_words)


def save_vocabulary(voc: Vocabulary, path: str) -> None:
    """Persist a vocabulary as flat arrays (npz) in the JAX package's
    format: node descriptors as uint32."""
    np.savez_compressed(
        path if path.endswith(".npz") else path + ".npz",
        node_desc=voc.node_desc.cpu().numpy().view(np.uint32),
        children=voc.children.cpu().numpy(),
        leaf_word=voc.leaf_word.cpu().numpy(),
        word_weight=voc.word_weight.cpu().numpy(),
        k=voc.k, levels=voc.levels, n_words=voc.n_words)


def load_vocabulary(path: str, device) -> Vocabulary:
    """Load a vocabulary saved by the JAX package's save_vocabulary."""
    with np.load(path) as z:
        return Vocabulary(
            torch.tensor(z["node_desc"].astype(np.uint32).view(np.int32),
                         device=device),
            torch.tensor(z["children"].astype(np.int32), device=device),
            torch.tensor(z["leaf_word"].astype(np.int32), device=device),
            torch.tensor(z["word_weight"].astype(np.float32), device=device),
            int(z["k"]), int(z["levels"]), int(z["n_words"]))


def load_default_vocabulary(device) -> Vocabulary:
    """The packaged default vocabulary (the ORBvoc.txt counterpart)."""
    return load_vocabulary(DEFAULT_PATH, device)


def transform(voc: Vocabulary, desc: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Descend the tree: [N, 8] descriptors -> [N] word ids (-1 invalid)."""
    node = torch.zeros(desc.shape[0], dtype=torch.long, device=desc.device)
    for _ in range(voc.levels):
        ch = voc.children[node]  # [N, k]
        d = hamming_pair(desc[:, None, :],
                         voc.node_desc[ch.clamp(min=0).long()])
        d = torch.where(ch >= 0, d, BIG)
        nxt = ch.gather(1, torch.argmin(d, 1)[:, None])[:, 0].long()
        node = torch.where(nxt >= 0, nxt, node)  # leaves stay put
    return torch.where(valid, voc.leaf_word[node], -1)


def bow_vectors(voc: Vocabulary, words: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """[..., N] word ids -> dense L1-normalized tf-idf vectors [..., W].
    The L1 norm is summed in float64, exactly for any order of the terms,
    so every device gives the same rows."""
    W = voc.n_words
    ok = valid & (words >= 0)
    idx = torch.where(ok, words, W).long()
    tf = torch.zeros((*words.shape[:-1], W + 1), dtype=torch.float32,
                     device=words.device)
    tf = tf.scatter_add_(-1, idx, torch.ones_like(idx, dtype=torch.float32))
    v = tf[..., :W] * voc.word_weight
    norm = v.abs().sum(-1, keepdim=True, dtype=torch.float64).to(
        torch.float32)
    return v / norm.clamp(min=1e-9)


def score_l1(v: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score (reference: ScoringObject L1Scoring) of an
    L1-normalized v [W] against the rows of db [K, W]: s = 1 - 0.5 *
    |v - w|_1, the distance summed in float64."""
    d = (v[None, :] - db).abs().sum(-1, dtype=torch.float64)
    return 1.0 - 0.5 * d.to(torch.float32)


def bow_sparse(voc: Vocabulary, words: torch.Tensor, valid: torch.Tensor,
               cap: int):
    """[N] word ids -> sparse L1-normalized tf-idf row (idx [cap] int32
    word ids in increasing order, -1 padded; w [cap] float32). cap >= N
    is lossless; a smaller cap drops the highest word ids."""
    N = words.shape[0]
    dev = words.device
    ok = valid & (words >= 0)
    sw = torch.sort(torch.where(ok, words, _NO_WORD)).values
    first = torch.ones(N, dtype=torch.bool, device=dev)
    first[1:] = sw[1:] != sw[:-1]
    tf = (torch.searchsorted(sw, sw, right=True)
          - torch.searchsorted(sw, sw)).to(torch.float32)
    keep = first & (sw < _NO_WORD)
    order = torch.argsort((~keep).to(torch.uint8), stable=True)[:cap]
    got = keep[order]
    if cap > N:
        order = torch.cat([order, order.new_zeros(cap - N)])
        got = torch.cat([got, got.new_zeros(cap - N)])
    idx = torch.where(got, sw[order], -1).to(torch.int32)
    w = torch.where(got, tf[order] * voc.word_weight[idx.clamp(min=0).long()],
                    0.0)
    return idx, w / w.sum().clamp(min=1e-9)


def score_l1_sparse(q_idx, q_w, rows_idx, rows_w, n_words: int):
    """L1 score of one sparse query (q_idx/q_w [T]) against K sparse rows
    (rows_idx/rows_w [K, T]): [K] scores, 0 for empty rows."""
    spans.table_read("score_l1_sparse", rows_idx, rows_w)
    # padding (-1) lands in a spare slot past the last word
    safe = torch.where(q_idx >= 0, q_idx, n_words).long()
    scratch = torch.zeros(n_words + 1, dtype=q_w.dtype, device=q_w.device)
    scratch = scratch.index_put((safe,), q_w)
    qv = scratch[rows_idx.clamp(min=0).long()]
    rv = torch.where(rows_idx >= 0, rows_w, 0.0)
    return torch.minimum(qv, rv).sum(-1)
