"""Binary BoW vocabulary and sparse tf-idf rows (port of
place/vocabulary.py: the tree descent, sparse rows and L1 scoring).

DBoW2's TemplatedVocabulary (reference: TemplatedVocabulary.h:1218-1259
transform, :1127-1194 tf-idf and L1 scoring) as flat tensors: node
descriptors, a children table and leaf word ids. ``transform`` descends
all descriptors through all levels at once (argmin Hamming over the k
children, first minimum wins). A keyframe's tf-idf vector is kept sparse
as (word id, weight) pairs, and the L1 score of two L1-normalized vectors
is the histogram intersection over their common words.

The packaged vocabulary, ``data/vocab_default.npz`` beside this module, is
a byte-for-byte copy of the JAX package's data file.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..ops.hamming import BIG, hamming_pair

DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data", "vocab_default.npz")
_NO_WORD = torch.iinfo(torch.int32).max


class Vocabulary(NamedTuple):
    node_desc: torch.Tensor  # [n_nodes, 8] int32 (uint32 bit patterns)
    children: torch.Tensor  # [n_nodes, k] int32, -1 = none (root = node 0)
    leaf_word: torch.Tensor  # [n_nodes] int32 word id or -1
    word_weight: torch.Tensor  # [n_words] float32 idf weight
    k: int
    levels: int
    n_words: int


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
    # padding (-1) lands in a spare slot past the last word
    safe = torch.where(q_idx >= 0, q_idx, n_words).long()
    scratch = torch.zeros(n_words + 1, dtype=q_w.dtype, device=q_w.device)
    scratch = scratch.index_put((safe,), q_w)
    qv = scratch[rows_idx.clamp(min=0).long()]
    rv = torch.where(rows_idx >= 0, rows_w, 0.0)
    return torch.minimum(qv, rv).sum(-1)
