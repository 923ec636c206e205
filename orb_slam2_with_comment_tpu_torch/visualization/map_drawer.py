"""Map export: point cloud and keyframe graph (the reference's MapDrawer;
port of visualization/map_drawer.py).

Rebuild of MapDrawer::DrawMapPoints / DrawKeyFrames and the covisibility
graph (reference: src/MapDrawer.cc:44-226) as headless exporters:

- export_map_ply: landmarks and keyframe centers as a PLY point cloud any
  3D viewer opens (landmarks white, reference/local points red like the
  reference's color scheme, keyframe centers blue);
- export_map_json: the whole graph (keyframe poses, covisibility edges
  above the reference's weight threshold, landmark positions) for a web
  viewer.

Each reads the port's MapState tensors, moves the ones it needs to the
host once, and then writes exactly what the JAX package writes for the
same map.
"""
from __future__ import annotations

import json

import numpy as np
import torch

_FIELDS = ("lm_valid", "lm_pw", "kf_R", "kf_t", "kf_lm", "kf_feat_valid")


class _HostMap:
    """The fields the exporters read, as numpy, each copied once."""

    def __init__(self, m):
        for f in _FIELDS:
            a = getattr(m, f)
            setattr(self, f, a.cpu().numpy() if isinstance(a, torch.Tensor)
                    else np.asarray(a))


def _host(m):
    return m if isinstance(m, _HostMap) else _HostMap(m)


def _map_arrays(m, n_kf: int):
    lm_valid = np.asarray(m.lm_valid)
    pts = np.asarray(m.lm_pw)[lm_valid]
    kf_R = np.asarray(m.kf_R[:n_kf])
    kf_t = np.asarray(m.kf_t[:n_kf])
    centers = -np.einsum("kij,ki->kj", kf_R.transpose(0, 2, 1), kf_t)
    return pts, kf_R, kf_t, centers


def export_map_ply(path: str, m, n_kf: int, local_mask=None) -> None:
    """Write landmarks + keyframe centers as an ASCII PLY point cloud."""
    m = _host(m)
    pts, _, _, centers = _map_arrays(m, n_kf)
    lm_valid = np.asarray(m.lm_valid)
    if local_mask is not None:
        if isinstance(local_mask, torch.Tensor):
            local_mask = local_mask.cpu().numpy()
        red = np.asarray(local_mask)[lm_valid]
    else:
        red = np.zeros(len(pts), bool)
    with open(path, "w") as f:
        n = len(pts) + len(centers)
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {n}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                "end_header\n")
        for p, r in zip(pts, red):
            c = "200 40 40" if r else "220 220 220"
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} {c}\n")
        for c3 in centers:
            f.write(f"{c3[0]:.5f} {c3[1]:.5f} {c3[2]:.5f} 40 90 230\n")


def covisibility_edges(m, n_kf: int, min_weight: int = 15):
    """Covisibility edges above weight threshold (reference draws the
    graph for w>=100 essential edges and all spanning-tree edges;
    MapDrawer.cc:179-220, KeyFrame th=15)."""
    m = _host(m)
    kf_lm = np.asarray(m.kf_lm[:n_kf])
    feat_valid = np.asarray(m.kf_feat_valid[:n_kf])
    lm_valid = np.asarray(m.lm_valid)
    edges = []
    sets = []
    for k in range(n_kf):
        ids = kf_lm[k][feat_valid[k]]
        ids = ids[(ids >= 0)]
        ids = ids[lm_valid[ids]]
        sets.append(set(ids.tolist()))
    for a in range(n_kf):
        for b in range(a + 1, n_kf):
            w = len(sets[a] & sets[b])
            if w >= min_weight:
                edges.append((a, b, w))
    return edges


def export_map_json(path: str, m, n_kf: int, min_weight: int = 15) -> None:
    m = _host(m)
    pts, kf_R, kf_t, centers = _map_arrays(m, n_kf)
    doc = {
        "keyframes": [
            {"id": k, "R": kf_R[k].tolist(), "t": kf_t[k].tolist(),
             "center": centers[k].tolist()}
            for k in range(n_kf)
        ],
        "covisibility": [
            {"a": a, "b": b, "weight": w}
            for a, b, w in covisibility_edges(m, n_kf, min_weight)
        ],
        "points": pts.tolist(),
    }
    with open(path, "w") as f:
        json.dump(doc, f)
