"""Map and session checkpoints (port of checkpoint.py).

The file format is the JAX package's, key for key and dtype for dtype, so
a file written by either package loads in the other: a map is one .npz of
its MapState fields (descriptors as uint32); a session adds the host
tracker's pose, velocity, relative trajectory log, keyframe uids and
archive, and a meta JSON; an AutoTracker checkpoint stores the AutoState
leaves as ``auto_NNN`` in the order jax.tree.flatten gives the JAX
package's AutoState, and the frame count and timestamps. The JAX loop
carry's PRNG key has no counterpart here: it is written as PRNGKey(7)'s
[0, 7] and ignored on load (a loaded AutoState starts a fresh generator).
"""
from __future__ import annotations

import json

import numpy as np
import torch

from . import convert
from .mapstate.map import MapState
from .matching.search import FeatureSet

_KEY_OF_SEED_7 = np.array([0, 7], np.uint32)
# the JAX AutoState's fields in declaration order; nested bundles by name
_AUTO_FIELDS = (
    "map", "prev", "last_R", "last_t", "vel_R", "vel_t", "have_vel",
    "ref_kf", "last_kf_frame", "frame_idx", "initialized", "lost", "loop",
    "init_frame_id", "maint_kf", "maint_phase", "maint_neighbors",
    "maint_lambda", "n_compact_lm", "n_compact_kf", "traj_R", "traj_t",
    "traj_Rcr", "traj_tcr", "traj_ref", "traj_valid", "traj_stats")
_LOOP_FIELDS = ("bow_idx", "bow_w", "prev_groups", "prev_counts",
                "last_loop_kf", "n_loops", "key", "loop_edges")


def _path(path: str) -> str:
    return path if str(path).endswith(".npz") else path + ".npz"


def _meta(arrays: dict, key: str, meta: dict):
    arrays[key] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def save_map(path: str, m: MapState) -> None:
    """A MapState as one .npz file."""
    np.savez_compressed(path, **convert.map_to_numpy(m))


def load_map(path: str, device="cuda") -> MapState:
    """A MapState from a .npz file, on ``device`` (the card unless the
    caller names the CPU; without a card that raises, as the Tracker
    does)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_map: no CUDA device; pass device='cpu' "
                           "to load the map on the CPU")
    data = np.load(_path(path))
    return convert.map_from_numpy(
        {f: (data[f] if f in data.files else np.int32(0))  # newer counters
         for f in MapState._fields}, device)


# -- AutoTracker ---------------------------------------------------------------

def _auto_leaves(d: dict) -> list[np.ndarray]:
    """convert.auto_state_to_numpy's dict as the JAX AutoState's leaves."""
    out = []
    for f in _AUTO_FIELDS:
        v = d[f]
        if f == "map":
            out += [v[g] for g in MapState._fields]
        elif f == "prev":
            out += [v["feats"][g] for g in FeatureSet._fields]
            out += [v["depth"], v["lm"]]
        elif f == "loop":
            out += [_KEY_OF_SEED_7 if g == "key" else v[g]
                    for g in _LOOP_FIELDS]
        else:
            out.append(v)
    return [np.asarray(a) for a in out]


def _auto_dict(leaves: list) -> dict:
    """The inverse of _auto_leaves (the key dropped)."""
    it = iter(leaves)
    d = {}
    for f in _AUTO_FIELDS:
        if f == "map":
            d[f] = {g: next(it) for g in MapState._fields}
        elif f == "prev":
            feats = {g: next(it) for g in FeatureSet._fields}
            d[f] = {"feats": feats, "depth": next(it), "lm": next(it)}
        elif f == "loop":
            d[f] = {g: next(it) for g in _LOOP_FIELDS}
            del d[f]["key"]
        else:
            d[f] = next(it)
    return d


def save_auto_state(path: str, tracker) -> None:
    """Checkpoint an AutoTracker: its whole AutoState and the frame count
    and timestamps."""
    leaves = _auto_leaves(convert.auto_state_to_numpy(tracker.state))
    arrays = {f"auto_{i:03d}": a for i, a in enumerate(leaves)}
    _meta(arrays, "auto_meta_json", {"frame_count": tracker.frame_count,
                                     "timestamps": tracker.timestamps})
    np.savez_compressed(path, **arrays)


def load_auto_state(path: str, tracker) -> None:
    """Restore an AutoTracker checkpoint into a tracker of the same
    capacities, on the tracker's device."""
    data = np.load(_path(path))
    keys = sorted(k for k in data.files
                  if k.startswith("auto_") and k[5:].isdigit())
    tracker.state = convert.auto_state_from_numpy(
        _auto_dict([data[k] for k in keys]), tracker.device)
    meta = json.loads(bytes(data["auto_meta_json"]).decode())
    tracker.frame_count = meta["frame_count"]
    tracker.timestamps = list(meta["timestamps"])


# -- the host Tracker ------------------------------------------------------------

def save_session(path: str, tracker) -> None:
    """Checkpoint the map and the tracker's host state (resumable
    mid-sequence)."""
    tracker.flush()
    arrays = {f"map_{f}": a for f, a in convert.map_to_numpy(
        tracker.map).items()}
    arrays["last_R"] = tracker.last_R.cpu().numpy()
    arrays["last_t"] = tracker.last_t.cpu().numpy()
    if tracker.velocity is not None:
        arrays["vel_R"] = tracker.velocity[0].cpu().numpy()
        arrays["vel_t"] = tracker.velocity[1].cpu().numpy()
    if tracker.rel_log:
        log = tracker.rel_log
        arrays["rel_frame"] = np.asarray([r[0] for r in log])
        arrays["rel_ts"] = np.asarray([r[1] for r in log])
        arrays["rel_ref"] = np.asarray([r[2] for r in log])
        arrays["rel_R"] = torch.stack([torch.as_tensor(r[3]).cpu()
                                       for r in log]).numpy()
        arrays["rel_t"] = torch.stack([torch.as_tensor(r[4]).cpu()
                                       for r in log]).numpy()
    if tracker.kf_archive:
        uids = sorted(tracker.kf_archive)
        arrays["arch_uid"] = np.asarray(uids, np.int64)
        arrays["arch_anchor"] = np.asarray(
            [tracker.kf_archive[u][0] for u in uids], np.int64)
        arrays["arch_R"] = np.stack([tracker.kf_archive[u][1] for u in uids])
        arrays["arch_t"] = np.stack([tracker.kf_archive[u][2] for u in uids])
    _meta(arrays, "meta_json", {
        "state": tracker.state.name,
        "ref_kf": int(tracker.ref_kf),
        "last_kf_frame": int(tracker.last_kf_frame),
        "frame_count": int(tracker.frame_count),
        "n_kf_host": int(tracker.n_kf_host),
        "n_inliers": int(tracker._n_inliers),
        "sensor": tracker.cfg.sensor,
        "kf_uids": list(tracker.kf_uids),
        "kf_uid_counter": int(tracker._kf_uid_counter),
    })
    np.savez_compressed(path, **arrays)


def load_session(path: str, tracker) -> None:
    """Restore the map and host state into a configured Tracker; the place
    recognition index is rebuilt from the keyframes' descriptors, and the
    last frame bundle from the reference keyframe's features."""
    from .pipeline import steps
    from .pipeline.tracking import TrackState
    data = np.load(_path(path))
    dev = tracker.device
    tracker.map = convert.map_from_numpy(
        {f: data[f"map_{f}"] for f in MapState._fields}, dev)
    meta = json.loads(bytes(data["meta_json"]).decode())
    tracker.state = TrackState[meta["state"]]
    tracker.ref_kf = meta["ref_kf"]
    tracker.last_kf_frame = meta["last_kf_frame"]
    tracker.frame_count = meta["frame_count"]
    tracker.n_kf_host = meta["n_kf_host"]
    tracker._n_inliers = meta["n_inliers"]
    tracker.kf_uids = list(meta.get("kf_uids", range(meta["n_kf_host"])))
    tracker._kf_uid_counter = int(meta.get("kf_uid_counter",
                                           meta["n_kf_host"]))
    tracker.kf_archive = {}
    if "arch_uid" in data:
        anchors = (data["arch_anchor"] if "arch_anchor" in data
                   else np.full(len(data["arch_uid"]), -1, np.int64))
        for i, u in enumerate(data["arch_uid"]):
            tracker.kf_archive[int(u)] = (int(anchors[i]), data["arch_R"][i],
                                          data["arch_t"][i])

    def up(a):
        return torch.as_tensor(a).to(dev)

    tracker.last_R = up(data["last_R"])
    tracker.last_t = up(data["last_t"])
    tracker.velocity = ((up(data["vel_R"]), up(data["vel_t"]))
                        if "vel_R" in data else None)
    tracker.rel_log = []
    if "rel_frame" in data:
        for i in range(len(data["rel_frame"])):
            tracker.rel_log.append(
                (int(data["rel_frame"][i]), float(data["rel_ts"][i]),
                 int(data["rel_ref"][i]), up(data["rel_R"][i]),
                 up(data["rel_t"][i])))
    if tracker.n_kf_host > 0 and tracker.db is None:
        tracker._make_place_recognition(fix_scale=tracker.cfg.sensor != "mono")
        for k in range(tracker.n_kf_host):
            tracker.db.add(k, tracker.map.kf_desc[k],
                           tracker.map.kf_feat_valid[k])
    k, m = tracker.ref_kf, tracker.map
    tracker.last_obs = steps.FrameObs(steps._kf_featureset(m, k),
                                      m.kf_depth[k], m.kf_lm[k])
