"""Carry state between the JAX package and the port, as numpy arrays.

``*_from_numpy`` take the JAX package's state after ``jax.device_get``: a
MapState / AutoState NamedTuple of numpy arrays, or a dict keyed by the
same field names (nested for ``prev`` and its ``feats``). They return the
port's state on ``device``. ``*_to_numpy`` give back dicts keyed by the
JAX field names, with descriptors as uint32 again. Nothing here imports
JAX. The JAX loop carry's PRNG key has no counterpart: a carry made here
starts a fresh torch.Generator seeded with auto_loop.SEED (7, as
the JAX carry's PRNGKey(7)), so random draws after a conversion differ
from the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from .mapstate.map import MapState
from .matching.search import FeatureSet
from .pipeline import auto_loop
from .pipeline.auto import AutoState
from .pipeline.steps import FrameObs

_DESC_FIELDS = ("kf_desc", "lm_desc", "desc")
_AUTO_HOST_INT = ("ref_kf", "last_kf_frame", "frame_idx", "lost",
                  "init_frame_id", "maint_kf", "maint_phase", "n_compact_lm",
                  "n_compact_kf")
_LOOP_TENSORS = ("bow_idx", "bow_w", "prev_groups", "prev_counts",
                 "loop_edges")
_LOOP_HOST_INT = ("last_loop_kf", "n_loops")
_AUTO_TENSORS = ("last_R", "last_t", "vel_R", "vel_t", "maint_lambda",
                 "traj_R", "traj_t", "traj_Rcr", "traj_tcr", "traj_ref",
                 "traj_valid", "traj_stats")


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _to_tensor(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if name in _DESC_FIELDS:
        a = a.astype(np.uint32).view(np.int32)
    return torch.tensor(a, device=device)  # a copy: JAX's arrays are read-only


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if name in _DESC_FIELDS else a


def map_from_numpy(m, device) -> MapState:
    return MapState(**{f: _to_tensor(f, _get(m, f), device)
                       for f in MapState._fields})


def map_to_numpy(m: MapState) -> dict:
    return {f: _to_numpy(f, getattr(m, f)) for f in MapState._fields}


def loop_from_numpy(c, device) -> auto_loop.LoopCarry:
    out = {f: _to_tensor(f, _get(c, f), device) for f in _LOOP_TENSORS}
    out.update({f: int(np.asarray(_get(c, f))) for f in _LOOP_HOST_INT})
    return auto_loop.LoopCarry(gen=auto_loop.new_generator(device), **out)


def loop_to_numpy(c: auto_loop.LoopCarry) -> dict:
    out = {f: _to_numpy(f, getattr(c, f)) for f in _LOOP_TENSORS}
    out.update({f: np.int32(getattr(c, f)) for f in _LOOP_HOST_INT})
    return out


def _prev_from_numpy(p, device) -> FrameObs:
    feats = _get(p, "feats")
    return FrameObs(
        FeatureSet(**{f: _to_tensor(f, _get(feats, f), device)
                      for f in FeatureSet._fields}),
        _to_tensor("depth", _get(p, "depth"), device),
        _to_tensor("lm", _get(p, "lm"), device))


def auto_state_from_numpy(s, device) -> AutoState:
    out = {f: int(np.asarray(_get(s, f))) for f in _AUTO_HOST_INT}
    out.update({f: _to_tensor(f, _get(s, f), device) for f in _AUTO_TENSORS})
    out["maint_lambda"] = out["maint_lambda"].to(torch.float32).reshape(())
    out["have_vel"] = bool(np.asarray(_get(s, "have_vel")))
    out["initialized"] = bool(np.asarray(_get(s, "initialized")))
    out["maint_neighbors"] = tuple(
        int(v) for v in np.asarray(_get(s, "maint_neighbors")))
    out["map"] = map_from_numpy(_get(s, "map"), device)
    out["loop"] = loop_from_numpy(_get(s, "loop"), device)
    out["prev"] = _prev_from_numpy(_get(s, "prev"), device)
    return AutoState(**out)


def auto_state_to_numpy(s: AutoState) -> dict:
    out = {f: np.int32(getattr(s, f)) for f in _AUTO_HOST_INT}
    out.update({f: _to_numpy(f, getattr(s, f)) for f in _AUTO_TENSORS})
    out["have_vel"] = np.bool_(s.have_vel)
    out["initialized"] = np.bool_(s.initialized)
    out["maint_neighbors"] = np.asarray(s.maint_neighbors, np.int32)
    out["map"] = map_to_numpy(s.map)
    out["loop"] = loop_to_numpy(s.loop)
    out["prev"] = {"feats": {f: _to_numpy(f, getattr(s.prev.feats, f))
                             for f in FeatureSet._fields},
                   "depth": _to_numpy("depth", s.prev.depth),
                   "lm": _to_numpy("lm", s.prev.lm)}
    return out
