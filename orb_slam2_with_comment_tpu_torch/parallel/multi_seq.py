"""Independent sequences over a process group (port of
parallel/multi_seq.py).

B autonomous RGB-D trackers advance one frame per ``process_rgbd(imgs
[B, H, W], depths [B, H, W])``. Rank r of the group owns B / world of the
sequences and advances each with the real per-frame step
(pipeline.auto.AutoStep), one after the other in one host loop; the
sequences' maps are independent, so the steady state has no collective.
The JAX package advances every sequence in one sharded program; here each
sequence keeps its own AutoState, and with it its own torch.Generator,
so sequence i draws exactly what a solo AutoTracker on its frames draws.

The step and the ORB extractor are shared between the sequences: neither
holds state of a sequence after it is built.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..frontend.extractor import OrbExtractor
from ..pipeline import auto as auto_mod
from ..pipeline import auto_loop
from ..pipeline.tracking import TrackerConfig, upload_frame
from ..place import vocabulary as V
from ._group import rank_and_size


def _tree_map(fn, *trees):
    """fn over the leaves of nested NamedTuples (AutoState, MapState,
    FrameObs, FeatureSet, LoopCarry); a plain tuple is a leaf."""
    head = trees[0]
    if isinstance(head, tuple) and hasattr(head, "_fields"):
        return type(head)(*(_tree_map(fn, *(getattr(t, f) for t in trees))
                            for f in head._fields))
    return fn(*trees)


def stack_states(states: list[auto_mod.AutoState]) -> auto_mod.AutoState:
    """B per-sequence AutoStates as one: each tensor stacked into [B, ...];
    each host value (ints, bools, the maintenance window) and each
    sequence's own torch.Generator kept in a list of B. No generator is
    shared between sequences."""
    def leaf(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return list(xs)

    return _tree_map(leaf, *states)


def unstack_state(states: auto_mod.AutoState, i: int) -> auto_mod.AutoState:
    """Sequence i's AutoState out of stack_states' result."""
    return _tree_map(lambda x: x[i], states)


class MultiSeqTracker:
    """B autonomous RGB-D trackers advancing in lockstep.

        mt = MultiSeqTracker(cfg, n_seq=B)           # a world of one
        for imgs, depths in frames:                  # [B, H, W] each
            mt.process_rgbd(imgs, depths)
        outs = mt.finalize()                         # one dict per sequence

    Under torch.distributed every rank builds it with the same arguments
    and is given the whole batch; rank r tracks its block of B / world
    sequences on ``cuda:r`` (``device="cuda"``) or on the CPU, and
    ``finalize`` gathers every sequence's dict on the group's rank 0 (the
    other ranks get None).
    """

    def __init__(self, cfg: TrackerConfig, n_seq: int, group=None,
                 auto_cfg: auto_mod.AutoTrackerConfig | None = None,
                 device="cuda"):
        rank, size = rank_and_size(group)
        if n_seq % size != 0:
            raise ValueError(f"n_seq ({n_seq}) must be a multiple of the "
                             f"group's size ({size})")
        if cfg.map_cfg.n_feat != cfg.n_features:
            raise ValueError("map_cfg.n_feat must equal n_features")
        self.cfg = cfg
        self.n_seq = n_seq
        self.group = group
        self.rank, self.world = rank, size
        self.auto_cfg = auto_cfg or auto_mod.AutoTrackerConfig()
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", rank)
        self.device = dev
        local = n_seq // size
        self.seq_ids = list(range(rank * local, (rank + 1) * local))
        extractor = OrbExtractor(n_features=cfg.n_features)
        voc = None
        if self.auto_cfg.loop_closing:
            voc = V.load_default_vocabulary(dev)
            auto_loop.warm_up_autodiff()
        self.step = auto_mod.build_auto_step(
            extractor, cfg, self.auto_cfg.traj_capacity, voc,
            whole_cycle=self.auto_cfg.whole_cycle)
        self.states = [auto_mod.empty_auto_state(
            cfg, self.auto_cfg.traj_capacity, dev) for _ in self.seq_ids]
        self.frame_count = 0

    def process_rgbd(self, imgs, depths):
        """Advance every sequence of this rank by one frame. imgs [B, H, W]
        uint8, depths [B, H, W] raw (or float metres, as
        AutoTracker.process_rgbd takes them)."""
        for j, i in enumerate(self.seq_ids):
            self.states[j] = self.step(
                self.states[j], upload_frame(imgs[i], self.device),
                upload_frame(depths[i], self.device, depth=True))
        self.frame_count += 1

    def sync(self):
        """Wait for this rank's device to drain; a no-op on the CPU."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _finalize_one(self, s: auto_mod.AutoState) -> dict:
        """One sequence's result, from one readback: its trajectory rings
        and counters bit-cast into one int32 buffer."""
        n, T = self.frame_count, self.auto_cfg.traj_capacity
        order = (np.arange(n) if n <= T else np.arange(n - T, n)) % T
        parts = [s.traj_R.reshape(-1).view(torch.int32),
                 s.traj_t.reshape(-1).view(torch.int32),
                 s.traj_valid.to(torch.int32), s.traj_stats.reshape(-1),
                 s.map.n_kf.reshape(1)]
        host = torch.cat(parts).cpu().numpy()
        cut = np.cumsum([p.numel() for p in parts])[:-1]
        R, t, valid, stats, n_kf = np.split(host, cut)
        return {
            "R": R.view(np.float32).reshape(T, 3, 3)[order],
            "t": t.view(np.float32).reshape(T, 3)[order],
            "valid": valid.astype(bool)[order],
            "stats": stats.reshape(T, -1)[order],
            "lost_at": int(s.lost), "initialized": bool(s.initialized),
            "n_keyframes": int(n_kf[0]), "n_frames": n,
            "n_loops_closed": int(s.loop.n_loops),
        }

    def finalize(self) -> list[dict] | None:
        """Every sequence's trajectory, flags and statistics in frame
        order, one dict per sequence with the JAX package's keys. On more
        than one rank the group's rank 0 gathers them (and the others get
        None)."""
        outs = [self._finalize_one(s) for s in self.states]
        if self.world == 1:
            return outs
        dst = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        parts = [None] * self.world if self.rank == 0 else None
        dist.gather_object(outs, parts, dst=dst, group=self.group)
        if self.rank != 0:
            return None
        return [o for part in parts for o in part]
