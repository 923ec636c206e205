"""Spans and counted blocking transfers inside the tracker, kept in memory.

A span is a named stretch of the host's work: its start and end on the
host clock (``time.perf_counter_ns``), its parent and the frame it belongs
to. The root span, ``frame``, opens in ``AutoTracker.process_rgbd``,
``process_stereo`` and ``process_mono``, so every span of one frame shares
the root's frame index. Each frame's record (``FrameRecord``) holds its
spans in the order they opened, root first, and its blocking transfers by
site.

Tracing is on while a ``torch.profiler`` records, or after ``enable()``
(until ``disable()``); whether it is on is decided as each frame starts.
Each time it turns on, the store (``FRAMES``) is cleared; it keeps its
frames after tracing turns off. While a profiler records, each span is
also a ``torch.profiler.record_function`` range, so a profiler trace shows
the spans on the device trace's clock. With tracing off, a span costs one
flag check: nothing is recorded, allocated or entered.

The tracker's blocking transfers go through ``to_host`` (a device tensor
read on the host: what ``int()``, ``float()``, ``bool()`` or ``.tolist()``
read), ``to_device`` (a host value copied from pageable memory into a new
tensor) and ``put`` (into an element of one), each under a stable site
name such as ``do_track.stats``. While tracing is on,
each call is counted on its frame, whatever the device (so a CPU run
counts the sites at which the card blocks), and the transfer is exempt
from torch.cuda's sync debug mode, so that the mode flags every other
synchronizing call. A copy that does not block (the pinned, non-blocking
frame upload) is not counted.

The map's table-wide passes (the local landmark mask over every landmark,
the covisibility weights and matrix, the BoW scores and the BoW table's
clone, the compactions) count the bytes they read through ``table_read``
under a site name, on the host from the tensors' shapes: no readback and
no device operation. A frame's record keeps them by site
(``table_bytes``).

``LAYERS`` maps span names to the benchmark's layers: a span belongs to
the layer of its nearest ancestor-or-self that the table names, and
anything unnamed under ``frame`` to the tracker's host loop. A span's self
time is its duration minus the part its children cover, so the layers'
self times partition each frame's host time exactly (``layer_ns``).
"""
from __future__ import annotations

import functools
import time

import torch
from torch.autograd import profiler as _profiler

HOST_LOOP = "tracker host loop"
MAINTENANCE_PHASES = ("ph_fuse_in", "ph_triangulate", "ph_fuse_out",
                      "ph_merge", "ph_refresh_cull", "ph_ba1", "ph_ba2",
                      "ph_loop")
LAYERS = {"frame": HOST_LOOP,
          "frontend": "front end",
          "stereo.match": "stereo front end",
          "_match_motion_model": "matching",
          "_match_reference_kf": "matching",
          "track_local_map": "matching",
          "_pose_optimize_from_matches": "pose",
          "_insert": "maintenance",
          **{p: "maintenance" for p in MAINTENANCE_PHASES}}


class SpanRecord:
    """One span: host clock in ns; ``parent`` is the position of the
    parent in its frame's ``spans`` (-1 for the root)."""
    __slots__ = ("name", "start", "end", "parent", "frame")

    def __init__(self, name: str, start: int, parent: int, frame: int):
        self.name, self.start, self.end = name, start, start
        self.parent, self.frame = parent, frame

    @property
    def duration_ns(self) -> int:
        return self.end - self.start


class FrameRecord:
    """One traced frame: its index, its spans (root first, in the order
    they opened), its blocking transfers by site, the bytes its table-wide
    passes read by site, and whether a profiler recorded it."""
    __slots__ = ("index", "spans", "transfers", "table_bytes", "profiled")

    def __init__(self, index: int, profiled: bool):
        self.index, self.profiled = index, profiled
        self.spans: list[SpanRecord] = []
        self.transfers: dict[str, int] = {}
        self.table_bytes: dict[str, int] = {}

    @property
    def duration_ns(self) -> int:
        return self.spans[0].duration_ns


FRAMES: list[FrameRecord] = []
_enabled = False  # the operator's switch
_was_on = False  # whether tracing was on at the last frame's start
_on = False  # inside a traced frame
_frame: FrameRecord | None = None
_open: list = []  # (position in the frame's spans, record_function or None)


def enable() -> None:
    """Turn tracing on (clearing the store) until ``disable()``."""
    global _enabled, _was_on
    _enabled = _was_on = True
    FRAMES.clear()


def disable() -> None:
    """Turn the operator's switch off; a recording profiler still traces.
    The store keeps its frames."""
    global _enabled, _was_on
    _enabled = False
    _was_on = _profiler._is_profiler_enabled


def _push(name: str) -> None:
    f = _frame
    rf = None
    if f.profiled:
        rf = _profiler.record_function(name)
        rf.__enter__()
    parent = _open[-1][0] if _open else -1
    _open.append((len(f.spans), rf))
    f.spans.append(SpanRecord(name, time.perf_counter_ns(), parent, f.index))


def _pop() -> None:
    pos, rf = _open.pop()
    _frame.spans[pos].end = time.perf_counter_ns()
    if rf is not None:
        rf.__exit__(None, None, None)


class span:
    """A named span: ``with span(name):`` or ``@span(name)``. Make one per
    boundary, at import, and reuse it."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _on:
            _push(self.name)
        return self

    def __exit__(self, *exc) -> None:
        if _on:
            _pop()

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            _push(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _pop()
        return traced


class _Root:
    """The root span of one frame (``frame(index)``): decides whether
    tracing is on for the frame, and opens its record."""
    __slots__ = ("index",)

    def __call__(self, index: int) -> "_Root":
        self.index = index
        return self

    def __enter__(self):
        global _on, _was_on, _frame
        profiled = _profiler._is_profiler_enabled
        on = _enabled or profiled
        if on and not _was_on:
            FRAMES.clear()
        _was_on = on
        if on:
            _frame = FrameRecord(self.index, profiled)
            FRAMES.append(_frame)
            _on = True
            _open.clear()
            _push("frame")
        return self

    def __exit__(self, *exc) -> None:
        global _on, _frame
        if _on:
            while _open:
                _pop()
            _on, _frame = False, None


frame = _Root()


def _count(site: str) -> None:
    t = _frame.transfers
    t[site] = t.get(site, 0) + 1


def _exempt(fn):
    """fn() with torch.cuda's sync debug mode lifted."""
    mode = torch.cuda.get_sync_debug_mode()
    if not mode:
        return fn()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def to_host(site: str, t: torch.Tensor):
    """``t.item()`` for a 0-dim tensor (the value ``int()``, ``float()`` or
    ``bool()`` of it reads), else ``t.tolist()``; counted at ``site`` while
    tracing is on."""
    read = t.item if t.dim() == 0 else t.tolist
    if not _on:
        return read()
    _count(site)
    if t.is_cuda:
        return _exempt(read)
    return read()


def to_device(site: str, data, dtype=None, device=None) -> torch.Tensor:
    """``torch.as_tensor(data, dtype=dtype, device=device)`` for host data
    (a number, a list or a numpy array): a copy from pageable memory,
    counted at ``site`` while tracing is on."""
    if not _on:
        return torch.as_tensor(data, dtype=dtype, device=device)
    _count(site)
    if device is not None and torch.device(device).type == "cuda":
        return _exempt(lambda: torch.as_tensor(data, dtype=dtype,
                                               device=device))
    return torch.as_tensor(data, dtype=dtype, device=device)


def put(site: str, dst: torch.Tensor, index, value) -> None:
    """``dst[index] = value`` for a host value (a number): a copy from
    pageable memory into ``dst``, counted at ``site`` while tracing is
    on."""
    if not _on:
        dst[index] = value
        return
    _count(site)
    if dst.is_cuda:
        _exempt(lambda: dst.__setitem__(index, value))
    else:
        dst[index] = value


def table_read(site: str, *tensors: torch.Tensor) -> None:
    """Count the bytes of ``tensors``, what a table-wide pass reads, at
    ``site`` while tracing is on: their sizes from their shapes, on the
    host."""
    if not _on:
        return
    t = _frame.table_bytes
    t[site] = t.get(site, 0) + sum(x.numel() * x.element_size()
                                   for x in tensors)


def layers_of(rec: FrameRecord) -> list[str]:
    """The layer of each of the frame's spans: its nearest ancestor-or-self
    that LAYERS names, else the host loop."""
    out: list[str] = []
    for s in rec.spans:
        named = LAYERS.get(s.name)
        out.append(named if named is not None
                   else out[s.parent] if s.parent >= 0 else HOST_LOOP)
    return out


def self_ns(rec: FrameRecord) -> list[int]:
    """Each span's duration minus its children's durations, in ns."""
    out = [s.duration_ns for s in rec.spans]
    for s in rec.spans:
        if s.parent >= 0:
            out[s.parent] -= s.duration_ns
    return out


def layer_ns(rec: FrameRecord) -> dict[str, int]:
    """The frame's host time by layer (self times summed), in ns: the
    values sum to the root's duration."""
    out: dict[str, int] = {}
    for layer, ns in zip(layers_of(rec), self_ns(rec)):
        out[layer] = out.get(layer, 0) + ns
    return out
