"""The traced stretch: spans around the tracker's layers, a torch.profiler
trace of a few frames after the window, and what the metrics read from it.

The spans are ``record_function`` ranges the harness puts round the
program's calls from outside (``wrap_layers``): the front end, ``do_track``,
``_insert``, each maintenance phase and ``do_relocalize``; the program is
not edited. The trace is exported as Chrome JSON into a temporary folder
(under ``TMPDIR``), read, and deleted.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

import torch

FRAME_SPAN = "slambench.frame"
STRETCH_SPAN = "slambench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the runtime calls that block the host until the device has caught up
WAIT_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D")
# kernel families by the names csrc/*.cu gives their kernels
KERNELS = {"hamming": ("masked_best_two_kernel", "distance_matrix_kernel"),
           "orb": ("orb_cells", "orb_select_kernel", "orb_describe_kernel"),
           "pose_lm": ("pose_lm_kernel",),
           "ba": ("ba_kernel",),
           "stereo_sad": ("stereo_depth_kernel",)}


def _span(name: str, fn):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


# the tracking core's stages, by their names in pipeline/steps.py, which
# calls them through its module's globals
TRACK_STAGES = ("track_frame_core", "_match_motion_model",
                "_match_reference_kf", "_pose_optimize_from_matches",
                "local_landmark_mask", "track_local_map")


@contextlib.contextmanager
def wrap_layers(tracker, steps_module):
    """Spans round the tracker's layers while the block runs: the front
    end (``steps.extract_rgbd_features`` or the extractor's ``stereo``),
    ``do_track`` and the tracking core's stages (``TRACK_STAGES``),
    ``_insert``, each maintenance phase and ``do_relocalize``."""
    step = tracker._step
    saved_phases = list(step.maint_phases)
    saved = {n: getattr(steps_module, n)
             for n in ("extract_rgbd_features",) + TRACK_STAGES}
    step.maint_phases = [_span(p.__name__, p) for p in saved_phases]
    for name in ("do_track", "_insert", "do_relocalize"):
        setattr(step, name, _span(name, getattr(step, name)))
    for name, fn in saved.items():
        setattr(steps_module, name, _span(
            "frontend" if name == "extract_rgbd_features" else name, fn))
    ext = step.extractor
    ext.stereo = _span("frontend", ext.stereo)
    try:
        yield
    finally:
        step.maint_phases = saved_phases
        for name in ("do_track", "_insert", "do_relocalize"):
            step.__dict__.pop(name, None)
        ext.__dict__.pop("stereo", None)
        for name, fn in saved.items():
            setattr(steps_module, name, fn)


@contextlib.contextmanager
def count_sad_keypoints(sad_module, kept: list):
    """While the block runs, keep K5's association distances, one tensor a
    pair (``sad.stereo_depth``'s ``best_d``), for ``sad_keypoints``: K5
    refines the left keypoints whose distance is under TH_ORB. Nothing is
    read back or launched inside the block."""
    inner = sad_module.stereo_depth

    def kept_depth(flat_l, flat_r, levels, xy_l, xy_r, best_d, *args,
                   **kwargs):
        kept.append(best_d)
        return inner(flat_l, flat_r, levels, xy_l, xy_r, best_d, *args,
                     **kwargs)

    sad_module.stereo_depth = kept_depth
    try:
        yield
    finally:
        sad_module.stereo_depth = inner


def sad_keypoints(kept: list, th: int) -> int:
    """The keypoints K5 refined over the pairs kept."""
    return sum(int((d < th).sum()) for d in kept)


def check_launches(trace: "Trace", counted: dict) -> None:
    """Each kernel family's launches in the trace against the program's
    own launch counters over the traced frames: a kernel renamed, or a
    family's kernels missing from the trace, would read as no device time,
    so it stops the run."""
    for fam in KERNELS:
        got = trace.kernel_launches.get(fam, 0)
        if got != counted.get(fam, 0):
            raise RuntimeError(
                f"the trace holds {got} {fam} kernels, the program counted "
                f"{counted.get(fam, 0)} launches: KERNELS in "
                f"slambench/tracing.py no longer names them")


@dataclass
class Trace:
    """What the metrics read from one traced stretch."""
    frames: int
    window_s: float
    busy_s: float
    device_ops: int
    host_waits: int
    kernel_s: dict  # family -> device seconds
    kernel_launches: dict  # family -> launches
    top_ops: list = field(default_factory=list)
    idle_by_span: list = field(default_factory=list)
    sad_keypoints: int = 0  # keypoints K5 refined in the traced frames


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _family(name: str):
    for fam, keys in KERNELS.items():
        if any(k in name for k in keys):
            return fam
    return None


def _short(name: str) -> str:
    name = name.removeprefix("void ")
    return name[:96]


def summarize(events: list, frames: int) -> Trace:
    """Reduce a Chrome trace's events (microseconds) to a Trace."""
    xs = [e for e in events if e.get("ph") == "X"]
    stretch = [e for e in xs if e.get("name") == STRETCH_SPAN
               and e.get("cat") == "user_annotation"]
    if not stretch:
        raise ValueError("the trace holds no stretch span")
    t0 = stretch[0]["ts"]
    t1 = t0 + stretch[0]["dur"]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and t0 <= e["ts"] <= t1]
    busy = _merge([(e["ts"], min(e["ts"] + e["dur"], t1)) for e in dev])
    kernel_s = defaultdict(float)
    kernel_n = defaultdict(int)
    by_name = defaultdict(float)
    for e in dev:
        nm = _short(e["name"])
        by_name[nm] += e["dur"] * 1e-6
        fam = _family(e["name"]) if e.get("cat") == "kernel" else None
        if fam:
            kernel_s[fam] += e["dur"] * 1e-6
            kernel_n[fam] += 1
    frame_spans = [(e["ts"], e["ts"] + e["dur"]) for e in xs
                   if e.get("name") == FRAME_SPAN
                   and e.get("cat") == "user_annotation"]
    waits = sum(1 for e in xs if e.get("cat") in ("cuda_runtime",
                                                  "cuda_driver")
                and e.get("name") in WAIT_CALLS
                and any(a <= e["ts"] <= b for a, b in frame_spans))
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
                    if e.get("cat") == "user_annotation"
                    and e.get("name") != STRETCH_SPAN),
                   key=lambda s: s[0])
    # each idle gap goes to the innermost span the host was in at its
    # middle: a sweep over the (nested) spans in time order
    idle = defaultdict(float)
    edges = [(t0, t0)] + [tuple(b) for b in busy] + [(t1, t1)]
    stack, j = [], 0
    for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while j < len(spans) and spans[j][0] <= mid:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        idle[stack[-1][2] if stack else "outside"] += (b - a) * 1e-6
    return Trace(
        frames=frames, window_s=(t1 - t0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6, device_ops=len(dev),
        host_waits=waits, kernel_s=dict(kernel_s),
        kernel_launches=dict(kernel_n),
        top_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        idle_by_span=sorted(idle.items(), key=lambda kv: -kv[1])[:10])


def profile(feed, first: int, n: int, sync) -> Trace:
    """Trace frames ``first`` .. ``first + n - 1`` fed by ``feed(i)``, then
    ``sync()``, under torch.profiler (CPU and CUDA)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(STRETCH_SPAN):
            for i in range(first, first + n):
                with torch.profiler.record_function(FRAME_SPAN):
                    feed(i)
            sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return summarize(events, n)
