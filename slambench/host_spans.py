"""The program's own spans and counted blocking transfers over the traced
frames (``orb_slam2_with_comment_tpu_torch/spans.py``), for the per-layer
readers of ``metrics/``.

The traced stretch runs under torch.profiler, which turns the program's
tracing on, so the program's store then holds the stretch's frames, each
marked as profiled. A program without the store (an older commit) gives
None; a store whose profiled frames are not the trace's frames stops the
run, as ``tracing.check_launches`` does for the kernels' launches.
"""
from __future__ import annotations


def traced_frames(run):
    """(the program's spans module, its profiled frame records), or None
    where the run was not traced or the program has no store."""
    if run.trace is None or run.trace.frames == 0:
        return None
    try:
        from orb_slam2_with_comment_tpu_torch import spans
    except ImportError:
        return None
    frames = [f for f in spans.FRAMES if f.profiled]
    if len(frames) != run.trace.frames:
        raise RuntimeError(
            f"the program's span store holds {len(frames)} profiled frames, "
            f"the trace {run.trace.frames}: its frame span no longer opens "
            f"once a frame")
    return spans, frames


def layer_ms(run, layer: str):
    """The layer's host self time per traced frame, in ms."""
    got = traced_frames(run)
    if got is None:
        return None
    spans, frames = got
    ns = sum(spans.layer_ns(f).get(layer, 0) for f in frames)
    return ns / 1e6 / len(frames)


def transfers_per_frame(run):
    """The program's counted blocking transfers per traced frame."""
    got = traced_frames(run)
    if got is None:
        return None
    _, frames = got
    return sum(sum(f.transfers.values()) for f in frames) / len(frames)
