"""95th percentile of the window's frame intervals (ms): the gaps between
the CUDA events recorded after each frame, over every frame of the window."""
from slambench import window


def read(run):
    if run.frames == 0:
        return None
    return window.p95(run.intervals_ms)
