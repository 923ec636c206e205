"""The measured window's arithmetic.

A window is a start stamp, one stamp after each frame and an end stamp
after the tracker has drained, all in milliseconds on one clock (CUDA
events on the card). The rate is every frame over the whole window; the
frame intervals are the gaps between consecutive stamps, the first from
the start stamp.
"""
from __future__ import annotations

import numpy as np


def frames_per_s(n_frames: int, window_ms: float) -> float:
    """All frames over all of the window's time."""
    if n_frames <= 0 or window_ms <= 0:
        raise ValueError("a window needs frames and time")
    return 1000.0 * n_frames / window_ms


def intervals_ms(start_ms: float, frame_ms) -> np.ndarray:
    """Each frame's interval: its stamp minus the one before it."""
    stamps = np.concatenate([[start_ms], np.asarray(frame_ms, np.float64)])
    return np.diff(stamps)


def p95(values) -> float:
    """The 95th percentile by linear interpolation (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), 95))
