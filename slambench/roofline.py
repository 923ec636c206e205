"""Peaks of the card and the least time the problems of the front end need.

The bounds count the work each problem needs at the configuration's
shapes, not what one kernel's code does, so that a later kernel for the
same problem is judged against the same work: each input byte read once,
each output byte written once, and the algorithm's float32 operations,
against NVIDIA's published peaks of one H100 SXM (3.35 TB/s of HBM, 67
TFLOP/s of float32 outside the tensor cores, at its 700 W limit; the run
prints the card's own limit beside them). Adapted from ``chip_smoke.py``'s
``bound_of``, ``bound_orb`` and ``bound_sad`` at commit 41c5463.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# ORB, per scored pixel: the 16 ring differences, for each sign the
# 9-contiguous minimum of the ring by doubling (16 x 4 minima) and the
# largest of the 16 (15), then the larger sign and the clamp
FAST_OPS = 16 + 2 * (16 * 4 + 15) + 2
# per level pixel: the 3x3 NMS (8 maxima, one comparison) and the
# separable 7x7 blur (7 multiply-adds a pass, two passes) and its rounding
PIXEL_OPS = 8 + 1 + 2 * 7 * 2 + 1
# per keypoint: the IC moments (two multiply-adds per pixel of the
# radius-15 disc, 709 pixels), the angle (about 20), BRIEF (512 rotated
# points at 4 multiplies, 2 adds and 2 roundings, 256 comparisons) and the
# subpixel parabolas (about 20)
DISC_PIXELS = 709
KEY_OPS = 4 * DISC_PIXELS + 20 + 512 * 8 + 256 + 20
# bytes written per keypoint: xy, response, octave, angle, the 32-byte
# descriptor and the valid flag
KEY_OUT_BYTES = 8 + 4 + 4 + 4 + 32 + 1

# SAD, per keypoint (Frame.cc:586-643): at each of 11 shifts, 121 window
# pixels each less its window's centre on both sides, the difference, its
# absolute value and the sum (5 a pixel); the parabola and the gates about
# 20, the depth and the median sweep about 20
SAD_OPS = 11 * 121 * 5 + 20 + 20
# bytes per keypoint: the 11x11 left window and the 11x21 right strip as
# float32, the left xy, the match's distance, index and right u, and u_r
# and depth written
SAD_BYTES = 4 * (121 + 231) + 8 + 4 + 4 + 4 + 8


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds: the larger of the bytes over the memory rate and
    the operations over the float32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def level_sizes(height: int, width: int, n_levels: int = 8,
                scale: float = 1.2) -> list:
    return [(int(round(height / scale ** i)), int(round(width / scale ** i)))
            for i in range(n_levels)]


def orb_view_s(height: int, width: int, n_features: int,
               margin: int = 16) -> float:
    """One view's ORB extraction: every pyramid level read once as
    float32, every keypoint written once."""
    sizes = level_sizes(height, width)
    px = sum(h * w for h, w in sizes)
    scored = sum(max(h - 2 * margin, 0) * max(w - 2 * margin, 0)
                 for h, w in sizes)
    return bound_s(4 * px + KEY_OUT_BYTES * n_features,
                   FAST_OPS * scored + PIXEL_OPS * px + KEY_OPS * n_features)


def sad_pair_s(n_keypoints: int) -> float:
    """One stereo pair's refinement, depth and median sweep over
    ``n_keypoints`` left keypoints."""
    return bound_s(SAD_BYTES * n_keypoints, SAD_OPS * n_keypoints)
