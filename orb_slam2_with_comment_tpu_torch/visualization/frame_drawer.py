"""Current-frame overlay rendering (the reference's FrameDrawer; a copy
of the JAX package's visualization/frame_drawer.py, which is numpy only).

Rebuild of FrameDrawer::DrawFrame (reference: src/FrameDrawer.cc:38-130):
tracked map points get green boxes, visual-odometry-only points blue,
plus a status text bar. Output is a plain uint8 RGB array (savable with
dataio.png.write_png) instead of a Pangolin/OpenCV window: the headless
counterpart of the reference's GUI overlay.
"""
from __future__ import annotations

import numpy as np

GREEN = (60, 220, 60)
BLUE = (80, 120, 255)
RED = (230, 70, 70)


def _box(img: np.ndarray, x: int, y: int, r: int, color):
    h, w = img.shape[:2]
    x0, x1 = max(x - r, 0), min(x + r, w - 1)
    y0, y1 = max(y - r, 0), min(y + r, h - 1)
    img[y0, x0:x1 + 1] = color
    img[y1, x0:x1 + 1] = color
    img[y0:y1 + 1, x0] = color
    img[y0:y1 + 1, x1] = color


def draw_frame(img: np.ndarray, xy: np.ndarray, lm: np.ndarray,
               valid: np.ndarray, state: str = "OK",
               n_kf: int = 0, n_lm: int = 0) -> np.ndarray:
    """Render the tracking overlay.

    img: grayscale [H, W]; xy: [N, 2] keypoints; lm: [N] matched landmark
    id or -1; valid: [N] detector mask. Returns uint8 RGB [H+20, W, 3]
    with a status bar appended (reference: DrawTextInfo).
    """
    g = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    h, w = g.shape
    out = np.repeat(g[:, :, None], 3, axis=2)
    xy = np.asarray(xy)
    lm = np.asarray(lm)
    valid = np.asarray(valid)
    n_tracked = 0
    for i in range(xy.shape[0]):
        if not valid[i]:
            continue
        x, y = int(round(xy[i, 0])), int(round(xy[i, 1]))
        if not (0 <= x < w and 0 <= y < h):
            continue
        if lm[i] >= 0:
            _box(out, x, y, 3, GREEN)
            n_tracked += 1
        else:
            _box(out, x, y, 1, BLUE)
    bar = np.full((20, w, 3), 30, np.uint8)
    out = np.concatenate([out, bar], axis=0)
    _render_text(out, 4, h + 5,
                 f"{state} | KFs: {n_kf} MPs: {n_lm} Matches: {n_tracked}")
    return out


_FONT = {  # minimal 3x5 glyphs for the status bar
    "0": "111101101101111", "1": "010110010010111", "2": "111001111100111",
    "3": "111001111001111", "4": "101101111001001", "5": "111100111001111",
    "6": "111100111101111", "7": "111001010010010", "8": "111101111101111",
    "9": "111101111001111", "K": "101110100110101", "F": "111100110100100",
    "M": "101111111101101", "P": "111101111100100", "O": "111101101101111",
    "L": "100100100100111", "S": "011100010001110", "T": "111010010010010",
    "a": "000011101101011", "t": "010111010010001", "c": "000011100100011",
    "h": "100100111101101", "e": "011101110100011", "s": "000011110001110",
    ":": "000010000010000", " ": "000000000000000", "|": "010010010010010",
    "N": "101111111111101", "I": "111010010010111", "D": "110101101101110",
    "Z": "111001010100111", "E": "111100110100111", "R": "110101110101101",
    "d": "001001011101011", "n": "000110101101101", "i": "010000010010010",
}


def _render_text(img: np.ndarray, x: int, y: int, text: str):
    for ch in text:
        glyph = _FONT.get(ch)
        if glyph is not None:
            for k, bit in enumerate(glyph):
                if bit == "1":
                    yy, xx = y + k // 3, x + k % 3
                    if 0 <= yy < img.shape[0] and 0 <= xx < img.shape[1]:
                        img[yy, xx] = (235, 235, 235)
        x += 4
