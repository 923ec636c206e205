"""Plain ORB extraction and stereo depth: the reference the port's front end
is compared with.

A frozen copy of the port's plain versions at commit 41c5463:
``frontend/extractor.py`` (``level_budgets``, ``_level_features``),
``ops/image.py`` (the antialiased pyramid, the 7x7 blur), ``ops/fast.py``,
``ops/orientation.py`` (``ic_angles``), ``ops/brief.py``
(``descriptors_exact``, the pattern ``brief_pattern.npy`` copied byte for
byte), ``ops/orb.py`` (``masked_score``), ``frontend/stereo.py``
(``association_mask``), ``ops/hamming.py`` (``masked_best_two_plain``) and
``ops/sad.py`` (``sad_refine_block``, ``stereo_tail_plain``). It imports
nothing of the port and runs level by level in plain PyTorch.

``dt`` is the precision the images and everything derived from them are
computed in: float32 for the reference, bfloat16 for the control. Keypoint
positions and depths are returned in float32 whatever ``dt``.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

N_LEVELS = 8
SCALE_FACTOR = 1.2
CELL, PER_CELL, MARGIN = 32, 8, 16
TH_HIGH, TH_LOW = 20.0, 7.0
HALF_PATCH = 15
BRIEF_RADIUS = 19
PATTERN = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "brief_pattern.npy")).astype(np.float32)
CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
          (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2),
          (-3, -1))
SAD_W, SAD_L = 5, 5  # Frame.cc:593, :600
TH_ORB = 75  # (TH_HIGH + TH_LOW) / 2 of the matcher, Frame.cc:540
BIG = 10_000


class Features(NamedTuple):
    xy: torch.Tensor  # [N, 2] float32, level-0 pixels (x = col, y = row)
    octave: torch.Tensor  # [N] int32
    angle: torch.Tensor  # [N] radians
    desc: torch.Tensor  # [N, 8] int32, 256 bits
    valid: torch.Tensor  # [N] bool


def level_budgets(n_features: int) -> list[int]:
    factor = 1.0 / SCALE_FACTOR
    first = n_features * (1 - factor) / (1 - factor ** N_LEVELS)
    out = [int(round(first * factor ** i)) for i in range(N_LEVELS - 1)]
    out.append(max(n_features - sum(out), 0))
    return out


def level_scales() -> list[float]:
    return [SCALE_FACTOR ** i for i in range(N_LEVELS)]


# ---- pyramid ----

def resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    inv_scale = float(np.float32(1.0 / (out_size / in_size)))
    inv_kernel_scale = float(np.float32(1.0) / np.float32(max(inv_scale, 1.0)))
    f32 = torch.float32
    half = torch.arange(out_size, dtype=f32, device=device) + 0.5
    sample_f = (half.double() * inv_scale - 0.5).to(f32)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32, device=device)
         [:, None]).abs() * inv_kernel_scale
    weights = (1.0 - x.abs()).clamp(min=0.0)
    total = weights.sum(0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def pyramid(img: torch.Tensor, dt=torch.float32) -> list[torch.Tensor]:
    """8 levels at 1.2x, each resized from the one before by two matrix
    products (rows, then columns) of antialiased triangle weights."""
    h, w = img.shape
    sizes = [(int(round(h / s)), int(round(w / s))) for s in level_scales()]
    pyr = [img.to(torch.float32).to(dt)]
    for lvl in range(1, N_LEVELS):
        prev = pyr[-1]
        wy = resize_weights(prev.shape[0], sizes[lvl][0], img.device).to(dt)
        wx = resize_weights(prev.shape[1], sizes[lvl][1], img.device).to(dt)
        pyr.append((wy.T @ prev) @ wx)
    return pyr


def gaussian_blur(img: torch.Tensor, ksize: int = 7,
                  sigma: float = 2.0) -> torch.Tensor:
    r = ksize // 2
    x = torch.arange(-r, r + 1, dtype=torch.float32)
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    k = (k / k.sum()).tolist()
    h, w = img.shape
    xp = torch.cat([img[:1].expand(r, w), img, img[-1:].expand(r, w)], 0)
    acc = 0.0
    for i in range(ksize):
        acc = acc + k[i] * xp[i:i + h]
    xp = torch.cat([acc[:, :1].expand(h, r), acc, acc[:, -1:].expand(h, r)], 1)
    acc = 0.0
    for i in range(ksize):
        acc = acc + k[i] * xp[:, i:i + w]
    return acc


def shifted(img: torch.Tensor, dy: int, dx: int, pad: int) -> torch.Tensor:
    h, w = img.shape
    p = torch.nn.functional.pad(img, (pad, pad, pad, pad))
    return p[pad + dy:pad + dy + h, pad + dx:pad + dx + w]


# ---- FAST, NMS, selection ----

def sort_top_k(v: torch.Tensor, k: int):
    idx = torch.argsort(-v, dim=-1, stable=True)[..., :k]
    return torch.gather(v, -1, idx), idx


def _min_window9(d: torch.Tensor) -> torch.Tensor:
    m2 = torch.minimum(d, torch.roll(d, -1, 0))
    m4 = torch.minimum(m2, torch.roll(m2, -2, 0))
    m8 = torch.minimum(m4, torch.roll(m4, -4, 0))
    return torch.minimum(m8, torch.roll(d, -8, 0))


def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    ring = torch.stack([shifted(img, dy, dx, 3) for dy, dx in CIRCLE])
    d = ring - img[None]
    bright = _min_window9(d).amax(0)
    dark = _min_window9(-d).amax(0)
    score = torch.maximum(bright, dark).clamp(min=0.0)
    h, w = img.shape
    out = torch.zeros_like(score)
    out[3:h - 3, 3:w - 3] = score[3:h - 3, 3:w - 3]
    return out


def masked_score(img: torch.Tensor, margin: int = MARGIN) -> torch.Tensor:
    h, w = img.shape
    score = fast_score_map(img)
    inner = torch.zeros_like(score)
    inner[margin:h - margin, margin:w - margin] = score[margin:h - margin,
                                                        margin:w - margin]
    return inner


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    neigh = torch.stack([shifted(score, dy, dx, 1)
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                         if dy or dx])
    return torch.where(score > neigh.amax(0), score, 0.0)


def select_keypoints(score: torch.Tensor, n_max: int):
    """(yx [n_max, 2] int32, valid [n_max] bool): per 32 px cell the best 8
    NMS corners above 20 (7 where the cell's best is not above 20), then
    the spatial round-robin top n_max; ties to the lower index."""
    h, w = score.shape
    s = nms3x3(score)
    ph, pw = (-h) % CELL, (-w) % CELL
    s = torch.nn.functional.pad(s, (0, pw, 0, ph))
    cy, cx = (h + ph) // CELL, (w + pw) // CELL
    cells = s.reshape(cy, CELL, cx, CELL).permute(0, 2, 1, 3).reshape(
        cy, cx, CELL * CELL)
    cell_max = cells.amax(-1, keepdim=True)
    th = torch.where(cell_max > TH_HIGH, TH_HIGH, TH_LOW).to(cells.dtype)
    keep = torch.where(cells > th, cells, 0.0)
    top_v, top_i = sort_top_k(keep, PER_CELL)
    dev = score.device
    cyi = torch.arange(cy, device=dev)[:, None, None]
    cxi = torch.arange(cx, device=dev)[None, :, None]
    flat_v = top_v.reshape(-1).to(torch.float32)
    flat_y = (cyi * CELL + top_i // CELL).reshape(-1)
    flat_x = (cxi * CELL + top_i % CELL).reshape(-1)
    rank = torch.arange(PER_CELL, device=dev).expand(cy, cx, PER_CELL)
    sel_key = flat_v - rank.reshape(-1).to(torch.float32) * 1e7
    k = min(n_max, flat_v.shape[0])
    _, gi = sort_top_k(sel_key, k)
    yx = torch.stack([flat_y[gi], flat_x[gi]], -1).to(torch.int32)
    valid = flat_v[gi] > 0.0
    if k < n_max:
        yx = torch.cat([yx, yx.new_zeros(n_max - k, 2)])
        valid = torch.cat([valid, valid.new_zeros(n_max - k)])
    return yx, valid


def subpixel_refine(score: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    h, w = score.shape
    y = yx[:, 0].long()
    x = yx[:, 1].long()

    def at(dy, dx):
        return score[(y + dy).clamp(0, h - 1), (x + dx).clamp(0, w - 1)]

    c = at(0, 0)
    up, dn, lf, rt = at(-1, 0), at(1, 0), at(0, -1), at(0, 1)
    den_y = up - 2 * c + dn
    den_x = lf - 2 * c + rt
    dy = 0.5 * (up - dn) / torch.where(den_y.abs() < 1e-6, 1e-6, den_y)
    dx = 0.5 * (lf - rt) / torch.where(den_x.abs() < 1e-6, 1e-6, den_x)
    return torch.stack([dy.clamp(-0.5, 0.5), dx.clamp(-0.5, 0.5)], -1)


# ---- orientation and BRIEF ----

def _umax_table() -> np.ndarray:
    umax = np.zeros(HALF_PATCH + 1, np.int32)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    hp2 = HALF_PATCH * HALF_PATCH
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


UMAX = _umax_table()


def _moment_matrix() -> np.ndarray:
    size = 2 * HALF_PATCH + 1
    k10 = np.zeros((size, size), np.float32)
    k01 = np.zeros((size, size), np.float32)
    for v in range(-HALF_PATCH, HALF_PATCH + 1):
        half = UMAX[abs(v)]
        for u in range(-half, half + 1):
            k10[v + HALF_PATCH, u + HALF_PATCH] = u
            k01[v + HALF_PATCH, u + HALF_PATCH] = v
    return np.stack([k10.reshape(-1), k01.reshape(-1)], 1)


KMAT = _moment_matrix()


def ic_angles(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    d = torch.arange(-HALF_PATCH, HALF_PATCH + 1, device=img.device)
    rows = (yx[:, 0:1].long() + d).clamp(0, h - 1)
    cols = (yx[:, 1:2].long() + d).clamp(0, w - 1)
    patches = img[rows[:, :, None], cols[:, None, :]]
    kmat = torch.as_tensor(KMAT, device=img.device).to(img.dtype)
    mom = patches.reshape(patches.shape[0], -1) @ kmat
    return torch.atan2(mom[:, 1], mom[:, 0])


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.reshape(-1, 8, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def descriptors(blurred: torch.Tensor, yx: torch.Tensor,
                angle: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF at the exact angle: each pattern point rotated and
    rounded half to even, read clamped to the image edge."""
    h, w = blurred.shape
    pat = torch.as_tensor(PATTERN, device=blurred.device)
    y0 = yx[:, 0:1].long()
    x0 = yx[:, 1:2].long()
    ca = torch.cos(angle.to(torch.float32))[:, None]
    sa = torch.sin(angle.to(torch.float32))[:, None]

    def sample(px, py):
        r = torch.round(px[None, :] * sa + py[None, :] * ca).long().clamp(
            -BRIEF_RADIUS, BRIEF_RADIUS)
        c = torch.round(px[None, :] * ca - py[None, :] * sa).long().clamp(
            -BRIEF_RADIUS, BRIEF_RADIUS)
        return blurred[(y0 + r).clamp(0, h - 1), (x0 + c).clamp(0, w - 1)]

    return pack_bits(sample(pat[:, 0], pat[:, 1])
                     < sample(pat[:, 2], pat[:, 3]))


def extract(img: torch.Tensor, n_features: int,
            dt=torch.float32) -> tuple[Features, list]:
    """(features, pyramid) of one uint8 image [H, W], in the port's slot
    layout: each level's budget of slots, level after level."""
    pyr = pyramid(img, dt)
    parts = []
    for lvl, (budget, scale) in enumerate(zip(level_budgets(n_features),
                                              level_scales())):
        if budget == 0:
            continue
        lvl_img = pyr[lvl]
        score = masked_score(lvl_img)
        yx, valid = select_keypoints(score, budget)
        blurred = torch.round(gaussian_blur(lvl_img))
        ang = ic_angles(lvl_img, yx)
        desc = descriptors(blurred, yx, ang)
        sub = subpixel_refine(score, yx).to(torch.float32)
        xy = torch.stack([(yx[:, 1].float() + sub[:, 1]) * scale,
                          (yx[:, 0].float() + sub[:, 0]) * scale], -1)
        octv = torch.full((budget,), lvl, dtype=torch.int32, device=img.device)
        parts.append((xy, octv, ang.to(torch.float32), desc, valid))
    return Features(*(torch.cat(p) for p in zip(*parts))), pyr


# ---- stereo ----

def _f32(x: float) -> float:
    return float(np.float32(x))


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def best_match(dq: torch.Tensor, dt_: torch.Tensor, mask: torch.Tensor):
    """(best distance, first column of it), each [Q] int32, of the masked
    Hamming distances; a masked pair counts as BIG."""
    rows = max(1, (1 << 22) // max(8 * dt_.shape[0], 1))
    d = torch.cat([_popcount32(dq[i:i + rows, None, :] ^ dt_[None]).sum(
        -1, dtype=torch.int32) for i in range(0, dq.shape[0], rows)])
    d = torch.where(mask, d, BIG)
    idx = torch.argmin(d, dim=1)
    return d.gather(1, idx[:, None])[:, 0].to(torch.int32), idx.to(torch.int32)


def _sad_level(pyr_l, pyr_r, inv_scale: float, xy_l, u_r0):
    """(refined right u in level pixels, best SAD, ok) of one level."""
    W, L = SAD_W, SAD_L
    patch, span = 2 * W + 1, 2 * W + 2 * L + 1
    h, w = pyr_l.shape
    inv = _f32(inv_scale)
    ur0 = torch.round(u_r0 * inv)
    yi = torch.round(xy_l[:, 1] * inv).to(torch.int64)
    xi = torch.round(xy_l[:, 0] * inv).to(torch.int64)
    uri = ur0.to(torch.int64)
    yc = (yi - W).clamp(0, h - patch) + W
    xc = (xi - W).clamp(0, w - patch) + W
    off = torch.arange(-W, W + 1, device=pyr_l.device)
    rows = (yc[:, None] + off[None, :]).clamp(0, h - 1)[:, :, None]
    cols_l = (xc[:, None] + off[None, :]).clamp(0, w - 1)
    p_l = pyr_l[rows, cols_l[:, None, :]]
    p_l = p_l - p_l[:, W:W + 1, W:W + 1]
    x0 = uri - W - L
    inb = (x0 >= 0) & (x0 + span <= w)
    x0c = x0.clamp(0, w - span)
    cols = (x0c[:, None] + torch.arange(span, device=pyr_l.device)[None, :]
            ).clamp(0, w - 1)
    strip = pyr_r[rows, cols[:, None, :]]
    win = strip.unfold(2, patch, 1)
    win = win - win[:, W:W + 1, :, W:W + 1]
    diff = (p_l[:, :, None, :] - win).abs()
    row = diff[..., 0]
    for c in range(1, patch):
        row = row + diff[..., c]
    sad = row[:, 0]
    for r in range(1, patch):
        sad = sad + row[:, r]
    sad = sad.to(torch.float32)
    best = torch.argmin(sad, dim=1)
    edge = (best == 0) | (best == 2 * L)
    b = best.clamp(1, 2 * L - 1)

    def take(i):
        return sad.gather(1, i[:, None])[:, 0]

    d1, d2, d3 = take(b - 1), take(b), take(b + 1)
    denom = d1 + d3 - 2.0 * d2
    delta = torch.where(denom > 0,
                        (d1 - d3) / (2.0 * denom.clamp(min=1e-9)), 2.0)
    ok = inb & ~edge & (delta.abs() <= 1.0)
    inc = (b.to(torch.float32) - L) + delta
    return ur0 + inc, take(best), ok


def stereo_depth(left: Features, right: Features, pyr_l, pyr_r,
                 n_features: int, bf: float, fx: float):
    """(right u, depth), each [N] float32, -1 where a left keypoint has no
    match (Frame::ComputeStereoMatches): the best right keypoint in the row
    band, the octave band and the disparity range, the 11x11 SAD over +-5
    shifts with a parabola, the disparity gates and the median-SAD sweep."""
    bf, fx = _f32(bf), _f32(fx)
    sc = torch.tensor(level_scales(), dtype=torch.float32,
                      device=left.xy.device)
    ul, vl = left.xy[:, 0][:, None], left.xy[:, 1][:, None]
    ur, vr = right.xy[None, :, 0], right.xy[None, :, 1]
    mask = (left.valid[:, None] & right.valid[None, :]
            & ((vr - vl).abs() <= 2.0 * sc[right.octave.long()][None, :])
            & (right.octave[None, :] >= left.octave[:, None] - 1)
            & (right.octave[None, :] <= left.octave[:, None] + 1)
            & (ur >= ul - fx) & (ur <= ul))
    best_d, best_j = best_match(left.desc, right.desc, mask)
    u_r0 = right.xy[best_j.long(), 0]
    u_right, sad_best, ok = [], [], []
    slot = 0
    for lvl, (budget, scale) in enumerate(zip(level_budgets(n_features),
                                              level_scales())):
        if budget == 0:
            continue
        sl = slice(slot, slot + budget)
        u, s, o = _sad_level(pyr_l[lvl], pyr_r[lvl], 1.0 / scale,
                             left.xy[sl], u_r0[sl])
        u_right.append(u * _f32(scale))
        sad_best.append(s)
        ok.append(o)
        slot += budget
    u_right, sad_best, ok = (torch.cat(a) for a in (u_right, sad_best, ok))
    n = u_right.shape[0]
    x_l = left.xy[:, 0]
    good = (best_d < TH_ORB) & ok
    disparity = x_l - u_right
    tiny = disparity <= 0
    disparity = torch.where(tiny, 0.01, disparity)
    u_right = torch.where(tiny, x_l - 0.01, u_right)
    good = good & (disparity < fx)
    sad_sorted = torch.sort(torch.where(good, sad_best, float("inf"))).values
    med = sad_sorted[(good.sum() // 2).clamp(0, n - 1)]
    good = good & (sad_best <= 1.5 * 1.4 * med)
    depth = torch.div(torch.tensor(bf, dtype=torch.float32), disparity)
    return (torch.where(good, u_right, -1.0), torch.where(good, depth, -1.0))
