"""PNG decode and encode on the standard library's zlib and numpy.

The dataset readers decode their frames here, with no imaging package:
the machine that runs the port need not have one. ``read_png`` reads what
TUM RGB-D, KITTI odometry and EuRoC MAV ship (8-bit gray, gray + alpha,
RGB, RGBA and palette images, 16-bit big-endian gray), with all five row
filters; an interlaced image, a bit depth below 8 or 16-bit color raise
``ValueError``. ``write_png`` writes 8-bit and 16-bit gray, filter 0.

Unfiltering: None, Sub and Up are vectorized (Sub is a running sum along
the row, a run of Up rows a running sum down the columns). Average and
Paeth read the decoded left neighbour, so a row cannot be vectorized
along itself; an image with either is decoded along its anti-diagonals
instead (pixel (y, x) on diagonal x + y needs only diagonals x + y - 1
and x + y - 2), one vectorized step over all rows per diagonal:
width + height steps a frame.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # by color type


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRC checked, up to IEND."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG without IEND")


def read_shape(path: str) -> tuple[int, int]:
    """(height, width) from the IHDR chunk alone."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def _unfilter_rows(ftype: np.ndarray, data: np.ndarray,
                   bpp: int) -> np.ndarray:
    """None, Sub and Up rows, vectorized."""
    h, stride = data.shape
    out = data.copy()
    sub = np.nonzero(ftype == 1)[0]
    if len(sub):
        out[sub] = np.cumsum(data[sub].reshape(len(sub), -1, bpp), axis=1,
                             dtype=np.uint8).reshape(len(sub), stride)
    up = ftype == 2
    y = 0
    while y < h:
        if not up[y]:
            y += 1
            continue
        end = y
        while end < h and up[end]:
            end += 1
        run = np.cumsum(data[y:end], axis=0, dtype=np.uint8)
        out[y:end] = run + out[y - 1] if y else run
        y = end
    return out


def _unfilter_diagonals(ftype: np.ndarray, data: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Any mix of the five filters, along the anti-diagonals. In the skewed
    table S[k + 1, y + 1] = pixel (y, k - y) (zero outside the image), the
    left neighbour of pixel (y, x) on diagonal k is S[k, y + 1], the one
    above S[k, y] and the one above-left S[k - 1, y]: contiguous slices."""
    h, stride = data.shape
    w = stride // bpp
    ys, xs = np.divmod(np.arange(h * w), w)
    raw = np.zeros((w + h, h, bpp), np.int16)
    raw[ys + xs, ys] = data.reshape(h * w, bpp)
    S = np.zeros((w + h + 1, h + 1, bpp), np.int16)
    is1, is2, is3, is4 = (ftype[:, None] == f for f in (1, 2, 3, 4))
    for k in range(w + h - 1):  # S[-1] (k = 0) is a row of zeros
        y0, y1 = max(0, k - w + 1), min(h - 1, k)
        a = S[k, y0 + 1:y1 + 2]
        b = S[k, y0:y1 + 1]
        c = S[k - 1, y0:y1 + 1]
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        rows = slice(y0, y1 + 1)
        pred = np.where(is4[rows], paeth, np.where(is3[rows], (a + b) >> 1,
                        np.where(is2[rows], b, np.where(is1[rows], a, 0))))
        S[k + 1, y0 + 1:y1 + 2] = (raw[k, rows] + pred) & 0xFF
    out = S[ys + xs + 1, ys + 1].astype(np.uint8)
    return out.reshape(h, stride)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG: uint8 [H, W] (8-bit gray), uint16 [H, W] (16-bit
    gray), uint8 [H, W, 2] (gray + alpha), [H, W, 3] (RGB, and palette
    images without transparency) or [H, W, 4] (RGBA, and palette images
    with a tRNS chunk)."""
    with open(path, "rb") as f:
        data = f.read()
    header = palette = trns = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, comp, filt, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"{path}: unknown color type {color}")
    if depth != 8 and not (depth == 16 and color == 0):
        raise ValueError(f"{path}: bit depth {depth} with color type {color}"
                         " is not supported (8-bit, or 16-bit gray)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if comp or filt:
        raise ValueError(f"{path}: unknown compression or filter method")
    bpp = _CHANNELS[color] * depth // 8
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: image data too short")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    ftype, pixels = rows[:, 0], rows[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown row filter")
    if (ftype >= 3).any():
        pixels = _unfilter_diagonals(ftype, pixels, bpp)
    else:
        pixels = _unfilter_rows(ftype, pixels, bpp)
    if depth == 16:
        return pixels.view(">u2").astype(np.uint16)
    if color == 0:
        return pixels
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without PLTE")
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        table[:len(palette), :3] = palette
        if trns is not None:
            table[:len(trns), 3] = trns
            return table[pixels]
        return table[pixels, :3]
    return pixels.reshape(h, w, _CHANNELS[color])


def to_gray(img: np.ndarray) -> np.ndarray:
    """A decoded image as one channel, as PIL's ``convert("L")`` makes it:
    gray passes as it is (16-bit too), gray + alpha drops the alpha, color
    becomes ITU-R 601-2 luma in PIL's fixed point,
    (R*19595 + G*38470 + B*7471 + 0x8000) >> 16."""
    if img.ndim == 2:
        return img
    if img.shape[2] == 2:
        return img[..., 0]
    c = img[..., :3].astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path: str, arr: np.ndarray) -> None:
    """Write a uint8 or uint16 [H, W] array as 8- or 16-bit gray, every row
    with filter 0."""
    arr = np.asarray(arr)
    if arr.ndim != 2 or arr.dtype not in (np.uint8, np.uint16):
        raise ValueError("write_png takes a uint8 or uint16 [H, W] array")
    h, w = arr.shape
    depth = 8 * arr.itemsize
    rows = np.zeros((h, 1 + w * arr.itemsize), np.uint8)
    rows[:, 1:] = arr.astype(">u2" if depth == 16 else np.uint8).view(
        np.uint8).reshape(h, -1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0,
                                              0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
