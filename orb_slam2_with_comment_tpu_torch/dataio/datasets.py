"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV (the port's copy
of dataio/datasets.py).

Rebuilds the reference's example-driver loaders (reference:
Examples/Monocular/mono_tum.cc:44-66 LoadImages, mono_kitti.cc,
mono_euroc.cc, Examples/RGB-D associations per README.md:151-167) as
plain-Python iterators yielding (timestamp, grayscale float32 [H,W]) —
or (ts, rgb, depth) for RGB-D — ready for System.track_*.

Images decode through the port's own PNG codec (dataio/png.py) into the
values PIL's ``convert("L")`` gives: gray passes as it is, color becomes
integer ITU-R 601-2 luma (the reference's cvtColor RGB->GRAY weights).
"""
from __future__ import annotations

import os

import numpy as np

from . import png


def _imread_gray(path: str) -> np.ndarray:
    return png.to_gray(png.read_png(path)).astype(np.float32)


def _imread_depth(path: str, factor: float) -> np.ndarray:
    return png.read_png(path).astype(np.float32) / factor


# -- TUM RGB-D --------------------------------------------------------------

def load_tum_list(list_path: str):
    """Parse a TUM rgb.txt / depth.txt: lines `timestamp filename`
    (reference: mono_tum.cc LoadImages :44-66)."""
    out = []
    with open(list_path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            parts = ln.split()
            out.append((float(parts[0]), parts[1]))
    return out


def associate_tum(rgb_list, depth_list, max_diff: float = 0.02,
                  offset: float = 0.0):
    """Timestamp association (the TUM associate.py workflow the reference
    README points at, README.md:157-161): greedy best-pair matching within
    max_diff."""
    pairs = []
    candidates = sorted(
        (abs(ta - (tb + offset)), ia, ib)
        for ia, (ta, _) in enumerate(rgb_list)
        for ib, (tb, _) in enumerate(depth_list)
        if abs(ta - (tb + offset)) < max_diff
    )
    used_a, used_b = set(), set()
    for diff, ia, ib in candidates:
        if ia not in used_a and ib not in used_b:
            used_a.add(ia)
            used_b.add(ib)
            pairs.append((ia, ib))
    pairs.sort()
    return pairs


class TumRgbdDataset:
    """TUM RGB-D sequence: yields (ts, gray, depth_meters)."""

    def __init__(self, seq_dir: str, depth_map_factor: float = 5000.0,
                 associations: str | None = None, max_diff: float = 0.02):
        self.seq_dir = seq_dir
        self.factor = depth_map_factor
        if associations is not None:
            # associations file: `ts_rgb rgb_path ts_depth depth_path`
            self.items = []
            for ln in open(associations):
                ln = ln.strip()
                if not ln or ln.startswith("#"):
                    continue
                p = ln.split()
                self.items.append((float(p[0]), p[1], p[3]))
        else:
            rgb = load_tum_list(os.path.join(seq_dir, "rgb.txt"))
            dep = load_tum_list(os.path.join(seq_dir, "depth.txt"))
            self.items = [(rgb[ia][0], rgb[ia][1], dep[ib][1])
                          for ia, ib in associate_tum(rgb, dep, max_diff)]

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        for ts, rgb_rel, dep_rel in self.items:
            yield (ts,
                   _imread_gray(os.path.join(self.seq_dir, rgb_rel)),
                   _imread_depth(os.path.join(self.seq_dir, dep_rel), self.factor))

    def prefetch(self, n_threads: int = 4):
        """Iterate with the native C++ threaded decoder (the port's
        csrc/frame_loader.cc): PNG decode overlaps tracking compute instead
        of blocking it (the reference decodes synchronously on the tracking
        thread, mono_tum.cc:87-96). Iterates the plain reader when g++ or
        libpng's header is absent. The native decoder's gray is float luma
        and its 16-bit non-depth images are scaled to 0-255, as the JAX
        package's are: on color or 16-bit images its frames differ from
        the plain reader's."""
        from . import native_loader
        if native_loader.get_lib() is None or not self.items:
            yield from self
            return
        h, w = png.read_shape(os.path.join(self.seq_dir, self.items[0][1]))
        rgb_paths = [os.path.join(self.seq_dir, r) for _, r, _ in self.items]
        dep_paths = [os.path.join(self.seq_dir, d) for _, _, d in self.items]
        rgb_l = native_loader.NativeSequenceLoader(
            rgb_paths, h, w, n_threads=n_threads)
        dep_l = native_loader.NativeSequenceLoader(
            dep_paths, h, w, n_threads=n_threads, is_depth=True,
            depth_factor=self.factor)
        try:
            for ts, _, _ in self.items:
                rgb = rgb_l.next()
                dep = dep_l.next()
                if rgb is None or dep is None:
                    break
                yield ts, rgb, dep
        finally:
            rgb_l.close()
            dep_l.close()


class TumMonoDataset:
    """TUM monocular: yields (ts, gray)."""

    def __init__(self, seq_dir: str):
        self.seq_dir = seq_dir
        self.items = load_tum_list(os.path.join(seq_dir, "rgb.txt"))

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        for ts, rel in self.items:
            yield ts, _imread_gray(os.path.join(self.seq_dir, rel))


# -- KITTI odometry ----------------------------------------------------------

class KittiDataset:
    """KITTI odometry sequence dir (image_0 [, image_1], times.txt):
    yields (ts, gray) or (ts, left, right) when stereo=True (reference:
    mono_kitti.cc / stereo_kitti.cc LoadImages)."""

    def __init__(self, seq_dir: str, stereo: bool = False):
        self.seq_dir = seq_dir
        self.stereo = stereo
        with open(os.path.join(seq_dir, "times.txt")) as f:
            self.times = [float(x) for x in f.read().split()]

    def __len__(self):
        return len(self.times)

    def __iter__(self):
        for i, ts in enumerate(self.times):
            left = _imread_gray(
                os.path.join(self.seq_dir, "image_0", f"{i:06d}.png"))
            if self.stereo:
                right = _imread_gray(
                    os.path.join(self.seq_dir, "image_1", f"{i:06d}.png"))
                yield ts, left, right
            else:
                yield ts, left


# -- EuRoC MAV ---------------------------------------------------------------

class EurocDataset:
    """EuRoC mav0 dir + timestamp file: yields (ts, gray) or
    (ts, left, right); online rectification hooks in the driver (reference:
    stereo_euroc.cc:97-137)."""

    def __init__(self, mav_dir: str, times_path: str, stereo: bool = False):
        self.cam0 = os.path.join(mav_dir, "cam0", "data")
        self.cam1 = os.path.join(mav_dir, "cam1", "data")
        self.stereo = stereo
        self.stamps = []
        with open(times_path) as f:
            for ln in f:
                ln = ln.strip()
                if ln:
                    self.stamps.append(ln.split(",")[0].split()[0])

    def __len__(self):
        return len(self.stamps)

    def __iter__(self):
        for s in self.stamps:
            ts = float(s) / 1e9
            left = _imread_gray(os.path.join(self.cam0, s + ".png"))
            if self.stereo:
                right = _imread_gray(os.path.join(self.cam1, s + ".png"))
                yield ts, left, right
            else:
                yield ts, left
