"""Deterministic dataset fixtures in the real on-disk formats (the port's
counterpart of scripts/make_fixture_dataset.py, on the port's
dataio/synthetic.py and dataio/png.py).

TUM RGB-D (rgb/ + 16-bit depth/ at factor 5000 + rgb.txt, depth.txt,
groundtruth.txt and a settings YAML), KITTI odometry stereo (image_0/ +
image_1/ + times.txt + poses_gt.txt), the street-scale KITTI circuit at
the KITTI 00-02 camera, and EuRoC MAV (mav0/cam{0,1}/data/<ns>.png with
raw radtan-distorted images + timestamps.txt). The text files are the
same text the repository's script writes and the images decode to the
same pixels: the render truncated (not rounded) to uint8, depth
``clip(depth * 5000, 0, 65535)``, zero where the render has no depth, then
truncated to uint16. The PNGs are written with filter 0.

    python -m orb_slam2_with_comment_tpu_torch.dataio.fixtures OUT_ROOT \
        [--frames 120] [--street] [--street-frames 500] [--workers 1]

``workers`` > 1 renders in that many spawned processes (the renders are
deterministic, so the files are the same). Each maker also renders on a
torch device (``device``, e.g. "cuda"): 1000 views of the street take
hours of a core in numpy and seconds on a card, and a few pixels of an
image then differ by one grey level (synthetic.render_views).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import multiprocessing
import os

import numpy as np

from . import png
from . import synthetic
from .synthetic import (StreetWorld, SyntheticWorld, lookout_trajectory,
                        orbit_trajectory, street_trajectory)


def _quat_wxyz(R):
    """Rotation matrix -> quaternion (w, x, y, z), numpy."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q



def _world(spec):
    kind, seed, closed = spec
    if kind == "street":
        return StreetWorld(seed=seed)
    return SyntheticWorld(seed=seed, closed=closed)


def _render_chunk(job):
    """Render views (R, t) of one world: job = (world spec, views, render
    keyword arguments)."""
    spec, views, kw = job
    world = _world(spec)
    return [world.render(R, t, **kw) for R, t in views]


def render_views(spec, views, kw=None, workers: int = 1, chunk: int = 5,
                 device=None):
    """(image, depth) of every view, in order; in ``workers`` spawned
    processes, ``chunk`` views each, when ``workers`` > 1; on the torch
    ``device``, 16 views a batch, when one is given."""
    kw = kw or {}
    if device is not None:
        world = _world(spec)
        return [v for i in range(0, len(views), 16)
                for v in synthetic.render_views(world, views[i:i + 16],
                                                device, **kw)]
    if workers <= 1:
        return _render_chunk((spec, views, kw))
    jobs = [(spec, views[i:i + chunk], kw)
            for i in range(0, len(views), chunk)]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers,
                                                mp_context=ctx) as pool:
        return [v for part in pool.map(_render_chunk, jobs) for v in part]


def _save_png8(path, arr, written):
    a = np.clip(arr, 0, 255).astype(np.uint8)
    png.write_png(path, a)
    if written is not None:
        written[path] = a


def _save_png16(path, arr, written):
    a = arr.astype(np.uint16)
    png.write_png(path, a)
    if written is not None:
        written[path] = a


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


SETTINGS_TUM = """%YAML:1.0
Camera.fx: 500.0
Camera.fy: 500.0
Camera.cx: 320.0
Camera.cy: 240.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.k3: 0.0
Camera.width: 640
Camera.height: 480
Camera.fps: 30.0
Camera.bf: 40.0
Camera.RGB: 1
ThDepth: 40.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
# engine extension: monocular-bootstrap gates tuned to the synthetic
# corner density (~200 level-0 corners; real imagery carries >400 and
# uses the reference-strength defaults)
Init.minFeatures: 150
Init.minMatches: 60
"""

SETTINGS_KITTI = """%YAML:1.0
Camera.fx: 500.0
Camera.fy: 500.0
Camera.cx: 320.0
Camera.cy: 240.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 640
Camera.height: 480
Camera.fps: 10.0
Camera.bf: 40.0
Camera.RGB: 1
ThDepth: 35.0
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def make_tum_rgbd(out_dir, n_frames=120, seed=1, fps=30.0, laps=1,
                  style="orbit", cal_err=0.0, workers=1, written=None,
                  device=None):
    """A TUM RGB-D sequence. laps > 1 revisits the start; style="lookout"
    rides an outward-gazing circle in a closed room (a genuine revisit),
    style="orbit" is the small arc. cal_err perturbs the settings file's
    focal length by that fraction (a realistic imperfect calibration).
    ``written``, a dict, receives every image written, by path."""
    if style == "lookout":
        spec = ("room", seed, True)
        poses = lookout_trajectory(n_frames=n_frames, laps=float(laps))
    else:
        spec = ("room", seed, False)
        poses = orbit_trajectory(n_frames=max(n_frames // laps, 2)) * laps
        poses = poses[:n_frames]
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    renders = render_views(spec, poses, workers=workers, device=device)
    rgb_lines, dep_lines, gt_lines = [], [], []
    for k, ((R, t), (img, depth)) in enumerate(zip(poses, renders)):
        ts = k / fps
        name = f"{ts:.6f}.png"
        _save_png8(os.path.join(out_dir, "rgb", name), img, written)
        d16 = np.clip(depth * 5000.0, 0, 65535)
        d16[depth <= 0] = 0  # invalid returns, TUM convention
        _save_png16(os.path.join(out_dir, "depth", name), d16, written)
        rgb_lines.append(f"{ts:.6f} rgb/{name}")
        dep_lines.append(f"{ts:.6f} depth/{name}")
        Rwc = np.asarray(R).T
        twc = -Rwc @ np.asarray(t)
        q = _quat_wxyz(Rwc)
        gt_lines.append(
            f"{ts:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
            f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}")
    hdr = "# timestamp filename\n"
    _write(os.path.join(out_dir, "rgb.txt"),
           hdr + "\n".join(rgb_lines) + "\n")
    _write(os.path.join(out_dir, "depth.txt"),
           hdr + "\n".join(dep_lines) + "\n")
    _write(os.path.join(out_dir, "groundtruth.txt"),
           "# ts tx ty tz qx qy qz qw\n" + "\n".join(gt_lines) + "\n")
    settings = SETTINGS_TUM
    if cal_err:
        settings = settings.replace(
            "Camera.fx: 500.0", f"Camera.fx: {500.0 * (1 + cal_err):.2f}"
        ).replace(
            "Camera.fy: 500.0", f"Camera.fy: {500.0 * (1 + cal_err):.2f}")
    _write(os.path.join(out_dir, "settings.yaml"), settings)
    return out_dir


def _stereo_views(poses, offset):
    """Left then right view of each pose; the right camera's center moves
    ``offset`` along the camera x axis (t' = t - offset, for any R)."""
    views = []
    for R, t in poses:
        views += [(R, t), (np.asarray(R), np.asarray(t) - offset)]
    return views


def _kitti_gt_row(R, t):
    Rwc = np.asarray(R).T
    twc = -Rwc @ np.asarray(t)
    return " ".join(f"{v:.9e}" for v in np.hstack(
        [Rwc, twc[:, None]]).reshape(-1))


def _write_kitti(out_dir, poses, renders, fps, settings, written,
                 workers: int = 1):
    """The KITTI files; ``workers`` threads encode the PNGs (zlib lets go
    of the interpreter lock)."""
    os.makedirs(os.path.join(out_dir, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "image_1"), exist_ok=True)
    jobs = [(os.path.join(out_dir, f"image_{c}", f"{k:06d}.png"),
             renders[2 * k + c][0]) for k in range(len(poses))
            for c in (0, 1)]
    with concurrent.futures.ThreadPoolExecutor(max(workers, 1)) as pool:
        list(pool.map(lambda job: _save_png8(*job, written), jobs))
    times, gt_rows = [], []
    for k, (R, t) in enumerate(poses):
        times.append(f"{k / fps:.6e}")
        gt_rows.append(_kitti_gt_row(R, t))
    _write(os.path.join(out_dir, "times.txt"), "\n".join(times) + "\n")
    _write(os.path.join(out_dir, "poses_gt.txt"), "\n".join(gt_rows) + "\n")
    _write(os.path.join(out_dir, "settings.yaml"), settings)
    return out_dir


def make_kitti_stereo(out_dir, n_frames=100, seed=2, fps=10.0,
                      baseline=0.08, workers=1, written=None, device=None):
    """A KITTI odometry stereo sequence: the orbit at the 8 cm baseline."""
    poses = orbit_trajectory(n_frames=n_frames)
    off = np.array([baseline, 0, 0], np.float32)
    renders = render_views(("room", seed, False), _stereo_views(poses, off),
                           workers=workers, device=device)
    return _write_kitti(out_dir, poses, renders, fps, SETTINGS_KITTI, written)


SETTINGS_KITTI_REAL = """%YAML:1.0
Camera.fx: 718.856
Camera.fy: 718.856
Camera.cx: 607.1928
Camera.cy: 185.2157
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 1241
Camera.height: 376
Camera.fps: 10.0
Camera.bf: 386.1448
Camera.RGB: 1
ThDepth: 35.0
ORBextractor.nFeatures: 2000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def make_kitti_street(out_dir, n_frames=500, seed=3, fps=10.0, workers=1,
                      written=None, device=None):
    """Street-scale KITTI-format stereo sequence: a ~60 m city-block
    circuit at the KITTI 00-02 camera geometry (1241x376, fx=718.856,
    bf=386.1448 -> 53.7 cm baseline), driven slightly past one lap so the
    sequence revisits its start."""
    world = StreetWorld(seed=seed)
    poses = street_trajectory(world, n_frames, laps=1.08)
    KFX, KCX, KCY, KBF = 718.856, 607.1928, 185.2157, 386.1448
    cam = dict(fx=KFX, fy=KFX, cx=KCX, cy=KCY, width=1241, height=376)
    off = np.array([KBF / KFX, 0, 0], np.float32)
    renders = render_views(("street", seed, False), _stereo_views(poses, off),
                           cam, workers=workers, device=device)
    return _write_kitti(out_dir, poses, renders, fps, SETTINGS_KITTI_REAL,
                        written, workers)


SETTINGS_EUROC = """%YAML:1.0
Camera.fx: 500.0
Camera.fy: 500.0
Camera.cx: 320.0
Camera.cy: 240.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 640
Camera.height: 480
Camera.fps: 20.0
Camera.bf: 40.0
Camera.RGB: 1
ThDepth: 35.0
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
LEFT.width: 640
LEFT.height: 480
LEFT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [500.0, 0.0, 320.0, 0.0, 500.0, 240.0, 0.0, 0.0, 1.0]
LEFT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data: [-0.20, 0.05, 0.0, 0.0, 0.0]
LEFT.R: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
LEFT.P: !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [500.0, 0.0, 320.0, 0.0, 0.0, 500.0, 240.0, 0.0, 0.0, 0.0, 1.0, 0.0]
RIGHT.width: 640
RIGHT.height: 480
RIGHT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [500.0, 0.0, 320.0, 0.0, 500.0, 240.0, 0.0, 0.0, 1.0]
RIGHT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data: [-0.20, 0.05, 0.0, 0.0, 0.0]
RIGHT.R: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
RIGHT.P: !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [500.0, 0.0, 320.0, 0.0, 0.0, 500.0, 240.0, 0.0, 0.0, 0.0, 1.0, 0.0]
"""


def _undistorted_dirs(width, height, fx, fy, cx, cy, D):
    """Per-RAW-pixel camera-frame ray directions for a radtan camera:
    invert the distortion by fixed-point iteration (the cv::undistortPoints
    scheme) so that distort(dirs.xy) lands back on the pixel grid."""
    k1, k2, p1, p2, k3 = [float(v) for v in D]
    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    xd = (u - cx) / fx
    yd = (v - cy) / fy
    x, y = xd.copy(), yd.copy()
    for _ in range(8):
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return np.stack([x, y, np.ones_like(x)], axis=-1).astype(np.float32)


def make_euroc_stereo(out_dir, n_frames=100, seed=3, fps=20.0,
                      baseline=0.08, workers=1, written=None, device=None):
    """EuRoC on-disk layout (mav0/cam0/data/<ns>.png + cam1 + timestamp
    file) with raw distorted images (radtan k1=-0.2, k2=0.05): the driver
    rectifies online through the YAML LEFT./RIGHT. blocks, as the reference
    does (stereo_euroc.cc:97-137). Ground truth is written TUM-style."""
    poses = orbit_trajectory(n_frames=n_frames)
    cam0 = os.path.join(out_dir, "mav0", "cam0", "data")
    cam1 = os.path.join(out_dir, "mav0", "cam1", "data")
    os.makedirs(cam0, exist_ok=True)
    os.makedirs(cam1, exist_ok=True)
    D = [-0.20, 0.05, 0.0, 0.0, 0.0]
    dirs = _undistorted_dirs(640, 480, 500.0, 500.0, 320.0, 240.0, D)
    off = np.array([baseline, 0, 0], np.float32)
    renders = render_views(("room", seed, False), _stereo_views(poses, off),
                           dict(dirs=dirs), workers=workers, device=device)
    stamps, gt_lines = [], []
    for k, (R, t) in enumerate(poses):
        ns = int(round((k / fps) * 1e9))
        name = f"{ns}"
        (left, _), (right, _) = renders[2 * k], renders[2 * k + 1]
        _save_png8(os.path.join(cam0, name + ".png"), left, written)
        _save_png8(os.path.join(cam1, name + ".png"), right, written)
        stamps.append(name)
        Rwc = np.asarray(R).T
        twc = -Rwc @ np.asarray(t)
        q = _quat_wxyz(Rwc)
        gt_lines.append(
            f"{ns / 1e9:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
            f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}")
    _write(os.path.join(out_dir, "timestamps.txt"), "\n".join(stamps) + "\n")
    _write(os.path.join(out_dir, "groundtruth_tum.txt"),
           "# ts tx ty tz qx qy qz qw\n" + "\n".join(gt_lines) + "\n")
    _write(os.path.join(out_dir, "settings.yaml"), SETTINGS_EUROC)
    return out_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_root")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--street", action="store_true",
                    help="also render the street-scale KITTI-geometry "
                         "circuit (kitti_street_fixture, ~60 m lap)")
    ap.add_argument("--street-frames", type=int, default=500)
    ap.add_argument("--workers", type=int, default=1,
                    help="render in this many processes")
    args = ap.parse_args(argv)
    w = args.workers
    if args.street:
        out = make_kitti_street(
            os.path.join(args.out_root, "kitti_street_fixture"),
            n_frames=args.street_frames, workers=w)
        print("wrote", out)
    tum = make_tum_rgbd(os.path.join(args.out_root, "tum_fixture"),
                        n_frames=args.frames, workers=w)
    loop = make_tum_rgbd(os.path.join(args.out_root, "tum_loop_fixture"),
                         n_frames=args.frames, laps=2, style="lookout",
                         cal_err=0.015, workers=w)
    kitti = make_kitti_stereo(os.path.join(args.out_root, "kitti_fixture"),
                              n_frames=max(args.frames * 5 // 6, 20),
                              workers=w)
    euroc = make_euroc_stereo(os.path.join(args.out_root, "euroc_fixture"),
                              n_frames=max(args.frames * 2 // 3, 20),
                              workers=w)
    for out in (tum, loop, kitti, euroc):
        print("wrote", out)


if __name__ == "__main__":
    main()
