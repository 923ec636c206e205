"""Settings loader for the reference's per-sensor YAML files (a copy of
the JAX package's dataio/settings.py, building the port's TrackerConfig).

The reference reads its settings with cv::FileStorage (System.cc:59-64,
Tracking.cc:46-150). This loader takes the same files (TUM1.yaml,
KITTI00-02.yaml, EuRoC.yaml, ...) with a small reader for the
cv::FileStorage dialect (the "%YAML:1.0" header, ``!!opencv-matrix``
nodes), so no OpenCV is needed.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np


def parse_opencv_yaml(path: str) -> dict:
    """Parse a cv::FileStorage YAML file into {key: float | np.ndarray}."""
    text = open(path, "r", encoding="utf-8", errors="replace").read()
    # strip the %YAML:1.0 directive and document markers
    lines = [ln for ln in text.splitlines()
             if not ln.strip().startswith("%YAML") and ln.strip() != "---"]
    out: dict = {}
    i = 0
    n = len(lines)
    while i < n:
        ln = lines[i]
        i += 1
        s = ln.strip()
        if not s or s.startswith("#"):
            continue
        m = re.match(r"^([A-Za-z0-9_.]+):\s*(.*)$", s)
        if not m:
            continue
        key, val = m.group(1), m.group(2).split("#")[0].strip()
        if val and val != "!!opencv-matrix":
            # scalar
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val.strip('"')
            continue
        # matrix node: rows/cols/dt/data possibly spanning lines
        node_lines = []
        while i < n and (lines[i].startswith(" ") or lines[i].startswith("\t")):
            node_lines.append(lines[i].strip())
            i += 1
        node = " ".join(node_lines)
        rows = int(re.search(r"rows:\s*(\d+)", node).group(1))
        cols = int(re.search(r"cols:\s*(\d+)", node).group(1))
        data = re.search(r"data:\s*\[([^\]]*)\]", node).group(1)
        vals = [float(x) for x in data.replace(",", " ").split()]
        out[key] = np.asarray(vals, np.float64).reshape(rows, cols)
    return out


@dataclass
class Settings:
    """Typed view of a reference settings file (reference: Tracking.cc:46-150)."""
    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    dist: np.ndarray = field(default_factory=lambda: np.zeros(5))
    bf: float = 0.0
    fps: float = 30.0
    rgb: bool = True
    th_depth: float = 35.0
    depth_map_factor: float = 1.0
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # stereo rectification blocks (EuRoC), None if absent
    left_rect: dict | None = None
    right_rect: dict | None = None
    width: int = 640
    height: int = 480
    # monocular-bootstrap gates (engine extension keys Init.minFeatures /
    # Init.minMatches; absent from reference YAMLs -> reference-strength
    # defaults). The right values are a property of the image source's
    # corner density: synthetic fixtures carry ~200 level-0 corners vs
    # >400 on real imagery (TrackerConfig.min_init_matches docstring), so
    # fixture settings files declare their own gates.
    min_init_features: int | None = None
    min_init_matches: int | None = None


def load_settings(path: str) -> Settings:
    raw = parse_opencv_yaml(path)
    s = Settings()
    g = raw.get
    s.fx = float(g("Camera.fx", s.fx))
    s.fy = float(g("Camera.fy", s.fy))
    s.cx = float(g("Camera.cx", s.cx))
    s.cy = float(g("Camera.cy", s.cy))
    d = [float(g("Camera.k1", 0.0)), float(g("Camera.k2", 0.0)),
         float(g("Camera.p1", 0.0)), float(g("Camera.p2", 0.0)),
         float(g("Camera.k3", 0.0))]
    s.dist = np.asarray(d)
    s.bf = float(g("Camera.bf", 0.0))
    s.fps = float(g("Camera.fps", 30.0)) or 30.0
    s.rgb = bool(int(g("Camera.RGB", 1)))
    s.th_depth = float(g("ThDepth", 35.0))
    dmf = float(g("DepthMapFactor", 1.0))
    s.depth_map_factor = 1.0 if abs(dmf) < 1e-5 else dmf
    s.n_features = int(g("ORBextractor.nFeatures", 1000))
    s.scale_factor = float(g("ORBextractor.scaleFactor", 1.2))
    s.n_levels = int(g("ORBextractor.nLevels", 8))
    s.ini_th_fast = int(g("ORBextractor.iniThFAST", 20))
    s.min_th_fast = int(g("ORBextractor.minThFAST", 7))
    s.width = int(g("Camera.width", 640))
    s.height = int(g("Camera.height", 480))
    if "Init.minFeatures" in raw:
        s.min_init_features = int(raw["Init.minFeatures"])
    if "Init.minMatches" in raw:
        s.min_init_matches = int(raw["Init.minMatches"])
    if "LEFT.K" in raw:
        s.left_rect = {k.split(".", 1)[1]: raw[k] for k in raw if k.startswith("LEFT.")}
        s.right_rect = {k.split(".", 1)[1]: raw[k] for k in raw if k.startswith("RIGHT.")}
        s.width = int(s.left_rect.get("width", s.width))
        s.height = int(s.left_rect.get("height", s.height))
    return s


def load_tracker_config(path: str, expected_frames: int | None = None,
                        k_max: int | None = None, l_max: int | None = None,
                        sensor: str | None = None):
    """Settings file -> TrackerConfig (sensor is set by the System ctor).

    The map capacity is sized to the extractor budget: feature slots per
    keyframe MUST equal ORBextractor.nFeatures (SoA rows are fixed-width).

    Capacity sizing (the reference's map is unbounded, Map.cc:32-44; ours
    grows geometrically at runtime): the INITIAL capacity only controls how
    many grow-recompiles a sequence pays. Dataset drivers pass
    ``expected_frames`` so long sequences (KITTI 00: 4541 frames) start
    near their working size — keyframes run ~1 per 3-4 frames before
    culling — while short clips stay small. Explicit k_max/l_max win.
    Distortion (Camera.k1..k3) is threaded into the tracker: keypoints are
    undistorted once per frame (reference: Frame::UndistortKeyPoints).
    """
    from ..mapstate.map import MapConfig
    from ..pipeline.tracking import TrackerConfig
    s = load_settings(path)
    n_features = s.n_features
    if sensor == "mono":
        # The reference runs monocular INITIALIZATION with a 2x-density
        # extractor (mpIniORBextractor = 2*nFeatures, Tracking.cc:126) —
        # without it the level-0 budget (~200 of 1000 slots) starves the
        # init window matcher below its >=100-match gate. Fixed-shape SoA
        # rows cannot swap extractors mid-run, so monocular configs carry
        # the doubled budget for the whole run (a strict superset of the
        # reference's feature set; steady-state cost is a few ms/frame).
        n_features = 2 * s.n_features
    if k_max is None:
        if expected_frames is not None:
            # ~1 keyframe per 3 frames pre-culling, rounded to a power of 2
            k_max = 64
            while k_max < min(4096, expected_frames // 3 + 32):
                k_max *= 2
        else:
            k_max = 256
    if l_max is None:
        # steady state ~150-400 live landmarks born per keyframe
        l_max = max(20000, min(1 << 20, k_max * 512))
    map_cfg = MapConfig(k_max=k_max, n_feat=n_features, l_max=l_max)
    init_kw = {}
    if s.min_init_features is not None:
        init_kw["min_init_features"] = s.min_init_features
    if s.min_init_matches is not None:
        init_kw["min_init_matches"] = s.min_init_matches
    return TrackerConfig(
        fx=s.fx, fy=s.fy, cx=s.cx, cy=s.cy, bf=s.bf or 40.0,
        width=s.width, height=s.height, n_features=n_features,
        th_depth=s.th_depth, fps=s.fps, map_cfg=map_cfg,
        dist=tuple(float(x) for x in s.dist), **init_kw,
        # Depth arrives in METERS at the tracker boundary: the reference
        # converts raw uint16 depth inside Tracking (Tracking.cc:144-148
        # convertTo(CV_32F, 1/DepthMapFactor)); here the dataset loaders /
        # RgbdNode own that conversion (datasets.py TumRgbdDataset divides
        # by DepthMapFactor at decode). Scaling again here shrank the scene
        # 5000x and froze estimated translation at the micron level.
        depth_factor=1.0,
    )
