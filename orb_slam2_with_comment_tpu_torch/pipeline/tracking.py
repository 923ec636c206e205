"""Tracker configuration (port of pipeline/tracking.py: TrackerConfig).

The fields are the JAX package's, less the ones only its host-driven
Tracker reads.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..mapstate.map import MapConfig
from ..optim.residuals import CamParams


@dataclass
class TrackerConfig:
    sensor: str = "rgbd"  # "mono" | "stereo" | "rgbd"
    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    bf: float = 40.0
    width: int = 640
    height: int = 480
    n_features: int = 1000
    th_depth: float = 40.0  # in baseline units; meters = th_depth * bf / fx
    fps: float = 30.0
    min_init_features: int = 500
    # monocular bootstrap: matches the two-view initializer needs, and
    # tracked points the two-keyframe map must keep (Tracking.cc:687, 793)
    min_init_matches: int = 100
    map_cfg: MapConfig = field(default_factory=MapConfig)
    # Hamming acceptance of the projection searches (reference TH_HIGH)
    desc_th: int = 100
    desc_th_local: int = 100
    # raw depth -> meters (reference: DepthMapFactor, Tracking.cc:144-148)
    depth_factor: float = 1.0
    # radial-tangential distortion (k1, k2, p1, p2, k3)
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)

    @property
    def has_distortion(self) -> bool:
        return any(abs(d) > 1e-12 for d in self.dist)

    @property
    def cam(self) -> CamParams:
        return CamParams.of(self.fx, self.fy, self.cx, self.cy, self.bf)

    @property
    def depth_threshold(self) -> float:
        """ThDepth * baseline in meters (reference: Tracking.cc:137)."""
        return self.th_depth * self.bf / self.fx
