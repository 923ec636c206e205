"""The one traffic generator: a traffic file's parameters and a seed ->
the frames a run feeds the tracker, with their ground-truth poses.

The traffic file names its ``scene``: ``scenes/<scene>.py``, found by name
(``spec.scene``), whose ``build(traffic, cfg, rng)`` gives the scene's
planes, the camera path and whether the path repeats. So a new world or
path is a file of its own, and a new mix over one is a data file.

The scenes here give every seed the same frames, so that runs of two seeds
do the same work; the seed draws only which frames the output check
samples (``checks.sample_frames``). (On the street, with textures drawn
from the seed, loop detection's host time followed them: six seeds read
17.5 to 25.9 frames/s on one H100 machine.) The frames are rendered on
the run's device in set-up and kept on the host, as the tracker takes
them from a recorded sequence: uint8 images, and for RGB-D uint16 depth at the
configuration's DepthMapFactor, for stereo the right view ``bf / fx``
metres along the camera's x axis, for mono nothing more.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from . import spec, worlds


def seed32(seed: int) -> int:
    """A 32-bit seed for numpy's RandomState from any whole number."""
    return int(np.random.SeedSequence(abs(int(seed))).generate_state(1)[0])


def camera(cfg: dict) -> dict:
    return {"fx": cfg["Camera.fx"], "fy": cfg["Camera.fy"],
            "cx": cfg["Camera.cx"], "cy": cfg["Camera.cy"],
            "width": int(cfg["Camera.width"]),
            "height": int(cfg["Camera.height"])}


@dataclass
class Sequence:
    """Rendered frames and the poses they were rendered at."""
    poses: list  # world->camera (R, t) of each stored frame
    images: np.ndarray  # [F, H, W] uint8 (the left view for stereo)
    second: np.ndarray | None  # [F, H, W] uint16 depth, uint8 right
    #                             views, or None (mono)
    cycle: bool  # frame i is stored frame i mod F (else i < F)
    render_s: float
    warmup_frames: int
    window_frames_max: int
    trace_frames: int

    @property
    def n_stored(self) -> int:
        return len(self.poses)

    def slot(self, i: int) -> int:
        if self.cycle:
            return i % self.n_stored
        if i >= self.n_stored:
            raise IndexError(f"frame {i} is past the path's "
                             f"{self.n_stored} frames")
        return i

    def frame(self, i: int) -> tuple:
        """The arguments of the tracker's ``process_<sensor>``."""
        k = self.slot(i)
        if self.second is None:
            return (self.images[k],)
        return self.images[k], self.second[k]

    def pose(self, i: int) -> tuple:
        return self.poses[self.slot(i)]

    @property
    def host_bytes(self) -> int:
        return self.images.nbytes + (0 if self.second is None
                                     else self.second.nbytes)


def _right(poses, baseline: float) -> list:
    shift = np.array([baseline, 0, 0], np.float32)
    return [(R, np.asarray(t, np.float32) - shift) for R, t in poses]


def build(traffic: dict, cfg: dict, seed: int, device,
          here: str = spec.HERE) -> Sequence:
    """The sequence a run of ``traffic`` at configuration ``cfg`` feeds,
    rendered on ``device``."""
    t0 = time.perf_counter()
    cam = camera(cfg)
    rng = np.random.default_rng(seed32(seed))
    planes, poses, cycle = spec.scene(traffic["scene"], here)(traffic, cfg,
                                                              rng)
    sensor = cfg["sensor"]
    images, depth = worlds.render_frames(planes, poses, cam, device,
                                         want_depth=sensor == "rgbd")
    if sensor == "rgbd":
        second = np.clip(depth * cfg["DepthMapFactor"], 0, 65535).astype(
            np.uint16)
    elif sensor == "stereo":
        second, _ = worlds.render_frames(
            planes, _right(poses, cfg["Camera.bf"] / cfg["Camera.fx"]), cam,
            device, want_depth=False)
    elif sensor == "mono":
        second = None
    else:
        raise ValueError(f"unknown sensor {sensor!r}")
    return Sequence(poses, images, second, cycle,
                    time.perf_counter() - t0, int(traffic["warmup_frames"]),
                    int(traffic["window_frames_max"]),
                    int(traffic["trace_frames"]))
