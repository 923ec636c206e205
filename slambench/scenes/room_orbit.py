"""A mapped room re-traced lap after lap.

``worlds.Room(world_seed)`` (``SyntheticWorld``'s room) and one lap of
``worlds.orbit_poses(frames_per_lap)``, played with no gap from the lap's
pose ``start_pose`` for every seed: frame i is the lap's pose (start + i)
mod ``frames_per_lap``, so only one lap is rendered.
"""
from __future__ import annotations

from slambench import worlds


def build(traffic: dict, cfg: dict, rng) -> tuple:
    """(planes, world->camera poses, whether the poses repeat)."""
    planes = worlds.Room(int(traffic["world_seed"])).planes
    lap = worlds.orbit_poses(int(traffic["frames_per_lap"]))
    start = int(traffic["start_pose"])
    return planes, lap[start:] + lap[:start], True
