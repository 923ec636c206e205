"""A forward drive down an open street that never comes back.

``worlds.StreetCanyon`` of ``n_tiles`` tiles ``tile_m`` long (tile
textures from ``world_seed``, curving by ``curve_rad`` over
``curve_period_m``), and ``warmup_frames + window_frames_max +
trace_frames`` poses from the street's start, ``frame_spacing_m`` apart
(the configuration's, else the traffic's): the same frames for every
seed.
"""
from __future__ import annotations

from slambench import worlds


def build(traffic: dict, cfg: dict, rng) -> tuple:
    """(planes, world->camera poses, whether the poses repeat)."""
    n = (int(traffic["warmup_frames"]) + int(traffic["window_frames_max"])
         + int(traffic["trace_frames"]))
    spacing = float(cfg["frame_spacing_m"])
    n_tiles = int(traffic["n_tiles"])
    length = n * spacing
    if spacing <= 0 or length > n_tiles * traffic["tile_m"]:
        raise ValueError(f"a drive of {n} frames {spacing} m apart does not "
                         f"fit its {n_tiles} tiles")
    street = worlds.StreetCanyon(
        int(traffic["world_seed"]), range(n_tiles), length,
        tile_m=traffic["tile_m"], curve_rad=traffic["curve_rad"],
        curve_period_m=traffic["curve_period_m"])
    return street.planes, street.poses(n, spacing), False
