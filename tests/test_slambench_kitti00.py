"""The benchmark's KITTI 00 cell (``kitti00_stereo.long_drive``) on the CPU:
the harness finds its parts by name, its drive fits the street it renders,
and its map is the one the port's driver gives KITTI 00."""
import json
import math

import pytest

from orb_slam2_with_comment_tpu_torch.dataio.settings import (
    load_tracker_config)
from slambench import spec

CELL = "kitti00_stereo.long_drive"
KITTI00_FRAMES = 4541  # KITTI odometry sequence 00


@pytest.fixture(scope="module")
def cell():
    bench = spec.benchmark()
    w = spec.workload(bench, CELL)
    return bench, w, spec.config(w["config"]), spec.traffic(w["traffic"])


def test_the_cell_finds_its_parts_by_name(cell):
    bench, w, cfg, traffic = cell
    assert w["chips"] == 1 and cfg["name"] == w["config"] == "kitti00_stereo"
    entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    assert entry["file"] == "slambench/configs/kitti00_stereo.json"
    assert entry["source"] == cfg["source"] and entry["reduced"] == []
    assert cfg["reduced"] == [] and cfg["sensor"] == "stereo"
    assert callable(spec.scene(traffic["scene"]))
    limits = spec.limits(CELL)
    assert set(limits) == {"orb_mismatch_pct", "stereo_mismatch_pct",
                           "search_mismatch_pct", "pose_gap_mm",
                           "ba_pose_gap_mm", "ba_point_gap_mm"}
    new = {"maintenance_host_ms", "loop_detect_host_ms",
           "map_table_mb_per_frame"}
    for m in spec.metrics_of(bench, CELL, "per_layer"):
        assert callable(spec.reader(m["name"]))
        new.discard(m["name"])
    assert not new
    # the other cells do not report the new cell's metrics
    for other in ("tum_rgbd.revisit", "euroc_stereo.revisit"):
        names = {m["name"] for m in spec.metrics_of(bench, other,
                                                    "per_layer")}
        assert not names & {"maintenance_host_ms", "loop_detect_host_ms",
                            "map_table_mb_per_frame"}


def test_the_drive_fits_its_street(cell):
    _, _, cfg, traffic = cell
    frames = (traffic["warmup_frames"] + traffic["window_frames_max"]
              + traffic["trace_frames"])
    assert frames <= KITTI00_FRAMES
    assert cfg["frame_spacing_m"] == 0.82  # 3,724 m over 4,541 frames
    length = frames * cfg["frame_spacing_m"]
    assert traffic["n_tiles"] == math.ceil(length / traffic["tile_m"])
    assert length <= traffic["n_tiles"] * traffic["tile_m"]
    planes, poses, repeats = spec.scene(traffic["scene"])(traffic, cfg,
                                                           None)
    assert len(poses) == frames and not repeats and planes
    # the whole run fits the tracker's trajectory ring
    assert frames <= traffic["tracker"]["traj_capacity"]
    assert (traffic["sample_span"] <= traffic["window_frames_max"]
            and traffic["samples"] <= traffic["sample_span"])


def test_the_map_is_the_drivers_kitti00_sizing(cell, tmp_path):
    """A settings file of the configuration's own keys, read by the port's
    loader as ``examples/stereo_kitti.py --auto`` reads KITTI 00's."""
    _, _, cfg, _ = cell
    keys = [k for k in cfg if k.startswith(("Camera.", "ORBextractor."))]
    keys.append("ThDepth")
    path = tmp_path / "KITTI00-02.yaml"
    path.write_text("%YAML:1.0\n" + "".join(
        f"{k}: {json.dumps(cfg[k])}\n" for k in keys))
    tc = load_tracker_config(str(path), expected_frames=KITTI00_FRAMES)
    m = tc.map_cfg
    assert cfg["map"] == {"k_max": m.k_max, "n_feat": m.n_feat,
                          "l_max": m.l_max, "d_max": m.d_max}
    assert (tc.fx, tc.bf, tc.width, tc.height, tc.n_features) == (
        cfg["Camera.fx"], cfg["Camera.bf"], cfg["Camera.width"],
        cfg["Camera.height"], cfg["ORBextractor.nFeatures"])
