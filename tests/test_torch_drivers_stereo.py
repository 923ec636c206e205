"""The stereo drivers of the PyTorch port against the JAX package's
(examples/stereo_kitti.py and stereo_euroc.py), System mode, both on the
CPU, on 6-frame KITTI and EuRoC fixtures written by the port's fixture
writer (640x480, 1000 features, bf 40; the EuRoC images radtan-distorted
and rectified online by each package's StereoRectifier).

The same CameraTrajectory.txt lines (KITTI: 12 numbers a frame; EuRoC: TUM
lines with their timestamps), positions within 1e-3 m and rotation
entries or quaternion components within 1e-3 (the host path's float32
sums in another order, and for EuRoC the bilinear remap's; measured
1.0e-5 m on KITTI, 5.8e-4 m and 1.3e-4 on EuRoC). The fixtures' 6 frames
are the first 6 of the 60-frame orbit.
"""
import os

import pytest
import torch

import driver_runs
from orb_slam2_with_comment_tpu_torch.dataio import fixtures

torch.set_num_threads(2)

N_FRAMES = 6


@pytest.mark.parametrize("name", ["stereo_kitti", "stereo_euroc"])
def test_stereo_driver_matches_jax(tmp_path, monkeypatch, name):
    driver_runs.first_frames_of_the_orbit(monkeypatch)
    if name == "stereo_kitti":
        seq = fixtures.make_kitti_stereo(str(tmp_path / "kitti_fixture"),
                                         n_frames=N_FRAMES, workers=2)
        args = [os.path.join(seq, "settings.yaml"), seq]
    else:
        seq = fixtures.make_euroc_stereo(str(tmp_path / "euroc_fixture"),
                                         n_frames=N_FRAMES, workers=2)
        args = [os.path.join(seq, "settings.yaml"),
                os.path.join(seq, "mav0"),
                os.path.join(seq, "timestamps.txt")]
    want = driver_runs.run("jax", name, args, str(tmp_path / "jax"))
    got = driver_runs.run("port", name, args, str(tmp_path / "port"))
    assert set(want) == {"CameraTrajectory.txt"}
    assert len(want["CameraTrajectory.txt"]) == N_FRAMES
    driver_runs.assert_same_trajectory(
        got["CameraTrajectory.txt"], want["CameraTrajectory.txt"], 1e-3,
        1e-3, kitti=name == "stereo_kitti")
    summary = got["run_summary.json"]
    assert summary["n_frames"] == summary["n_tracked"] == N_FRAMES
