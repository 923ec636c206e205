"""The RGB-D TUM driver of the PyTorch port against the JAX package's
(examples/rgbd_tum.py), both on the CPU, on an 8-frame TUM fixture written
by the port's fixture writer (640x480, 1000 features).

- ``--auto`` (the AutoTracker through ``TumRgbdDataset.prefetch()``): the
  same CameraTrajectory.txt lines and timestamps, positions within 1e-3 m
  and quaternion components within 1e-3 (float32 sums in another order;
  measured 3.0e-4 m and 7.2e-5), and the same run_summary.json counts.
- System mode (the host Tracker, every frame finalized at once on both
  sides): the same CameraTrajectory.txt and KeyFrameTrajectory.txt lines
  and timestamps within the same tolerances (measured 1.2e-5 m; the host
  path's parity runs have differed by up to 7.3e-4 m).

The fixture's 8 frames are the first 8 of the 60-frame orbit
(driver_runs.first_frames_of_the_orbit), the frames phase 14 of
chip_smoke.py starts with.
"""
import os

import pytest
import torch

import driver_runs
from orb_slam2_with_comment_tpu_torch.dataio import fixtures

torch.set_num_threads(2)

N_FRAMES = 8


@pytest.fixture(scope="module")
def tum(tmp_path_factory):
    with pytest.MonkeyPatch.context() as monkeypatch:
        driver_runs.first_frames_of_the_orbit(monkeypatch)
        return _write(tmp_path_factory)


def _write(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("drivers"))
    return fixtures.make_tum_rgbd(os.path.join(root, "tum_fixture"),
                                  n_frames=N_FRAMES, workers=2)


@pytest.mark.parametrize("mode", ["auto", "system"])
def test_rgbd_tum_matches_jax(tum, tmp_path, mode):
    args = [os.path.join(tum, "settings.yaml"), tum]
    if mode == "auto":
        args.append("--auto")
    want = driver_runs.run("jax", "rgbd_tum", args, str(tmp_path / "jax"))
    got = driver_runs.run("port", "rgbd_tum", args, str(tmp_path / "port"))
    if mode == "auto":
        assert set(want) == {"CameraTrajectory.txt", "run_summary.json"}
        for key in driver_runs.SUMMARY_COUNTS:
            assert got["run_summary.json"][key] == \
                want["run_summary.json"][key], key
        assert want["run_summary.json"]["n_frames"] == N_FRAMES
        assert got["run_summary.json"]["decode_ms"] >= 0
    else:
        assert set(want) == {"CameraTrajectory.txt",
                             "KeyFrameTrajectory.txt"}
        driver_runs.assert_same_trajectory(
            got["KeyFrameTrajectory.txt"], want["KeyFrameTrajectory.txt"],
            1e-3, 1e-3)
        summary = got["run_summary.json"]
        assert summary["n_frames"] == N_FRAMES
        assert summary["n_keyframes"] == len(want["KeyFrameTrajectory.txt"])
    assert len(want["CameraTrajectory.txt"]) == N_FRAMES
    driver_runs.assert_same_trajectory(
        got["CameraTrajectory.txt"], want["CameraTrajectory.txt"], 1e-3, 1e-3)
