"""The monocular TUM driver of the PyTorch port against the JAX package's
(examples/mono_tum.py), System mode, both on the CPU, on a 10-frame TUM
fixture written by the port's fixture writer (640x480; the monocular
configuration doubles the settings' 1000 features). The port's initializer
is fed the JAX package's own 8-point sets (PRNGKey(0) at every try, as the
JAX tracker draws them; tests/jax_draws.py): the same KeyFrameTrajectory.txt
lines and timestamps, positions within 2e-2 of the monocular gauge's unit
and quaternion components within 2e-2 (tests/test_torch_tracker_sensors.py's
whole-run tolerance for the host mono path; measured 4.6e-3 and 2.2e-3).
The fixture's 10 frames are the first 10 of the 60-frame orbit, on which
both packages bootstrap (on a 10-frame orbit's larger steps the JAX
package does not).
"""
import os

import jax
import torch

import driver_runs
from jax_draws import jax_samples
from orb_slam2_with_comment_tpu_torch.dataio import fixtures

torch.set_num_threads(2)

N_FRAMES = 10


def test_mono_tum_matches_jax(tmp_path, monkeypatch):
    driver_runs.first_frames_of_the_orbit(monkeypatch)
    seq = fixtures.make_tum_rgbd(str(tmp_path / "tum_fixture"),
                                 n_frames=N_FRAMES, workers=2)
    args = [os.path.join(seq, "settings.yaml"), seq]
    want = driver_runs.run("jax", "mono_tum", args, str(tmp_path / "jax"))
    with jax_samples(octet_key=lambda: jax.random.PRNGKey(0)):
        got = driver_runs.run("port", "mono_tum", args, str(tmp_path / "port"))
    assert set(want) == {"KeyFrameTrajectory.txt"}
    assert len(want["KeyFrameTrajectory.txt"]) >= 2, "no bootstrap"
    driver_runs.assert_same_trajectory(
        got["KeyFrameTrajectory.txt"], want["KeyFrameTrajectory.txt"], 2e-2,
        2e-2)
    summary = got["run_summary.json"]
    assert summary["n_frames"] == N_FRAMES
    assert summary["n_keyframes"] == len(want["KeyFrameTrajectory.txt"])
