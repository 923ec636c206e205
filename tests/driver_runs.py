"""Run a dataset driver of either package in a directory of its own and
read back what it wrote; used by the tests/test_torch_drivers*.py files.

The JAX package's drivers are the repository's examples/*.py (their
``main``, imported from examples/ as they import their ``_util``); the
port's are ``orb_slam2_with_comment_tpu_torch.examples.*``, run with
``--device cpu``. Both System classes are made to finalize every frame at
once (``pipeline_depth = 0``): the JAX tracker finalizes on a thread, so a
pipelined decision's frame depends on timing (as tests/test_torch_tracker.py
does)."""
import contextlib
import importlib
import json
import os
import sys

import numpy as np

from orb_slam2_with_comment_tpu import system as jsystem
from orb_slam2_with_comment_tpu_torch import system as tsystem
from orb_slam2_with_comment_tpu_torch.dataio import fixtures
from orb_slam2_with_comment_tpu_torch.dataio.synthetic import orbit_trajectory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = ("CameraTrajectory.txt", "KeyFrameTrajectory.txt",
           "run_summary.json")


@contextlib.contextmanager
def _unpipelined(system_cls):
    init = system_cls.__init__

    def no_pipeline(self, *a, **kw):
        init(self, *a, **kw)
        self.tracker.pipeline_depth = 0

    system_cls.__init__ = no_pipeline
    try:
        yield
    finally:
        system_cls.__init__ = init


def first_frames_of_the_orbit(monkeypatch, n_orbit: int = 60):
    """Make the fixture writer's orbit of n frames the first n frames of
    the ``n_orbit``-frame orbit (chip_smoke.py's fixtures), whose small
    steps a few frames can track and a monocular run can bootstrap on."""
    monkeypatch.setattr(fixtures, "orbit_trajectory", lambda n_frames: (
        orbit_trajectory(n_orbit)[:n_frames]))


def run(which: str, name: str, args, workdir) -> dict:
    """Run driver ``name`` of ``which`` ("jax" or "port") with ``args`` in
    ``workdir``; returns {file name: its lines (the summary: its dict)}
    for each output file it wrote."""
    if which == "jax":
        examples = os.path.join(ROOT, "examples")
        if examples not in sys.path:
            sys.path.insert(0, examples)
        mod = importlib.import_module(name)
        argv, system_cls = [name, *args], jsystem.System
    else:
        mod = importlib.import_module(
            "orb_slam2_with_comment_tpu_torch.examples." + name)
        argv, system_cls = [name, *args, "--device", "cpu"], tsystem.System
    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        with _unpipelined(system_cls):
            assert mod.main(argv) == 0
    finally:
        os.chdir(cwd)
    out = {}
    for fname in OUTPUTS:
        path = os.path.join(workdir, fname)
        if os.path.exists(path):
            with open(path) as f:
                out[fname] = (json.load(f) if fname.endswith(".json")
                              else f.read().splitlines())
    return out


def numbers(lines) -> np.ndarray:
    return np.array([[float(v) for v in ln.split()] for ln in lines])


def assert_same_trajectory(got, want, pos_tol: float, rot_tol: float,
                           kitti: bool = False):
    """The same lines and timestamps (TUM) and positions within
    ``pos_tol`` m; rotation entries (KITTI) or quaternion components (TUM)
    within ``rot_tol``."""
    assert len(got) == len(want) > 0
    g, w = numbers(got), numbers(want)
    if kitti:
        pos, rot = [3, 7, 11], [0, 1, 2, 4, 5, 6, 8, 9, 10]
    else:
        assert [ln.split()[0] for ln in got] == [ln.split()[0] for ln in want]
        pos, rot = [1, 2, 3], [4, 5, 6, 7]
    assert np.abs(g[:, pos] - w[:, pos]).max() <= pos_tol
    assert np.abs(g[:, rot] - w[:, rot]).max() <= rot_tol


SUMMARY_COUNTS = ("n_frames", "n_keyframes", "n_loops_closed", "lost_at",
                  "n_compact_kf", "n_compact_lm")
