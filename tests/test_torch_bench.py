"""The port's bench (orb_slam2_with_comment_tpu_torch/bench.py) on the CPU,
at a reduced size: tests/test_torch_slice.py's 320x240 camera, 500
features for every figure, a 4-frame orbit and one timed pass a figure;
the headline keeps its build pass, and the sub-figures track their one
pass from scratch, to keep the run short.

- The JSON line has bench.py's keys (``metric``, ``value``, ``unit``,
  ``vs_baseline`` = value / 30, ``extra``, ``errors``), and ``extra`` adds
  only ``passes`` and ``card``; every figure that passed carries its
  passes (ms per frame by the host clock, none by CUDA events on the CPU)
  and its launches per frame (none on the CPU: the plain versions run).
- At this size the monocular bootstrap never finds its matches (too few
  level-0 keypoints at 500 features, in either package), so ``mono_fps``
  fails its gate: it lands in ``errors`` and not in ``extra``.
- The gates on a tracker's ``finalize()``: bench.py's (initialized, never
  lost; for the headline every timed frame valid and 3 keyframes) and the
  pose gates (0.02 m, 0.03 m for stereo, 1 degree; mono 0.03 m of
  similarity-aligned ATE), each held on both sides of its threshold.
- An all-black sequence (black frames, not rendered) never initializes:
  the headline is 0.0 with an ``error`` object and ``main`` returns 1.
- ``--device cuda`` (the default) without a card raises before a frame is
  rendered or tracked: the bench never carries on on the CPU.

The batched RGB-D path (``batch_frames=4``) equals the per-frame path bit
for bit and agrees with the JAX package's: tests/test_torch_batched.py
holds that, so it is not repeated here. The bench on the card is
tests/test_torch_cuda.py::test_bench_runs_on_the_card.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from orb_slam2_with_comment_tpu_torch import bench
from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
    orbit_trajectory)
from orb_slam2_with_comment_tpu_torch.pipeline.tracking import TrackerConfig

torch.set_num_threads(2)

REDUCED = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240,
               n_features=500)
N = 4


@pytest.fixture(scope="module")
def result():
    cpu = torch.device("cpu")
    figs = bench.figures(N, cpu, REDUCED, passes=1)
    figs[2:] = [dataclasses.replace(f, build=False) for f in figs[2:]]
    return bench.report(figs, [bench.track(f, cpu) for f in figs], cpu)


def test_keys_are_bench_py_s(result):
    assert set(result) == {"metric", "value", "unit", "vs_baseline", "extra",
                           "errors"}
    assert result["metric"] == "tracking_fps"
    assert result["unit"] == "frames/s"
    assert result["value"] > 0
    assert result["vs_baseline"] == result["value"] / 30.0
    passed = {"map_building_fps", "stereo_fps", "stereo_kitti_fps"}
    assert set(result["extra"]) == passed | {"passes", "card"}
    assert result["extra"]["card"] == "cpu"
    for name in passed:
        assert result["extra"][name] > 0


def test_every_figure_carries_its_passes(result):
    passes = result["extra"]["passes"]
    assert set(passes) == {"tracking_fps", "map_building_fps", "stereo_fps",
                           "stereo_kitti_fps"}
    for name, p in passes.items():
        assert set(p) == {"events_ms_per_frame", "host_ms_per_frame",
                          "launches_per_frame"}
        assert p["events_ms_per_frame"] is None  # no CUDA events on the CPU
        assert len(p["host_ms_per_frame"]) == 1
        assert p["host_ms_per_frame"][0] > 0
        assert p["launches_per_frame"] == dict.fromkeys(
            bench.launch_counts(), 0.0)
        rate = (result["value"] if name == "tracking_fps"
                else result["extra"][name])
        assert rate == pytest.approx(1000.0 / p["host_ms_per_frame"][0])


def test_failed_sub_figure_lands_in_errors(result):
    assert set(result["errors"]) == {"mono_fps"}
    assert result["errors"]["mono_fps"] == {
        "initialized": False, "lost_at": -1, "n_keyframes": 0}
    assert "mono_fps" not in result["extra"]
    assert "mono_fps" not in result["extra"]["passes"]


def test_figures_are_bench_py_s():
    """The full-size configurations and pass counts (rendered at a 1-frame
    orbit on the CPU, tracked nowhere)."""
    figs = bench.figures(1, torch.device("cpu"))
    assert [(f.name, f.cfg.sensor, f.build, f.passes) for f in figs] == [
        ("tracking_fps", "rgbd", True, 3),
        ("map_building_fps", "rgbd", False, 1),
        ("stereo_fps", "stereo", True, 2),
        ("stereo_kitti_fps", "stereo", True, 2),
        ("mono_fps", "mono", True, 2)]
    head, build, stereo, kitti, mono = (f.cfg for f in figs)
    assert head == build
    assert (head.width, head.height, head.n_features, head.depth_factor,
            tuple(head.map_cfg)) == (640, 480, 1000, 1 / 5000,
                                     (24, 1000, 8000, 8))
    assert (stereo.bf, stereo.fx, stereo.n_features) == (40.0, 500.0, 1000)
    assert (kitti.width, kitti.height, kitti.bf, kitti.fps,
            kitti.n_features) == (1241, 376, 386.1448, 10, 2000)
    assert (mono.n_features, mono.min_init_matches,
            tuple(mono.map_cfg)) == (2000, 60, (24, 2000, 8000, 8))
    img, depth = figs[0].frames[0]
    assert img.dtype == np.uint8 and img.shape == (480, 640)
    assert depth.dtype == np.uint16
    left, right = figs[3].frames[0]
    assert left.shape == right.shape == (376, 1241)
    assert len(figs[3].frames) == 1  # fewer poses than max(20, n // 2)


def _figure(sensor: str, name: str = "stereo_fps", build: bool = True,
            passes: int = 2, n: int = 6):
    return bench.Figure(name, TrackerConfig(sensor=sensor), [()] * n,
                        orbit_trajectory(n), build, passes)


def _out(fig, shift=0.0, yaw=0.0, scale=1.0, valid=True, **kw):
    """A finalize() result over the figure's build and timed passes: the
    ground truth with every camera center moved ``shift`` m along x (for
    ``scale``, scaled about the origin) and turned ``yaw`` rad."""
    n = len(fig.frames)
    reps = fig.passes + fig.build
    c, s = np.cos(yaw), np.sin(yaw)
    turn = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    Rs, ts = [], []
    for R, t in fig.poses * reps:
        center = -R.T @ t * scale + np.array([shift, 0, 0], np.float32)
        R2 = turn @ R
        Rs.append(R2)
        ts.append(-R2 @ center)
    return {"R": np.stack(Rs), "t": np.stack(ts),
            "valid": np.full(n * reps, valid),
            **{"initialized": True, "lost_at": -1, "n_keyframes": 3, **kw}}


@pytest.mark.parametrize("sensor,shift,ok", [
    ("rgbd", 0.019, True), ("rgbd", 0.021, False),
    ("stereo", 0.029, True), ("stereo", 0.031, False)])
def test_translation_gate(sensor, shift, ok):
    fig = _figure(sensor, f"{sensor}_fps")
    got, seen = bench.check(fig, _out(fig, shift=shift))
    assert got is ok
    assert seen["median_t_err_m"] == pytest.approx([shift] * 2, abs=1e-5)


@pytest.mark.parametrize("yaw_deg,ok", [(0.9, True), (1.1, False)])
def test_rotation_gate(yaw_deg, ok):
    fig = _figure("stereo")
    got, seen = bench.check(fig, _out(fig, yaw=np.radians(yaw_deg)))
    assert got is ok
    assert seen["median_rot_err_deg"] == pytest.approx([yaw_deg] * 2,
                                                       abs=1e-3)


@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_mono_gate_aligns_the_scale(scale):
    fig = _figure("mono", "mono_fps")
    got, seen = bench.check(fig, _out(fig, scale=scale))
    assert got and max(seen["ate_m"]) < 1e-5


def test_mono_gate_fails_on_a_bent_trajectory():
    fig = _figure("mono", "mono_fps")
    out = _out(fig)
    n = len(fig.frames)
    out["t"][n::2] += np.float32(0.1)  # every other timed frame 0.17 m off
    got, seen = bench.check(fig, out)
    assert not got and min(seen["ate_m"]) > bench.ATE_GATE


@pytest.mark.parametrize("what", [
    dict(initialized=False), dict(lost_at=3), dict(n_keyframes=2),
    dict(valid=False)])
def test_headline_gates(what):
    fig = _figure("rgbd", "tracking_fps", passes=3)
    got, seen = bench.check(fig, _out(fig, **what))
    assert not got
    assert "median_t_err_m" not in seen  # no pose gate after a failed one


def test_headline_passes_its_gates():
    fig = _figure("rgbd", "tracking_fps", passes=3)
    got, seen = bench.check(fig, _out(fig))
    assert got
    assert seen["valid_timed"] == 3 * len(fig.frames)


def test_map_building_is_checked_on_its_one_pass():
    fig = _figure("rgbd", "map_building_fps", build=False, passes=1)
    out = _out(fig)
    out["valid"][:] = False  # bench.py holds only the headline's frames
    got, seen = bench.check(fig, out)
    assert got and "valid_timed" not in seen
    assert len(seen["median_t_err_m"]) == 1


def test_black_sequence_never_initializes(monkeypatch, capsys):
    def black(world, poses, device, cfg):
        shape = (cfg.height, cfg.width)
        return [(np.zeros(shape, np.uint8), np.zeros(shape, np.float32))
                for _ in poses]

    monkeypatch.setattr(bench, "render", black)
    monkeypatch.setattr(bench, "run", functools.partial(
        bench.run, reduced=REDUCED, passes=1))
    monkeypatch.setenv("BENCH_FRAMES", str(N))
    assert bench.main(["--device", "cpu"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"metric": "tracking_fps", "value": 0.0,
                    "unit": "frames/s", "vs_baseline": 0.0,
                    "error": {"initialized": False, "lost_at": -1,
                              "n_keyframes": 0, "valid_timed": 0}}


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]])
def test_cuda_without_a_card_raises(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rendered = []
    monkeypatch.setattr(bench, "figures",
                        lambda *a, **kw: rendered.append(a) or [])
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench.main(argv)
    assert not rendered
