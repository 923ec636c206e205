"""The benchmark harness on the CPU, at reduced sizes, through the port's
plain versions: each cell runs and reports its five keys, the window's
arithmetic, discovery by name, the import checks, the reference against
the port's plain versions, and the output check failing on planted faults
and on the lower-precision control.

    python -m pytest slambench/tests -q

Tests marked ``cuda`` need the card and skip without one.
"""
from __future__ import annotations

import ast
import functools
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from slambench import generator, run, spec, window, worlds
from slambench.reference import frontend as ref_frontend
from slambench.reference import pose as ref_pose

HERE = spec.HERE
CELLS = ("tum_rgbd.revisit", "euroc_stereo.revisit")
# a cell whose files are kept for a later benchmark change but which
# BENCHMARK.json does not list (its window spreads too widely): it drives
# insertion, maintenance and K4, so the BA numbers and K4's fault run here
DRIVE = {"name": "kitti_stereo.drive", "config": "kitti_stereo",
         "traffic": "drive", "chips": 1}
# each cell cut to a size a CPU test run holds: the same camera at half
# resolution, half the features, a 16-slot map, a short warm-up and window
SMALL = {
    "tum_rgbd.revisit": {
        "config": {"Camera.fx": 258.653204, "Camera.fy": 258.2346075,
                   "Camera.cx": 159.32152, "Camera.cy": 127.6569945,
                   "Camera.width": 320, "Camera.height": 240,
                   "ORBextractor.nFeatures": 500, "Init.minFeatures": 150,
                   "map": {"k_max": 16, "n_feat": 500, "l_max": 4096,
                           "d_max": 12}},
        "traffic": {"warmup_frames": 31, "window_frames_max": 14,
                    "trace_frames": 3, "sample_span": 10, "samples": 3,
                    "rpe_step": 5}},
    "euroc_stereo.revisit": {
        "config": {"Camera.fx": 217.60234798572995,
                   "Camera.fy": 217.60234798572995,
                   "Camera.cx": 183.7258605957031,
                   "Camera.cy": 126.10042572021484,
                   "Camera.width": 376, "Camera.height": 240,
                   "Camera.bf": 23.953196922119505,
                   "ORBextractor.nFeatures": 600, "Init.minFeatures": 150,
                   "map": {"k_max": 16, "n_feat": 600, "l_max": 4096,
                           "d_max": 12}},
        "traffic": {"warmup_frames": 31, "window_frames_max": 14,
                    "trace_frames": 3, "sample_span": 10, "samples": 3,
                    "rpe_step": 5}},
    "kitti_stereo.drive": {
        "config": {"Camera.fx": 359.428, "Camera.fy": 359.428,
                   "Camera.cx": 303.5964, "Camera.cy": 92.60785,
                   "Camera.width": 620, "Camera.height": 188,
                   "Camera.bf": 193.0724, "ORBextractor.nFeatures": 1000,
                   "Init.minFeatures": 150,
                   "map": {"k_max": 16, "n_feat": 1000, "l_max": 8192,
                           "d_max": 12}, "frame_spacing_m": 0.05},
        "traffic": {"warmup_frames": 25, "window_frames_max": 14,
                    "trace_frames": 3, "sample_span": 10, "samples": 3,
                    "rpe_step": 5}},
}
SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def workload(bench: dict, name: str) -> dict:
    return DRIVE if name == DRIVE["name"] else spec.workload(bench, name)


def small_run(cell_name: str, after_setup=None, trace=False, **kw) -> dict:
    bench = spec.benchmark()
    return run.run_cell(bench, workload(bench, cell_name), SEED, 1e9,
                        trace, "cpu", after_setup=after_setup,
                        overrides=SMALL[cell_name], log=lambda s: None, **kw)


@pytest.mark.parametrize("cell", CELLS + (DRIVE["name"],))
def test_cell_runs_at_reduced_size(cell):
    res = small_run(cell, trace=cell == "tum_rgbd.revisit")
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    assert list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["attempted"] == SMALL[cell]["traffic"]["window_frames_max"]
    assert res["failed"] == 0
    limits = spec.limits(cell)
    assert set(res["checks"]) == set(limits)
    if cell == "tum_rgbd.revisit":  # traced: the per-layer metrics
        assert "frame_ms_p95" in res["metrics"]
        assert "keyframe_rate" in res["metrics"]
        assert "frames_per_s" not in res["metrics"]
    else:
        assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    # on the CPU the program runs the same plain versions the reference
    # copies: the front end and the pose agree exactly
    assert res["checks"]["orb_mismatch_pct"]["value"] == 0.0
    assert res["checks"]["search_mismatch_pct"]["value"] == 0.0
    assert res["checks"]["pose_gap_mm"]["value"] == 0.0
    searched = {kind for _, kind, *_ in res["samples"]["search_detail"]}
    assert searched == {"motion_model", "brute", "local_points"}


def test_window_rate_is_all_frames_over_all_time():
    stamps = np.arange(1, 101) * 10.0  # 100 frames, 10 ms each
    assert window.frames_per_s(100, 1000.0) == pytest.approx(100.0)
    assert window.p95(window.intervals_ms(0.0, stamps)) == pytest.approx(10)
    stalled = stamps.copy()
    for k in range(0, 100, 10):  # a 200 ms stall in one frame of ten
        stalled[k:] += 200.0
    iv = window.intervals_ms(0.0, stalled)
    assert window.frames_per_s(100, stalled[-1]) == pytest.approx(
        100 * 1000.0 / 3000.0)
    assert window.p95(iv) == pytest.approx(210.0)
    with pytest.raises(ValueError):
        window.frames_per_s(0, 10.0)


def test_new_parts_are_found_by_name(tmp_path):
    copy = tmp_path / "slambench"
    shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = dict(spec.config("tum_rgbd"), name="throwaway_cfg")
    (copy / "configs" / "throwaway_cfg.json").write_text(json.dumps(cfg))
    (copy / "traffic" / "throwaway_mix.json").write_text(json.dumps(
        dict(spec.traffic("revisit"), frames_per_lap=30)))
    (copy / "limits" / "throwaway_cfg.throwaway_mix.json").write_text(
        json.dumps({"rpe_mm": 1.0}))
    (copy / "metrics" / "throwaway_metric.py").write_text(
        "def read(run):\n    return 2.0 * run.frames\n")
    here = str(copy)
    assert spec.config("throwaway_cfg", here)["name"] == "throwaway_cfg"
    assert spec.traffic("throwaway_mix", here)["frames_per_lap"] == 30
    assert spec.limits("throwaway_cfg.throwaway_mix", here) == {"rpe_mm": 1}
    assert spec.reader("throwaway_metric", here)(
        types.SimpleNamespace(frames=3)) == 6.0
    # a new kind of world and path, and a sensor no cell uses yet
    (copy / "scenes" / "throwaway_wall.py").write_text(
        "import numpy as np\n"
        "from slambench import worlds\n\n\n"
        "def build(traffic, cfg, rng):\n"
        "    wall = worlds._Plane([0, 0, 2.0], [1, 0, 0], [0, 1, 0], 3.0,"
        " 2.0, np.random.RandomState(traffic['world_seed']))\n"
        "    eye = np.eye(3, dtype=np.float32)\n"
        "    poses = [(eye, np.array([-0.01 * k, 0, 0], np.float32))\n"
        "             for k in range(traffic['frames'])]\n"
        "    return [wall], poses, False\n")
    wall_mix = {"scene": "throwaway_wall", "world_seed": 3, "frames": 4,
                "warmup_frames": 2, "window_frames_max": 1,
                "trace_frames": 1, "tracker": {"localization_only": True}}
    (copy / "traffic" / "throwaway_wall.json").write_text(json.dumps(
        wall_mix))
    mono = dict(cfg, sensor="mono", **{"Camera.width": 64,
                                       "Camera.height": 48,
                                       "Camera.cx": 32.0, "Camera.cy": 24.0})
    seq = generator.build(spec.traffic("throwaway_wall", here), mono, 5,
                          "cpu", here)
    assert seq.n_stored == 4 and not seq.cycle
    (img,) = seq.frame(3)
    assert img.shape == (48, 64) and img.dtype == np.uint8 and img.std() > 0
    assert seq.pose(3)[1][0] == pytest.approx(-0.03)
    assert run.tracker_options(mono, wall_mix) == {
        "loop_closing": True, "localization_only": True}
    bench = spec.benchmark()
    bench["workloads"].append({"name": "throwaway_cfg.throwaway_mix",
                               "config": "throwaway_cfg",
                               "traffic": "throwaway_mix", "chips": 1})
    bench["per_layer"].append({"name": "throwaway_metric", "unit": "x",
                               "workloads": ["throwaway_cfg.throwaway_mix"]})
    names = [m["name"] for m in spec.metrics_of(
        bench, "throwaway_cfg.throwaway_mix", "per_layer")]
    assert "throwaway_metric" in names and "sad_roofline" not in names
    assert "throwaway_metric" not in [m["name"] for m in spec.metrics_of(
        bench, "tum_rgbd.revisit", "per_layer")]


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _py_files(folder: str):
    for d, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_and_a_reference_of_its_own():
    for path in _py_files(HERE):
        assert not _imports(path) & {"jax", "jaxlib", "flax",
                                     "orb_slam2_with_comment_tpu"}, path
    for path in _py_files(os.path.join(HERE, "reference")):
        assert run.PROGRAM not in _imports(path), path
    saved = dict(sys.modules)
    try:
        sys.modules["orb_slam2_with_comment_tpu"] = types.ModuleType("x")
        sys.modules["jax.numpy"] = types.ModuleType("y")
        found = run.forbidden_modules()
        assert "orb_slam2_with_comment_tpu" in found
        assert "jax.numpy" in found
        assert not [n for n in found if n.startswith(run.PROGRAM)]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_no_result_without_the_program(tmp_path):
    """In a folder holding only BENCHMARK.json and the benchmark's own
    files a run fails and prints no result (here it also has no card)."""
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "slambench/run.py", "--workload", CELLS[0],
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_reference_equals_the_ports_plain_versions():
    from orb_slam2_with_comment_tpu_torch.frontend.extractor import (
        OrbExtractor)
    from orb_slam2_with_comment_tpu_torch.optim import pose_opt
    from orb_slam2_with_comment_tpu_torch.optim.residuals import CamParams
    cam = {"fx": 359.428, "fy": 359.428, "cx": 303.5964, "cy": 92.60785,
           "width": 620, "height": 188}
    street = worlds.StreetCanyon(11, range(3), 30.0)
    poses = street.poses(1, 0.22)
    right = [(R, t - np.array([0.5372, 0, 0], np.float32)) for R, t in poses]
    left, _ = worlds.render_frames(street.planes, poses, cam, "cpu", False)
    rimg, _ = worlds.render_frames(street.planes, right, cam, "cpu", False)
    ext = OrbExtractor(1000)
    fl, sd = ext.stereo(torch.as_tensor(left[0]), torch.as_tensor(rimg[0]),
                        193.0724, cam["fx"])
    gl, pl = ref_frontend.extract(torch.as_tensor(left[0]), 1000)
    gr, pr = ref_frontend.extract(torch.as_tensor(rimg[0]), 1000)
    for a, b in zip((fl.xy, fl.octave, fl.angle, fl.desc, fl.valid), gl):
        assert torch.equal(a, b)
    ur, depth = ref_frontend.stereo_depth(gl, gr, pl, pr, 1000, 193.0724,
                                          cam["fx"])
    assert torch.equal(ur, sd.u_right) and torch.equal(depth, sd.depth)
    assert int((depth > 0).sum()) > 50
    from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
        pose_problem)
    p = {k: torch.as_tensor(v) for k, v in pose_problem("outliers", 3).items()}
    c = (500.0, 500.0, 320.0, 240.0, 40.0)
    want = pose_opt.optimize_pose_plain(CamParams.of(*c), p["R0"], p["t0"],
                                        p["Xw"], p["obs_uvr"],
                                        p["inv_sigma2"], p["valid"])
    R, t, inl = ref_pose.optimize_pose(c, p["R0"], p["t0"], p["Xw"],
                                       p["obs_uvr"], p["inv_sigma2"],
                                       p["valid"])
    assert torch.equal(R, want.R) and torch.equal(t, want.t)
    assert torch.equal(inl, want.inliers)


def _drop_half(tracker):
    """Half of each frame's keypoints left out where the front end makes
    them."""
    step = tracker._step
    ext = step.extractor
    inner = ext._extract_from_pyramid

    def half(pyr, flat=None):
        f = inner(pyr, flat)
        keep = torch.arange(f.valid.shape[0]) % 2 == 0
        return f._replace(valid=f.valid & keep.to(f.valid.device))

    ext._extract_from_pyramid = half


def _state_unchanged(tracker):
    """The tracking step returns its state unchanged."""
    tracker._step.do_track = lambda s, feats, d: s


def _pose_moved(tracker):
    """The pose solve's answer moved by 2 cm where it is produced."""
    from orb_slam2_with_comment_tpu_torch.optim import pose_opt
    inner = pose_opt.optimize_pose

    def moved(*args, **kwargs):
        r = inner(*args, **kwargs)
        return r._replace(t=r.t + 0.02)

    pose_opt.optimize_pose = moved


def _desc_flipped(tracker):
    """One descriptor bit of every keypoint flipped where it is made."""
    ext = tracker._step.extractor
    inner = ext._extract_from_pyramid

    def flipped(pyr, flat=None):
        f = inner(pyr, flat)
        return f._replace(desc=f.desc ^ 1)

    ext._extract_from_pyramid = flipped


def ba_unchanged(monkeypatch):
    """K4 returns the map's state unchanged: the problem's poses and points
    as its answer."""
    from orb_slam2_with_comment_tpu_torch.optim import ba
    inner = ba.ba_solve

    @functools.wraps(inner)
    def unchanged(cam, prob, *args, **kwargs):
        r = inner(cam, prob, *args, **kwargs)
        return r._replace(R=prob.R.clone(), t=prob.t.clone(),
                          X=prob.X.clone())

    monkeypatch.setattr(ba, "ba_solve", unchanged)


def wrong_neighbours(monkeypatch):
    """The motion-model projection search answers each matched landmark
    with the feature after its best one."""
    from orb_slam2_with_comment_tpu_torch.matching import search
    inner = search.search_by_projection_frame

    @functools.wraps(inner)
    def shifted(*args, **kwargs):
        idx, best, matched = inner(*args, **kwargs)
        n = args[6].xy.shape[0]
        return torch.where(matched, (idx + 1) % n, idx), best, matched

    monkeypatch.setattr(search, "search_by_projection_frame", shifted)


@pytest.mark.parametrize("fault,fails,cell", [
    (_drop_half, "orb_mismatch_pct", "tum_rgbd.revisit"),
    (_state_unchanged, "pose_gap_mm", "tum_rgbd.revisit"),
    (_pose_moved, "pose_gap_mm", "tum_rgbd.revisit"),
    (_desc_flipped, "orb_mismatch_pct", "tum_rgbd.revisit"),
    (wrong_neighbours, "search_mismatch_pct", "tum_rgbd.revisit"),
    (ba_unchanged, "ba_point_gap_mm", "kitti_stereo.drive")])
def test_planted_faults_are_not_correct(fault, fails, cell, monkeypatch):
    """Each fault planted where the timed path produces its answer, under
    the output check's capture: ``correct`` comes out false, and the number
    named fails its limit."""
    from orb_slam2_with_comment_tpu_torch.optim import pose_opt
    saved = pose_opt.optimize_pose
    try:
        if fault in (ba_unchanged, wrong_neighbours):
            fault(monkeypatch)
            res = small_run(cell)
        else:
            res = small_run(cell, after_setup=fault)
    finally:
        pose_opt.optimize_pose = saved
    assert not res["correct"]
    got = res["checks"][fails]
    assert got["value"] is None or got["value"] > got["limit"]


def test_lower_precision_control_is_not_correct():
    res = small_run("kitti_stereo.drive", control_dt=torch.bfloat16)
    assert res["correct"]
    ctl = res["control"]
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in ctl.values()), ctl


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303))
def test_control_fails_on_the_card_at_the_cells_size(card, cell, seed,
                                                     capsys):
    """The reference in bfloat16 in the program's place, at the cell's own
    size and load (a 4 s window): it fails one of the cell's numbers, and
    the program passes them. Prints both readings."""
    bench = spec.benchmark()
    res = run.run_cell(bench, spec.workload(bench, cell), seed, 4.0, False,
                       "cuda", control_dt=torch.bfloat16, log=lambda s: None)
    with capsys.disabled():
        print(json.dumps({"cell": cell, "seed": seed,
                          "program": res["checks"],
                          "control": res["control"]}))
    assert res["correct"], res["checks"]
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in res["control"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", (2 ** 31 + 404, 2 ** 31 + 505, 2 ** 31 + 606))
def test_ba_unchanged_fails_on_the_card(card, seed, monkeypatch, capsys):
    """K4 returning its input unchanged, at the drive's own size and load (a
    4 s window): the BA numbers fail their limits. Prints the readings."""
    ba_unchanged(monkeypatch)
    bench = spec.benchmark()
    res = run.run_cell(bench, DRIVE, seed, 4.0, False, "cuda",
                       log=lambda s: None)
    with capsys.disabled():
        print(json.dumps({"seed": seed, "ba_unchanged": res["checks"]}))
    assert not res["correct"]
    assert any(res["checks"][k]["value"] is None
               or res["checks"][k]["value"] > res["checks"][k]["limit"]
               for k in ("ba_pose_gap_mm", "ba_point_gap_mm"))


def test_launch_check_and_sad_count():
    from slambench import tracing
    t = tracing.Trace(frames=2, window_s=1.0, busy_s=0.1, device_ops=9,
                      host_waits=0, kernel_s={"orb": 1e-4},
                      kernel_launches={"orb": 6, "pose_lm": 2})
    tracing.check_launches(t, {"orb": 6, "pose_lm": 2, "ba": 0})
    with pytest.raises(RuntimeError, match="pose_lm"):  # a kernel renamed
        tracing.check_launches(t, {"orb": 6, "pose_lm": 3})
    kept = []
    mod = types.SimpleNamespace(stereo_depth=lambda *a, **k: a[5])
    with tracing.count_sad_keypoints(mod, kept):
        mod.stereo_depth(0, 0, 0, 0, 0, torch.tensor([10, 80, 74, 75]))
    assert tracing.sad_keypoints(kept, 75) == 2


def test_trace_reduction_on_a_planted_trace():
    from slambench import tracing
    span = {"ph": "X", "cat": "user_annotation"}
    events = [
        dict(span, name=tracing.STRETCH_SPAN, ts=0, dur=100),
        dict(span, name=tracing.FRAME_SPAN, ts=0, dur=50),
        dict(span, name="do_track", ts=5, dur=40),
        dict(span, name="track_local_map", ts=10, dur=10),
        dict(span, name=tracing.FRAME_SPAN, ts=50, dur=50),
        {"ph": "X", "cat": "kernel", "name": "void orb_describe_kernel<false>",
         "ts": 22, "dur": 4},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 60, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 30, "dur": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 31, "dur": 1}]
    t = tracing.summarize(events, 2)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(14e-6)
    assert (t.device_ops, t.host_waits) == (2, 1)
    assert t.kernel_s == {"orb": pytest.approx(4e-6)}
    idle = dict(t.idle_by_span)
    assert idle["track_local_map"] == pytest.approx(22e-6)
    assert idle["do_track"] == pytest.approx(34e-6)
    assert idle[tracing.FRAME_SPAN] == pytest.approx(30e-6)
