"""The port's spans and counted blocking transfers
(orb_slam2_with_comment_tpu_torch/spans.py) on the CPU, at the suite's
small size: 320x240, 500 features, MapConfig(k_max=8, n_feat=500,
l_max=3000, d_max=8), loop closing on, 12 orbit frames of the RGB-D and
the stereo AutoTracker (initialization, two inserts and a whole
maintenance cycle with its loop detection).

Each sensor runs twice, tracing off and on: the trajectory and the
statistics agree bit for bit, the store stays empty with tracing off, and
with tracing on each frame has one ``frame`` root that holds every other
span, the layers' self times sum to the root's duration, and each tracked
frame's blocking transfers are the expected sites. Two more frames run
under torch.profiler: the store then holds those frames alone and the
spans are profiler ranges. The benchmark's six readers read a filled
store and stop the run on a frame-count mismatch.

The card test (marked ``cuda``; it skips here) tracks 60 frames of each
sensor under torch.cuda's sync debug mode "error", so that every
synchronizing call outside the counted helper raises, then checks the
counted transfers against the profiler's waits inside the frame spans:

    python -m pytest --noconftest -q -m cuda tests/test_torch_spans.py
"""
import json
import os
import tempfile
import types

import numpy as np
import pytest
import torch

from orb_slam2_with_comment_tpu_torch import spans
from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig
from orb_slam2_with_comment_tpu_torch.pipeline.auto import (
    AutoTracker, AutoTrackerConfig)
from orb_slam2_with_comment_tpu_torch.pipeline.tracking import TrackerConfig
from slambench import spec, tracing

torch.set_num_threads(2)

N = 12
CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
BF = 20.0
KW = dict(CAM, bf=BF, n_features=500, min_init_features=100, fps=30)
MAP = dict(k_max=8, n_feat=500, l_max=3000, d_max=8)
SENSORS = ("rgbd", "stereo")
# the spans at the harness's boundaries (slambench/tracing.py wrap_layers)
# that every tracked frame opens
TRACKED = {"frame", "upload", "frontend", "frontend.pyramid",
           "frontend.extract", "do_track", "track_frame_core",
           "_match_motion_model", "_match_reference_kf",
           "_pose_optimize_from_matches", "local_landmark_mask",
           "track_local_map", "search.mask", "search.match",
           "do_track.decide", "write_traj"}
SENSOR_SPANS = {"rgbd": {"frontend.depth"}, "stereo": {"stereo.match"}}
# a tracked frame's blocking transfers by site, and those its maintenance
# adds ("consts.on_device" is a cache miss, on a table's first use)
TRACKED_SITES = {"do_track.n_kf": 1, "do_track.stats": 1,
                 "do_track.live_kf": 1, "do_track.stats_row": 1,
                 "write_traj.ref": 1, "write_traj.valid": 1}
INIT_SITES = {"do_initialize.features": 1, "_stats8.row": 1,
              "write_traj.ref": 1, "write_traj.valid": 1}
SENSOR_SITES = {"rgbd": {}, "stereo": {"association_mask.scales": 1}}
MAINTENANCE_SITES = {
    "_insert": {"_insert.n_lm": 1, "_insert.n_kf": 1, "_insert.slot": 1},
    "ph_fuse_in": {"ph_fuse_in.neighbors": 1},
    "ph_ba2": {"cull_keyframes.candidates": 1},
    "ph_loop": {"detect.accepted": 1}}
READERS = {"readbacks_per_frame": None, "frontend_host_ms": "front end",
           "stereo_host_ms": "stereo front end",
           "search_host_ms": "matching", "pose_host_ms": "pose",
           "loop_host_ms": spans.HOST_LOOP}


def _u8(img):
    return np.clip(img, 0, 255).astype(np.uint8)


def _frames(sensor, n, n_poses=None):
    world = SyntheticWorld(seed=1)
    out = []
    for R, t in orbit_trajectory(n_poses or n)[:n]:
        img, depth = world.render(R, t, **CAM)
        if sensor == "rgbd":
            out.append((_u8(img),
                        np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)))
        else:
            right = world.render(R, t - np.float32([BF / CAM["fx"], 0, 0]),
                                 **CAM)[0]
            out.append((_u8(img), _u8(right)))
    return out


def _tracker(sensor, device):
    kw = dict(KW, depth_factor=1.0 / 5000.0) if sensor == "rgbd" else dict(
        KW, sensor="stereo")
    tr = AutoTracker(TrackerConfig(map_cfg=MapConfig(**MAP), **kw),
                     AutoTrackerConfig(loop_closing=True), device=device)
    return tr, getattr(tr, "process_" + sensor)


def _reset():
    spans.disable()
    spans.FRAMES.clear()


@pytest.fixture(scope="module")
def runs():
    out = {}
    _reset()
    try:
        for sensor in SENSORS:
            frames = _frames(sensor, N + 2, n_poses=30)
            _reset()
            tr, process = _tracker(sensor, "cpu")
            for f in frames[:N]:
                process(*f)
            out[sensor, "off"] = tr.finalize()
            out[sensor, "off store"] = len(spans.FRAMES)
            tr, process = _tracker(sensor, "cpu")
            spans.enable()
            for f in frames[:N]:
                process(*f)
            spans.disable()
            out[sensor, "on"] = tr.finalize()
            out[sensor, "records"] = list(spans.FRAMES)
            acts = [torch.profiler.ProfilerActivity.CPU]
            with torch.profiler.profile(activities=acts) as prof:
                for f in frames[N:]:
                    process(*f)
            out[sensor, "profiled"] = list(spans.FRAMES)
            out[sensor, "events"] = {e.name for e in prof.events()}
            process(*frames[-1])  # tracing off again: the store is kept
            out[sensor, "kept"] = list(spans.FRAMES)
    finally:
        _reset()
    return out


@pytest.mark.parametrize("sensor", SENSORS)
def test_trajectory_is_bit_identical_with_tracing_on_and_off(runs, sensor):
    off, on = runs[sensor, "off"], runs[sensor, "on"]
    for k in ("R", "t", "Rcr", "tcr", "ref_kf", "valid", "stats"):
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)
    assert off["valid"].all() and off["n_keyframes"] >= 2
    assert off["stats"][:, 6].sum() >= 2  # inserts past initialization
    assert on["n_keyframes"] == off["n_keyframes"]


@pytest.mark.parametrize("sensor", SENSORS)
def test_store_stays_empty_with_tracing_off(runs, sensor):
    assert runs[sensor, "off store"] == 0


@pytest.mark.parametrize("sensor", SENSORS)
def test_one_root_per_frame_holding_every_span(runs, sensor):
    recs = runs[sensor, "records"]
    assert [r.index for r in recs] == list(range(N))
    for r in recs:
        assert not r.profiled
        root = r.spans[0]
        assert root.name == "frame" and root.parent == -1
        assert sum(s.parent == -1 for s in r.spans) == 1
        for i, s in enumerate(r.spans[1:], 1):
            p = r.spans[s.parent]
            assert 0 <= s.parent < i and s.frame == r.index
            assert p.start <= s.start <= s.end <= p.end
        names = {s.name for s in r.spans}
        if r.index > 0:
            assert TRACKED | SENSOR_SPANS[sensor] <= names
    names = [s.name for r in recs[1:] for s in r.spans]
    # two motion-model windows a frame, each with its mask and match halves
    assert names.count("_match_motion_model") == 2 * (N - 1)
    assert {"_insert", "ph_fuse_in", "ph_ba2", "ph_loop"} <= set(names)


@pytest.mark.parametrize("sensor", SENSORS)
def test_layer_self_times_sum_to_the_root(runs, sensor):
    for r in runs[sensor, "records"]:
        layers = spans.layer_ns(r)
        assert sum(layers.values()) == r.duration_ns > 0
        assert min(spans.self_ns(r)) >= 0
        assert set(layers) <= set(spans.LAYERS.values())
        if r.index > 0:
            assert {"front end", "matching", "pose",
                    spans.HOST_LOOP} <= set(layers)
        assert ("stereo front end" in layers) == (sensor == "stereo")


def _expected_sites(sensor, rec):
    names = {s.name for s in rec.spans}
    want = dict(TRACKED_SITES if "do_track" in names else INIT_SITES)
    want.update(SENSOR_SITES[sensor])
    for phase, sites in MAINTENANCE_SITES.items():
        if phase in names:
            want.update(sites)
    return want


@pytest.mark.parametrize("sensor", SENSORS)
def test_readback_sites_of_each_frame(runs, sensor):
    recs = runs[sensor, "records"]
    for r in recs:
        got = {k: v for k, v in r.transfers.items()
               if k != "consts.on_device"}
        assert got == _expected_sites(sensor, r), r.index
    plain = [r for r in recs[1:]
             if not {s.name for s in r.spans} & set(MAINTENANCE_SITES)]
    assert plain, "no tracked frame without maintenance"
    for r in plain:
        assert sum(r.transfers.values()) == 6 + (sensor == "stereo")


@pytest.mark.parametrize("sensor", SENSORS)
def test_spans_are_profiler_ranges(runs, sensor):
    recs = runs[sensor, "profiled"]
    # the profiler turned tracing on: the store holds its frames alone
    assert [r.index for r in recs] == list(range(N, N + 2))
    assert all(r.profiled for r in recs)
    want = TRACKED | SENSOR_SPANS[sensor]
    assert want <= runs[sensor, "events"]
    assert runs[sensor, "kept"] == recs


def _frame(index, *tree):
    """A frame record of the named spans, each (name, parent position,
    start, end) in ns."""
    rec = spans.FrameRecord(index, True)
    for name, parent, start, end in tree:
        s = spans.SpanRecord(name, start, parent, index)
        s.end = end
        rec.spans.append(s)
    return rec


def _filled_store(n):
    spans.FRAMES.clear()
    for i in range(n):
        rec = _frame(i, ("frame", -1, 0, 10_000_000),
                     ("upload", 0, 0, 500_000),
                     ("frontend", 0, 500_000, 3_000_000),
                     ("stereo.match", 2, 1_000_000, 2_000_000),
                     ("do_track", 0, 3_000_000, 10_000_000),
                     ("_match_motion_model", 4, 3_000_000, 6_000_000),
                     ("search.mask", 5, 3_000_000, 5_000_000),
                     ("_pose_optimize_from_matches", 4, 6_000_000,
                      7_000_000))
        rec.transfers = {"do_track.stats": 1, "write_traj.ref": 1,
                         "write_traj.valid": 1}
        spans.FRAMES.append(rec)


# ms a frame each layer of _filled_store holds (self times)
FILLED = {"front end": 1.5, "stereo front end": 1.0, "matching": 3.0,
          "pose": 1.0, spans.HOST_LOOP: 3.5}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_a_filled_store(metric):
    read = spec.reader(metric)
    _filled_store(4)
    try:
        got = read(types.SimpleNamespace(trace=types.SimpleNamespace(
            frames=4)))
        none = read(types.SimpleNamespace(trace=None))
    finally:
        _reset()
    want = 3.0 if READERS[metric] is None else FILLED[READERS[metric]]
    assert got == pytest.approx(want) and none is None
    assert sum(FILLED.values()) == 10.0


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_stops_the_run_on_a_frame_count_mismatch(metric):
    read = spec.reader(metric)
    _filled_store(3)
    try:
        with pytest.raises(RuntimeError, match="profiled frames"):
            read(types.SimpleNamespace(trace=types.SimpleNamespace(
                frames=24)))
    finally:
        _reset()


# where each new span opens: its parent span
NESTED = {"ph_loop.covisibility": "ph_loop", "ph_loop.score": "ph_loop",
          "_insert.bow": "_insert"}
# the table-wide passes every tracked frame runs, and the bytes each
# reads at the suite's map (K 8, N 500, L 3000, D 8)
K_, N_, L_, D_ = (MAP[k] for k in ("k_max", "n_feat", "l_max", "d_max"))
TRACKED_TABLES = {
    "local_landmark_mask": L_ * D_ * 4 + L_,
    "covisibility_weights": N_ * 4 + 2 * N_ * D_ * 4 + K_,
    "track_local_map": 2 * L_ + 2 * L_ * 4,
    "landmark_obs_count": L_ * D_ * 4}


@pytest.mark.parametrize("sensor", SENSORS)
def test_new_spans_open_inside_their_phases(runs, sensor):
    seen = set()
    for r in runs[sensor, "records"]:
        layers = spans.layers_of(r)
        for s, layer in zip(r.spans, layers):
            if s.name in NESTED:
                seen.add(s.name)
                assert r.spans[s.parent].name == NESTED[s.name]
                assert layer == "maintenance"
    assert seen == set(NESTED)


@pytest.mark.parametrize("sensor", SENSORS)
def test_table_bytes_of_each_frame(runs, sensor):
    """Each tracked frame counts its table-wide passes' reads from the
    tensors' shapes; maintenance adds its own sites; the counts leave the
    trajectory as it is (test_trajectory_is_bit_identical_...)."""
    sites = set()
    for r in runs[sensor, "records"][1:]:
        for site, n in TRACKED_TABLES.items():
            assert r.table_bytes[site] >= n, (r.index, site)
        assert r.table_bytes["local_landmark_mask"] == TRACKED_TABLES[
            "local_landmark_mask"]
        sites |= set(r.table_bytes)
    assert {"covisibility_matrix", "score_l1_sparse", "add_keyframe_bow",
            "merge_duplicate_landmarks", "local_bundle_adjustment",
            "rebuild_observations"} <= sites
    loop = [r for r in runs[sensor, "records"]
            if "ph_loop" in {s.name for s in r.spans}]
    assert loop and all(r.table_bytes["covisibility_matrix"] >= K_ * N_ * (
        4 + 1 + 2 * D_ * 4) for r in loop)


@pytest.mark.parametrize("sensor", SENSORS)
def test_maintenance_readers_on_a_traced_run(runs, sensor):
    recs = runs[sensor, "records"]
    spans.FRAMES[:] = recs
    for r in recs:
        r.profiled = True
    try:
        run = types.SimpleNamespace(trace=types.SimpleNamespace(
            frames=len(recs)))
        maint = spec.reader("maintenance_host_ms")(run)
        loop = spec.reader("loop_detect_host_ms")(run)
        mb = spec.reader("map_table_mb_per_frame")(run)
    finally:
        for r in recs:
            r.profiled = False
        _reset()
    want_maint = sum(spans.layer_ns(r).get("maintenance", 0)
                     for r in recs) / 1e6 / len(recs)
    want_loop = sum(s.duration_ns for r in recs for s in r.spans
                    if s.name == "ph_loop") / 1e6 / len(recs)
    want_mb = sum(sum(r.table_bytes.values()) for r in recs) / 1e6 / len(
        recs)
    assert maint == pytest.approx(want_maint) and maint > 0
    assert loop == pytest.approx(want_loop) and 0 < loop < maint
    assert mb == pytest.approx(want_mb) and mb > 0


def test_table_reader_without_the_counter_reads_nothing():
    """A program whose frame records have no ``table_bytes`` (an older
    commit) gives None."""
    _filled_store(2)
    try:
        got = spec.reader("map_table_mb_per_frame")(types.SimpleNamespace(
            trace=types.SimpleNamespace(frames=2)))
        old = [types.SimpleNamespace(profiled=True, spans=r.spans,
                                     transfers=r.transfers)
               for r in spans.FRAMES]
        spans.FRAMES[:] = old
        none = spec.reader("map_table_mb_per_frame")(types.SimpleNamespace(
            trace=types.SimpleNamespace(frames=2)))
    finally:
        _reset()
    assert got == 0.0 and none is None


def _tiny_frame(index, site="unit.site"):
    with spans.frame(index):
        with spans.span("outer"):
            value = spans.to_host(site, torch.tensor(3))
            row = spans.to_device(site, [1, 2], torch.int32, "cpu")
            spans.put(site, row, 0, 5)
    return value, row


def test_off_records_nothing_and_keeps_values():
    _reset()
    value, row = _tiny_frame(0)
    assert value == 3 and row.tolist() == [5, 2] and row.dtype == torch.int32
    spans.table_read("unit.table", row)
    assert spans.FRAMES == []


def test_table_read_counts_bytes_on_a_traced_frame_only():
    _reset()
    try:
        spans.enable()
        spans.table_read("unit.outside", torch.zeros(4))
        with spans.frame(0):
            spans.table_read("unit.table",
                             torch.zeros((3, 5), dtype=torch.int32),
                             torch.zeros(7, dtype=torch.bool))
            spans.table_read("unit.table",
                             torch.zeros(2, dtype=torch.float64))
        assert spans.FRAMES[0].table_bytes == {"unit.table": 60 + 7 + 16}
        assert spans.FRAMES[0].transfers == {}
    finally:
        _reset()


def test_enable_clears_and_disable_keeps_the_store():
    _reset()
    try:
        spans.enable()
        _tiny_frame(0)
        spans.enable()  # turning on again clears
        _tiny_frame(1)
        spans.disable()
        _tiny_frame(2)
        assert [r.index for r in spans.FRAMES] == [1]
        r = spans.FRAMES[0]
        assert [s.name for s in r.spans] == ["frame", "outer"]
        assert r.transfers == {"unit.site": 3} and not r.profiled
        assert r.table_bytes == {}
        # a transfer outside a frame is not counted
        spans.enable()
        spans.to_host("unit.outside", torch.tensor(1))
        assert spans.FRAMES == []
    finally:
        _reset()


def test_profiler_turns_tracing_on_and_clears_the_store():
    _reset()
    try:
        spans.enable()
        _tiny_frame(0)
        spans.disable()
        acts = [torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as prof:
            _tiny_frame(1)
        assert [r.index for r in spans.FRAMES] == [1]
        assert spans.FRAMES[0].profiled
        assert {"frame", "outer"} <= {e.name for e in prof.events()}
    finally:
        _reset()


def test_decorator_keeps_the_function():
    @spans.span("unit.decorated")
    def add(a, b=1):
        """Adds."""
        return a + b

    _reset()
    try:
        assert add(2) == 3 and add.__name__ == "add" and add.__doc__
        spans.enable()
        with spans.frame(7):
            assert add(2, b=5) == 7
        assert [s.name for s in spans.FRAMES[0].spans] == [
            "frame", "unit.decorated"]
        assert spans.FRAMES[0].spans[1].frame == 7
    finally:
        _reset()


@pytest.mark.cuda
@pytest.mark.parametrize("sensor", SENSORS)
def test_no_wait_outside_the_counted_helper_on_the_card(sensor):
    """60 frames from the start (initialization, inserts, maintenance and
    loop detection) under sync debug mode "error": only the counted
    helper may synchronize. Then 12 frames under torch.profiler: the
    counted transfers equal the profiler's waits inside the frame spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames = _frames(sensor, 72)
    tr, process = _tracker(sensor, "cuda")
    _reset()
    try:
        spans.enable()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for f in frames[:60]:
                process(*f)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        spans.disable()
        assert len(spans.FRAMES) == 60
        assert tr.finalize()["valid"][:60].all()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for f in frames[60:]:
                process(*f)
            torch.cuda.synchronize()
        counted = sum(sum(r.transfers.values()) for r in spans.FRAMES)
        assert len(spans.FRAMES) == 12
    finally:
        _reset()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
    roots = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == "frame"
             and e.get("cat") == "user_annotation"]
    waits = sum(1 for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("name") in tracing.WAIT_CALLS
                and any(a <= e["ts"] <= b for a, b in roots))
    assert len(roots) == 12
    assert waits == counted > 0
