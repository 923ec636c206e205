"""The match tail (matching/core.py ``match_tail``): everything a search does
after the fused best-two, K7 of csrc/hamming.cu on the card.

On the CPU: the plain version equals the chain it replaced (the distance
gate, the ratio test, the rotation histogram, the dedupe, and the
assignment into the frame's landmark map with set_last's last write) on
seeded random problems with forced ties, in each caller's mode; the
wrapper takes the plain version for CPU tensors and checks its arguments;
K7's launch counter is kept apart from K1's.

On the card (marked ``cuda``; they skip here): K7 against the plain version
in bits at the cells' shapes in every mode, through the global-scratch
instantiation above TAIL_SHARED targets, on the edge cases, and on every
problem 60 frames of the RGB-D and of the stereo AutoTracker give it,
with four K7 and four K1 launches in each tracked frame's tracking core.
The file imports neither jax nor the JAX package:

    python -m pytest --noconftest -q -m cuda tests/test_torch_match_tail.py
"""
import math
import os

import pytest
import torch

from orb_slam2_with_comment_tpu_torch.mapstate.map import set_last
from orb_slam2_with_comment_tpu_torch.matching import core
from orb_slam2_with_comment_tpu_torch.ops import hamming
from slambench import tracing

torch.set_num_threads(2)

BIG = core.BIG
# (name, match_tail's options) of each caller's mode
MODES = {
    "motion_model": dict(max_dist=100, angles=True, assign="fresh"),
    "reference_kf": dict(max_dist=50, ratio=0.7, angles=True,
                         assign="fresh"),
    "triangulation": dict(max_dist=50, ratio=0.6),
    "local_points": dict(max_dist=100, ratio=0.8, same_level=True,
                         assign="into"),
    "fuse": dict(max_dist=50),
    "no_dedupe": dict(max_dist=100, ratio=0.9, angles=True, dedupe=False,
                      assign="into"),
}


def problem(seed: int, q: int, n: int, *, hot: int | None = None,
            big_share: float = 0.1, max_dist: int = 100, ratio=None,
            angles=False, same_level=False, dedupe=True, assign=None):
    """A best-two result and a call's options, as match_tail's keyword
    arguments: distances drawn under 120 (many ties), targets from the first
    ``hot`` (collisions), rows without a candidate at (BIG, 0), angles from
    16 values (histogram ties) with a share of differences just under zero
    (bin 30, which is bin 0), and a frame_lm half -1."""
    g = torch.Generator().manual_seed(seed)

    def ints(lo, hi, size):
        return torch.randint(lo, hi, size, generator=g, dtype=torch.int32)

    hot = min(hot or n, n)
    best = ints(0, 120, (q,))
    second = (best + ints(0, 40, (q,)) * (torch.rand(q, generator=g) < 0.7)
              ).to(torch.int32)
    big = torch.rand(q, generator=g) < big_share
    best = torch.where(big, BIG, best)
    second = torch.where(big, BIG, second)
    idx = torch.where(big, 0, ints(0, hot, (q,)))
    if n > 1:
        idx2 = (idx + ints(1, n, (q,))) % n
        idx2 = torch.where(big, torch.where(idx == 0, 1, 0), idx2)
    else:
        idx2 = torch.zeros(q, dtype=torch.int32)
        second = torch.full((q,), BIG, dtype=torch.int32)
    kw = dict(best=best, idx=idx, second=second, idx2=idx2.to(torch.int32),
              n_targets=n, max_dist=max_dist, ratio=ratio, dedupe=dedupe)
    if same_level:
        kw["octave_t"] = ints(0, 8, (n,))
    if angles:
        step = 2 * math.pi / 16
        angle_t = (ints(0, 16, (n,)).float() * step - math.pi)
        angle_q = angle_t[idx.long()] + ints(0, 4, (q,)).float() * step
        near = torch.rand(q, generator=g) < 0.15
        angle_q = torch.where(near, angle_t[idx.long()] - 1e-3, angle_q)
        kw["angle_q"], kw["angle_t"] = angle_q, angle_t
    if assign is not None:
        kw["values"] = ints(-1, 5000, (q,))
        if assign == "into":
            kw["frame_lm"] = torch.where(torch.rand(n, generator=g) < 0.5,
                                         -1, ints(0, 5000, (n,)))
    return kw


def parent_chain(best, idx, second, idx2, n_targets, max_dist, ratio=None,
                 octave_t=None, angle_q=None, angle_t=None, dedupe=True,
                 values=None, frame_lm=None):
    """The chain match_tail replaced, as its callers wrote it:
    windowed_match's gate, ratio test, rotation check and dedupe,
    search_local_points' same-level ratio test, and pipeline/steps.py's
    _assign (the relocalizations' set_last into a fresh map is the same)."""
    matched = best <= max_dist
    if ratio is not None and octave_t is not None:
        same_level = octave_t[idx] == octave_t[idx2]
        matched &= torch.where(same_level,
                               core.ratio_ok(best, second, ratio), True)
    elif ratio is not None:
        matched &= core.ratio_ok(best, second, ratio)
    if angle_q is not None:
        matched = core.rotation_consistency(
            core.rotation_bins(angle_q, angle_t[idx]), matched)
    if dedupe:
        matched &= core.dedupe_matches(idx, best, matched, n_targets)
    if values is None:
        return idx, best, matched
    if frame_lm is None:
        frame_lm = torch.full((n_targets,), -1, dtype=torch.int32)
    safe = torch.where(matched, idx, 0)
    return idx, best, matched, set_last(frame_lm, safe, torch.where(
        matched, values, frame_lm[safe.long()]))


def call(fn, kw):
    """fn (match_tail or its plain version) on the keyword arguments kw,
    with a fresh ``out`` map where kw has values: (idx, best, matched),
    and the map written last where there is one."""
    kw = {k: v for k, v in kw.items() if k != "out"}
    if kw.get("values") is None:
        return tuple(fn(**kw))
    out = torch.empty(kw["n_targets"], dtype=torch.int32,
                      device=kw["best"].device)
    return tuple(fn(**kw, out=out)) + (out,)


def assert_bits(got, want, where=""):
    assert len(got) == len(want), where
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, where
        assert torch.equal(g.cpu(), w.cpu()), where


def fixed_problems():
    """The edge cases, each a (name, match_tail keyword arguments)."""
    out = []
    i32 = torch.int32

    def t(v):
        return torch.tensor(v, dtype=i32)

    # ties across queries for one target: the lowest query keeps it
    out.append(("ties for one target", dict(
        best=t([5, 3, 3, 7, 3]), idx=t([2, 2, 2, 2, 1]),
        second=t([50, 40, 40, 60, 40]), idx2=t([0, 0, 0, 0, 0]),
        n_targets=4, max_dist=50, values=t([10, 11, 12, 13, 14]))))
    # histogram ties and the 0.1 rule at equality: bin counts 20, 20, 2
    # (2 >= 0.1 * 20 in float32) and 1
    bins = [0] * 20 + [5] * 20 + [9] * 2 + [17]
    q = len(bins)
    aq = torch.tensor([b * 2 * math.pi / 30 for b in bins], dtype=torch.float32)
    out.append(("histogram ties, the 0.1 rule", dict(
        best=torch.full((q,), 10, dtype=i32), idx=torch.arange(q, dtype=i32),
        second=torch.full((q,), 90, dtype=i32), idx2=torch.zeros(q, dtype=i32),
        n_targets=q, max_dist=50, angle_q=aq, angle_t=torch.zeros(q))))
    # angle differences that round to bin 30 (all of these are bin 0)
    aq = torch.tensor([-1e-4, -2e-3, 2 * math.pi - 1e-4, 0.0, 1e-3, -1e-6],
                      dtype=torch.float32)
    out.append(("bin 30 is bin 0", dict(
        best=t([1, 2, 3, 4, 5, 6]), idx=t([0, 1, 2, 3, 4, 5]),
        second=t([99, 99, 99, 99, 99, 99]), idx2=t([1, 0, 0, 0, 0, 0]),
        n_targets=6, max_dist=50, angle_q=aq, angle_t=torch.zeros(6),
        values=t([0, 1, 2, 3, 4, 5]))))
    # every row without a candidate, and no matched query
    q = 300
    out.append(("all rows masked", dict(
        best=torch.full((q,), BIG, dtype=i32), idx=torch.zeros(q, dtype=i32),
        second=torch.full((q,), BIG, dtype=i32),
        idx2=torch.ones(q, dtype=i32), n_targets=50, max_dist=100,
        ratio=0.7, angle_q=torch.zeros(q), angle_t=torch.zeros(50),
        values=torch.arange(q, dtype=i32),
        frame_lm=torch.arange(50, dtype=i32))))
    out.append(("none under the gate", dict(
        best=t([60, 70, 80]), idx=t([0, 1, 2]), second=t([90, 90, 90]),
        idx2=t([1, 2, 0]), n_targets=3, max_dist=50, values=t([7, 8, 9]))))
    # one target
    out.append(("N = 1", dict(
        best=t([3, 3, BIG, 9]), idx=t([0, 0, 0, 0]),
        second=t([BIG, BIG, BIG, BIG]), idx2=t([0, 0, 0, 0]), n_targets=1,
        max_dist=50, ratio=0.8, octave_t=t([2]), values=t([4, 5, 6, 7]),
        frame_lm=t([-1]))))
    # slot 0 written by a match, then by later unmatched queries (its old
    # value back), and the other way round
    out.append(("slot 0, match then unmatched", dict(
        best=t([2, 80, 90]), idx=t([0, 3, 1]), second=t([60, 90, 95]),
        idx2=t([1, 0, 0]), n_targets=4, max_dist=50, values=t([41, 42, 43]),
        frame_lm=t([17, -1, 5, -1]))))
    out.append(("slot 0, unmatched then match", dict(
        best=t([80, 2]), idx=t([3, 0]), second=t([90, 60]), idx2=t([0, 1]),
        n_targets=4, max_dist=50, values=t([41, 42]),
        frame_lm=t([17, -1, 5, -1]))))
    # no query at all
    e = torch.zeros(0, dtype=i32)
    out.append(("Q = 0", dict(best=e, idx=e, second=e, idx2=e, n_targets=5,
                              max_dist=50, values=e,
                              frame_lm=t([1, 2, 3, 4, 5]))))
    return out


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_equals_the_chain_it_replaces(mode, seed):
    kw = problem(seed, 700, 300, hot=200, **MODES[mode])
    want = parent_chain(**kw)
    assert_bits(call(core.match_tail_plain, kw), want, mode)
    assert_bits(call(core.match_tail, kw), want, mode)
    assert int(want[2].sum()) >= 10, "too few matches to exercise the tail"


@pytest.mark.parametrize("case", range(9))
def test_plain_on_the_edge_cases(case):
    name, kw = fixed_problems()[case]
    assert_bits(call(core.match_tail, kw), parent_chain(**kw), name)


def test_plain_edge_cases_read_as_designed():
    """The cases above mean what they say: ties go to the lowest query,
    bins 0 and 5 tie at the top and bin 9 passes the 0.1 rule at
    equality, bin 30 is bin 0, slot 0 keeps the last writer's value."""
    cases = dict(fixed_problems())
    _, _, m, lm = call(core.match_tail, cases["ties for one target"])
    assert m.tolist() == [False, True, False, False, True]
    assert lm.tolist() == [-1, 14, 11, -1]
    _, _, m = call(core.match_tail, cases["histogram ties, the 0.1 rule"])
    assert m.tolist() == [True] * 42 + [False]
    _, _, m, _ = call(core.match_tail, cases["bin 30 is bin 0"])
    assert m.all()
    lm = call(core.match_tail, cases["slot 0, match then unmatched"])[3]
    assert lm.tolist() == [17, -1, 5, -1]
    lm = call(core.match_tail, cases["slot 0, unmatched then match"])[3]
    assert lm.tolist() == [42, -1, 5, -1]


def test_the_map_is_written_into_the_callers_buffer():
    """With values the tail returns (idx, dist, matched) alone and writes
    the new map into the caller's ``out``, whatever it held, leaving the
    map it read unchanged; out may be that map itself."""
    kw = problem(9, 500, 200, hot=100, **MODES["local_points"])
    want = parent_chain(**kw)[3]
    before = kw["frame_lm"].clone()
    out = torch.full((200,), 12345, dtype=torch.int32)
    found = core.match_tail(**kw, out=out)
    assert type(found) is tuple and len(found) == 3
    assert torch.equal(out, want)
    assert torch.equal(kw["frame_lm"], before)
    core.match_tail(**kw, out=kw["frame_lm"])
    assert torch.equal(kw["frame_lm"], want)


def test_windowed_match_assigns_as_the_chain_did():
    """windowed_match with values: K1's plain version, then the tail with
    the assignment, against the parent's windowed_match and _assign."""
    g = torch.Generator().manual_seed(3)
    dq = torch.randint(-2 ** 31, 2 ** 31, (300, 8), generator=g,
                       dtype=torch.int64).to(torch.int32)
    dt = dq[torch.randperm(300, generator=g)[:250]].clone()
    dt[:, 0] ^= torch.randint(0, 2 ** 8, (250,), generator=g,
                              dtype=torch.int32)
    mask = torch.rand(300, 250, generator=g) < 0.3
    angle_q = torch.rand(300, generator=g) * 2 * math.pi - math.pi
    angle_t = torch.rand(250, generator=g) * 2 * math.pi - math.pi
    values = torch.arange(300, dtype=torch.int32) * 3
    out = torch.empty(250, dtype=torch.int32)
    got = core.windowed_match(dq, dt, mask, 100, ratio=0.9, angle_q=angle_q,
                              angle_t=angle_t, values=values, out=out)
    best, idx, second, idx2 = hamming.masked_best_two_plain(dq, dt, mask)
    want = parent_chain(best, idx, second, idx2, 250, 100, 0.9,
                        angle_q=angle_q, angle_t=angle_t, values=values)
    assert_bits(tuple(got) + (out,), want)
    assert int(want[2].sum()) >= 10


def test_wrapper_takes_the_plain_version_on_the_cpu(monkeypatch):
    def no_kernel():
        raise AssertionError("the CPU path reached the kernel")

    monkeypatch.setattr(core, "_kernel_lib", no_kernel)
    before = dict(core.LAUNCHES)
    kw = problem(7, 64, 40, **MODES["local_points"])
    assert_bits(call(core.match_tail, kw), call(core.match_tail_plain, kw))
    assert core.LAUNCHES == before


def test_the_counter_is_apart_from_k1s():
    assert "match_tail" in core.LAUNCHES
    assert not set(core.LAUNCHES) & set(hamming.LAUNCHES)
    assert not set(core.VARIANT_LAUNCHES) & set(hamming.LAUNCHES)
    assert core.LAUNCHES is not hamming.LAUNCHES


def test_wrapper_checks_its_arguments():
    kw = problem(8, 16, 10, **MODES["reference_kf"])
    bad = [dict(best=kw["best"].long()), dict(idx=kw["idx"][:-1]),
           dict(angle_t=None), dict(octave_t=torch.zeros(10, dtype=torch.int32),
                                    ratio=None),
           dict(values=None, frame_lm=torch.zeros(10, dtype=torch.int32)),
           dict(values=kw["values"].float()), dict(n_targets=0),
           dict(out=None), dict(out=torch.zeros(9, dtype=torch.int32)),
           dict(out=torch.zeros(20, dtype=torch.int32)[::2])]
    for change in bad:
        args = dict(kw, out=torch.empty(10, dtype=torch.int32))
        args.update(change)
        with pytest.raises(ValueError):
            core.match_tail(**args)


def test_the_kernel_source_matches_the_wrapper():
    """The wrapper's constants are csrc/hamming.cu's, and K7's kernel name
    is none of the benchmark's kernel families (K1's launches are counted
    against the trace's hamming family)."""
    src = open(os.path.join(os.path.dirname(core.__file__), "..", "csrc",
                            "hamming.cu")).read()
    assert f"constexpr int kTailShared = {core.TAIL_SHARED};" in src
    assert f"constexpr int kHisto = {core.HISTO_LENGTH};" in src
    assert (f"kRatioNone = {core.RATIO_NONE}, kRatioAlways = "
            f"{core.RATIO_ALWAYS}, kRatioSameLevel = "
            f"{core.RATIO_SAME_LEVEL};") in src
    assert "match_tail_kernel(const TailArgs a)" in src
    for keys in tracing.KERNELS.values():
        assert not any(k in "match_tail_kernel" for k in keys)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def on(kw, dev):
    return {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in kw.items()}


def hold(kw, dev, where):
    """K7 on the card against the plain version on the CPU, in bits; one
    launch where there are queries."""
    before = core.LAUNCHES["match_tail"]
    got = call(core.match_tail, on(kw, dev))
    assert_bits(got, call(core.match_tail_plain, kw), where)
    assert core.LAUNCHES["match_tail"] - before == int(kw["best"].numel() > 0)


CARD_SHAPES = [
    ("motion_model", 1000, 1000), ("reference_kf", 1000, 1000),
    ("local_points", 4096, 1000), ("local_points", 4096, 1200),
    ("triangulation", 2000, 2000), ("fuse", 1000, 1000),
    ("no_dedupe", 4096, 1200)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,q,n", CARD_SHAPES)
def test_kernel_equals_plain_at_the_cells_shapes(dev, mode, q, n):
    for seed in range(4):
        for hot in (n, n // 8):
            kw = problem(seed, q, n, hot=hot, **MODES[mode])
            hold(kw, dev, f"{mode} [{q}x{n}] seed {seed} hot {hot}")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [core.TAIL_SHARED + 1, 5000, 20000])
def test_kernel_global_scratch_above_the_shared_tables(dev, n):
    before = core.VARIANT_LAUNCHES["match_tail_global"]
    for mode in ("local_points", "reference_kf", "no_dedupe", "fuse"):
        kw = problem(11, 4096, n, hot=n // 4, **MODES[mode])
        hold(kw, dev, f"{mode} [4096x{n}]")
    assert core.VARIANT_LAUNCHES["match_tail_global"] - before == 4


@pytest.mark.cuda
def test_kernel_on_the_edge_cases(dev):
    for name, kw in fixed_problems():
        hold(kw, dev, name)


@pytest.mark.cuda
def test_kernel_repeats_in_bits_and_reads_nothing_back(dev):
    kw = on(problem(5, 4096, 1000, hot=300, **MODES["local_points"]), dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = call(core.match_tail, kw)
        b = call(core.match_tail, kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert_bits(a, b)


@pytest.mark.cuda
def test_kernel_checks_devices(dev):
    kw = on(problem(6, 32, 20, **MODES["motion_model"]), dev)
    kw["values"] = kw["values"].cpu()
    with pytest.raises(ValueError):
        call(core.match_tail, kw)
    kw["values"] = kw["values"].to(dev)
    with pytest.raises(ValueError):
        core.match_tail(**kw, out=torch.empty(20, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("sensor", ["rgbd", "stereo"])
def test_kernel_on_60_frames_of_the_auto_tracker(dev, sensor, monkeypatch):
    """Every problem 60 frames of the AutoTracker (initialization, inserts,
    maintenance) give K7, held against the plain version in bits; each
    tracked frame's tracking core launches K1 four times, as before, and
    K7 four times; the stereo association launches K1 once a frame and
    K7 never."""
    from orb_slam2_with_comment_tpu_torch.frontend import stereo
    from orb_slam2_with_comment_tpu_torch.pipeline import steps
    from test_torch_spans import _frames, _tracker

    captured = []
    tail = core.match_tail

    def keep(*a, **kw):
        args = dict(zip(("best", "idx", "second", "idx2", "n_targets",
                         "max_dist", "ratio"), a), **kw)
        captured.append({k: v.cpu() if isinstance(v, torch.Tensor) else v
                         for k, v in args.items()})
        return tail(*a, **kw)

    per_call = {"track_frame_core": [], "match_stereo": []}

    def counted(name, fn):
        def run(*a, **kw):
            k1 = hamming.LAUNCHES["masked_best_two"]
            k7 = core.LAUNCHES["match_tail"]
            out = fn(*a, **kw)
            per_call[name].append((hamming.LAUNCHES["masked_best_two"] - k1,
                                   core.LAUNCHES["match_tail"] - k7))
            return out
        return run

    monkeypatch.setattr(core, "match_tail", keep)
    monkeypatch.setattr(steps, "track_frame_core",
                        counted("track_frame_core", steps.track_frame_core))
    monkeypatch.setattr(stereo, "match_stereo",
                        counted("match_stereo", stereo.match_stereo))
    frames = _frames(sensor, 60)
    tr, process = _tracker(sensor, "cuda")
    for f in frames:
        process(*f)
    out = tr.finalize()
    monkeypatch.undo()
    assert out["valid"][:60].all()
    tracked = per_call["track_frame_core"]
    assert len(tracked) == 59, len(tracked)
    assert set(tracked) == {(4, 4)}, tracked
    if sensor == "stereo":
        assert set(per_call["match_stereo"]) == {(1, 0)}
        assert len(per_call["match_stereo"]) == 60
    assert len(captured) >= 4 * 59
    for i, kw in enumerate(captured):
        hold(kw, dev, f"{sensor} call {i}")
