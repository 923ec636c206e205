"""The port's MultiSeqTracker on the CPU (a world of one, no process group):
B = 2 distinct SyntheticWorlds over 8 orbit frames at 320x240 with 500
features (tests/test_multi_seq.py's scenario at the port tests' reduced
size). Each sequence must equal the port's solo AutoTracker on its frames
exactly (the same step, extractor and draws: each sequence carries its own
generator) and meet the JAX test's gates: initialized, never lost, median
translation error < 0.02 m. stack_states / unstack_state round-trip every
tensor, host value and generator.
"""
import numpy as np
import pytest
import torch

from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig
from orb_slam2_with_comment_tpu_torch.parallel.multi_seq import (
    MultiSeqTracker, stack_states, unstack_state)
from orb_slam2_with_comment_tpu_torch.pipeline.auto import (
    AutoTracker, AutoTrackerConfig)
from orb_slam2_with_comment_tpu_torch.pipeline.tracking import TrackerConfig

torch.set_num_threads(2)

CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
B, N_FRAMES = 2, 8


def _cfg():
    return TrackerConfig(**CAM, n_features=500, min_init_features=100,
                         map_cfg=MapConfig(k_max=8, n_feat=500, l_max=4000,
                                           d_max=8),
                         fps=30, depth_factor=1.0 / 5000.0)


@pytest.fixture(scope="module")
def run():
    worlds = [SyntheticWorld(seed=s) for s in range(B)]
    poses = orbit_trajectory(n_frames=N_FRAMES)
    frames = []
    for R, t in poses:
        imgs, deps = [], []
        for w in worlds:
            img, d = w.render(R, t, **CAM)
            imgs.append(np.clip(img, 0, 255).astype(np.uint8))
            deps.append(np.clip(d * 5000.0, 0, 65535).astype(np.uint16))
        frames.append((np.stack(imgs), np.stack(deps)))
    auto_cfg = AutoTrackerConfig(loop_closing=False)
    mt = MultiSeqTracker(_cfg(), n_seq=B, auto_cfg=auto_cfg, device="cpu")
    for imgs, deps in frames:
        mt.process_rgbd(imgs, deps)
    solos = []
    for i in range(B):
        solo = AutoTracker(_cfg(), auto_cfg, device="cpu")
        for imgs, deps in frames:
            solo.process_rgbd(imgs[i], deps[i])
        solos.append(solo)
    return mt, mt.finalize(), solos, poses


def test_the_jax_tests_gates(run):
    _, outs, _, poses = run
    assert len(outs) == B
    for i, out in enumerate(outs):
        assert out["initialized"], f"seq {i} failed to initialize"
        assert out["lost_at"] == -1, f"seq {i} lost"
        assert out["n_frames"] == N_FRAMES and out["valid"].all()
        errs = [np.linalg.norm(out["t"][k] - poses[k][1])
                for k in range(N_FRAMES) if out["valid"][k]]
        assert np.median(errs) < 0.02, f"seq {i} err {np.median(errs)}"
    # distinct worlds give distinct maps
    assert not np.array_equal(outs[0]["t"], outs[1]["t"])


@pytest.mark.parametrize("i", range(B))
def test_each_sequence_equals_a_solo_tracker(run, i):
    mt, outs, solos, _ = run
    ref = solos[i].finalize()
    out = outs[i]
    assert set(out) == {"R", "t", "valid", "stats", "lost_at", "initialized",
                        "n_keyframes", "n_frames", "n_loops_closed"}
    for k in ("R", "t", "valid", "stats"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    for k in ("lost_at", "initialized", "n_keyframes", "n_frames",
              "n_loops_closed"):
        assert out[k] == ref[k], k
    m, want = mt.states[i].map, solos[i].state.map
    for f in m._fields:
        assert torch.equal(getattr(m, f), getattr(want, f)), f


def test_stack_and_unstack_round_trip(run):
    mt = run[0]
    stacked = stack_states(mt.states)
    assert stacked.map.kf_R.shape == (B, *mt.states[0].map.kf_R.shape)
    gens = stacked.loop.gen
    assert isinstance(gens, list) and len(gens) == B
    assert gens[0] is not gens[1]  # one generator per sequence, never shared
    assert stacked.frame_idx == [N_FRAMES] * B
    for i in range(B):
        back = unstack_state(stacked, i)
        orig = mt.states[i]

        def same(a, b):
            if isinstance(a, tuple) and hasattr(a, "_fields"):
                return all(same(x, y) for x, y in zip(a, b))
            if isinstance(a, torch.Tensor):
                return torch.equal(a, b)
            return a is b or a == b

        assert same(back, orig)
        assert back.loop.gen is orig.loop.gen
        assert torch.equal(back.loop.gen.get_state(),
                           orig.loop.gen.get_state())


def test_n_seq_must_divide_over_the_group(monkeypatch):
    """Three sequences cannot split over a group of two ranks."""
    from orb_slam2_with_comment_tpu_torch.parallel import multi_seq
    monkeypatch.setattr(multi_seq, "rank_and_size",
                        lambda group=None: (0, 2))
    with pytest.raises(ValueError):
        MultiSeqTracker(_cfg(), n_seq=3, device="cpu")
