"""The Hamming kernels' wrappers on a card: launch counting and argument
checks, and the stereo association's one launch.

The kernels' bit-exact comparison with their plain versions, and the slice
on the card against the CPU, are phases of ``chip_smoke.py`` and are not
repeated here. These tests need a CUDA device and skip without one. They
import neither jax nor the JAX package, so they also run on a machine that
has only PyTorch:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)
"""
import numpy as np
import pytest
import torch

from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu_torch.frontend.extractor import OrbExtractor
from orb_slam2_with_comment_tpu_torch.ops import hamming

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _desc(rng, n):
    d = rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    return torch.as_tensor(d.view(np.int32))


def test_wrappers_count_and_check(dev):
    d = _desc(np.random.RandomState(4), 16).to(dev)
    mask = torch.ones((16, 16), dtype=torch.bool, device=dev)
    before = dict(hamming.LAUNCHES)
    hamming.masked_best_two(d, d, mask)
    hamming.distance_matrix(d, d)
    assert hamming.LAUNCHES["masked_best_two"] == before["masked_best_two"] + 1
    assert hamming.LAUNCHES["distance_matrix"] == before["distance_matrix"] + 1
    with pytest.raises(ValueError):
        hamming.distance_matrix(d.long(), d.long())
    with pytest.raises(ValueError):
        hamming.masked_best_two(d, d.cpu(), mask)
    with pytest.raises(ValueError):
        hamming.masked_best_two(d, d, mask.int())


def test_stereo_association_is_one_launch(dev):
    """OrbExtractor.stereo on the card agrees with the CPU (plain versions)
    and launches masked_best_two once, distance_matrix never."""
    cam = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    world = SyntheticWorld(seed=1)
    R, t = orbit_trajectory(16)[5]
    t_r = np.asarray(t, np.float32) - np.array([0.08, 0, 0], np.float32)
    left, right = (torch.as_tensor(np.clip(world.render(R, tt, **cam)[0], 0,
                                           255).astype(np.uint8))
                   for tt in (t, t_r))
    ext = OrbExtractor(n_features=500)
    before = dict(hamming.LAUNCHES)
    feats, sd = ext.stereo(left.to(dev), right.to(dev), 20.0, 250.0)
    assert hamming.LAUNCHES["masked_best_two"] == before["masked_best_two"] + 1
    assert hamming.LAUNCHES["distance_matrix"] == before["distance_matrix"]
    feats_c, sd_c = ext.stereo(left, right, 20.0, 250.0)
    has = sd_c.depth > 0
    assert int(has.sum()) > 150
    # the card sums the SAD windows and the IC moments in another order
    assert torch.equal(sd.depth.cpu() > 0, has)
    assert torch.allclose(sd.depth.cpu()[has], sd_c.depth[has], rtol=1e-3)
