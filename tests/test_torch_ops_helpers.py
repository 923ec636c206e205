"""The JAX package's public ops helpers as the port has them, against the
JAX functions on the same seeded numpy inputs, on the CPU, plus the
FrameFeatures.n and MapState.config properties, matching/core's
masked_best_two, and default_vocabulary's refusal to fall back to the CPU.

Tolerances:
- Integer outputs exact: brief.descriptors and
  descriptors_from_patches_exact (the same rotated offsets rounded half to
  even), hamming.best_two and core.masked_best_two (ties to the lowest
  index, as lax.top_k and argmin).
- image.conv2d_same and orientation.orientation_maps within 1e-6 of the
  largest sum of the terms' magnitudes (the same correlation with |image|
  and |kernel|): float32 sums of up to 961 terms in another order (XLA's
  convolution against PyTorch's; measured up to 5.9e-7 of it over 30
  random kernels).
- orientation.angles_at and angles_at_patches within 4.3e-5 rad, the
  port's known bound on the IC angle (its moments are added in another
  order; measured 0 on integer intensities, whose moment sums are exact,
  and 8.9e-7 rad on the fractional image).
- fast.subpixel_refine within 1e-6 px (the same arithmetic).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_with_comment_tpu.frontend.extractor import (
    FrameFeatures as JaxFrameFeatures)
from orb_slam2_with_comment_tpu.mapstate.map import (
    MapConfig as JaxMapConfig, empty_map as jax_empty_map)
from orb_slam2_with_comment_tpu.matching import core as jcore
from orb_slam2_with_comment_tpu.ops import brief as jbrief
from orb_slam2_with_comment_tpu.ops import fast as jfast
from orb_slam2_with_comment_tpu.ops import hamming as jhamming
from orb_slam2_with_comment_tpu.ops import image as jimage
from orb_slam2_with_comment_tpu.ops import orientation as jorient
from orb_slam2_with_comment_tpu_torch.frontend.extractor import (
    FrameFeatures, OrbExtractor)
from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig, empty_map
from orb_slam2_with_comment_tpu_torch.matching import core
from orb_slam2_with_comment_tpu_torch.ops import (brief, fast, hamming, image,
                                                  orientation)
from orb_slam2_with_comment_tpu_torch.pipeline import tracking

torch.set_num_threads(2)

H, W = 90, 120
RNG = np.random.default_rng(8)
IMG = RNG.integers(0, 256, (H, W)).astype(np.float32)  # integer intensities
SMOOTH = (np.cumsum(np.cumsum(RNG.random((H, W)), 0), 1)
          / 40.0).astype(np.float32)  # fractional, well-conditioned moments
# keypoints inside, on and near the border (the helpers pad with zeros)
YX = np.concatenate([RNG.integers(0, [H, W], (60, 2)),
                     [[0, 0], [H - 1, W - 1], [3, W - 2], [H - 15, 15]]]
                    ).astype(np.int32)
ANGLE = RNG.uniform(-np.pi, np.pi, len(YX)).astype(np.float32)


def _sum_bound(img, k):
    """1e-6 of the largest sum of |terms| of a correlation of img with k."""
    return 1e-6 * float(np.asarray(jimage.conv2d_same(
        jnp.abs(jnp.asarray(img)), jnp.abs(jnp.asarray(k)))).max())


def _angle_err(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 2 * np.pi - d)


@pytest.mark.parametrize("shape", [(5, 5), (4, 6), (31, 31)])
def test_conv2d_same_matches_jax(shape):
    k = RNG.normal(size=shape).astype(np.float32)
    got = image.conv2d_same(torch.from_numpy(IMG), torch.from_numpy(k))
    want = np.asarray(jimage.conv2d_same(jnp.asarray(IMG), jnp.asarray(k)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_sum_bound(IMG, k))


@pytest.mark.parametrize("img", [IMG, SMOOTH], ids=["integer", "smooth"])
def test_orientation_helpers_match_jax(img):
    t_img, t_yx = torch.from_numpy(img), torch.from_numpy(YX)
    m10, m01 = orientation.orientation_maps(t_img)
    j10, j01 = jorient.orientation_maps(jnp.asarray(img))
    for got, want, k in ((m10, j10, orientation._K10),
                         (m01, j01, orientation._K01)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=_sum_bound(img, k))
    want = np.asarray(jorient.angles_at(jnp.asarray(img), jnp.asarray(YX)))
    assert _angle_err(orientation.angles_at(t_img, t_yx), want).max() < 4.3e-5
    want = np.asarray(jorient.angles_at_patches(jnp.asarray(img),
                                                jnp.asarray(YX)))
    assert _angle_err(orientation.angles_at_patches(t_img, t_yx),
                      want).max() < 4.3e-5
    # the extractor's ic_angles reads the edge instead of zeros: the same
    # angles at least 15 px inside
    inner = ((YX >= 15) & (YX < np.array([H, W]) - 15)).all(1)
    assert inner.sum() >= 10
    torch.testing.assert_close(
        orientation.ic_angles(t_img, t_yx[inner]),
        orientation.angles_at(t_img, t_yx[inner]), rtol=0, atol=0)


def test_brief_helpers_match_jax():
    blurred = np.round(np.asarray(jimage.gaussian_blur(jnp.asarray(IMG))))
    got = brief.descriptors(torch.from_numpy(blurred), torch.from_numpy(YX),
                            torch.from_numpy(ANGLE))
    want = np.asarray(jbrief.descriptors(jnp.asarray(blurred),
                                         jnp.asarray(YX),
                                         jnp.asarray(ANGLE)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    p = 2 * brief.BRIEF_RADIUS + 1
    patches = RNG.integers(0, 256, (len(YX), p * p)).astype(np.float32)
    got = brief.descriptors_from_patches_exact(torch.from_numpy(patches),
                                               torch.from_numpy(ANGLE))
    want = np.asarray(jbrief.descriptors_from_patches_exact(
        jnp.asarray(patches), jnp.asarray(ANGLE)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_subpixel_refine_matches_jax():
    score = np.array(jfast.fast_score_map(jnp.asarray(IMG)))
    got = fast.subpixel_refine(torch.from_numpy(score), torch.from_numpy(YX))
    want = np.asarray(jfast.subpixel_refine(jnp.asarray(score),
                                            jnp.asarray(YX)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (np.abs(want) <= 0.5).all() and (want != 0).any()


@pytest.mark.parametrize("masked", [False, True])
def test_best_two_matches_jax(masked):
    dist = RNG.integers(0, 40, (50, 37)).astype(np.int32)  # many ties
    valid = RNG.random(dist.shape) < 0.3 if masked else None
    if masked:
        valid[0] = False  # an all-masked row
    got = hamming.best_two(torch.from_numpy(dist), None if valid is None
                           else torch.from_numpy(valid))
    want = jhamming.best_two(jnp.asarray(dist), None if valid is None
                             else jnp.asarray(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    mask = valid if masked else np.ones(dist.shape, bool)
    got = core.masked_best_two(torch.from_numpy(dist), torch.from_numpy(mask))
    want = jcore.masked_best_two(jnp.asarray(dist), jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_feature_count_and_map_config_properties():
    img = torch.from_numpy(np.clip(SMOOTH * 4, 0, 255).astype(np.uint8))
    feats = OrbExtractor(n_features=300)(img)
    assert isinstance(feats, FrameFeatures) and feats.n == 300
    assert "n" not in FrameFeatures._fields
    jf = JaxFrameFeatures(*(jnp.zeros((300, 2)),) * 6)
    assert jf.n == feats.n
    cfg = MapConfig(k_max=6, n_feat=40, l_max=90, d_max=5)
    assert "config" not in empty_map(cfg, "cpu")._fields
    assert empty_map(cfg, "cpu").config == cfg
    assert tuple(jax_empty_map(JaxMapConfig(6, 40, 90, 5)).config) == cfg


def test_default_vocabulary_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tracking.default_vocabulary()
    voc = tracking.default_vocabulary("cpu")
    assert voc.node_desc.device.type == "cpu" and voc.n_words > 10_000
