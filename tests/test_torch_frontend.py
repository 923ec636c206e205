"""ORB front end of the PyTorch port against the JAX package, on
SyntheticWorld renders at 320x240 and 640x480.

Tolerances and their reasons:
- Pyramid levels within 1e-3 (level 0 exact): XLA's CPU compiler fuses the
  JAX resize into fused multiply-adds and reciprocal multiplications, so
  coarser levels differ by a few float32 ulps of 255 (measured <= 6.2e-4).
- Given the same level image, FAST scores, keypoint selection (yx,
  response, valid), BRIEF descriptors and subpixel positions are bit-exact.
  IC angles agree within 1e-5 on level 0, where the 961-term moment sums
  are exact integers, and within 1e-4 on coarser levels, whose pixels are
  not integers and whose sums are added in another order (measured max
  2.5e-5 at 320x240 and 4.3e-5 at 640x480).
- End to end on each side's own pyramid, octaves, valid flags and all
  descriptors agree exactly (0 mismatched rows measured at both sizes);
  angles agree within 1e-5 on level 0, whose pixels are identical, and
  within 1e-4 on coarser levels (measured <= 4.3e-5); positions within
  5e-3 px (the subpixel parabola reads scores that differ by <= 5e-4;
  measured <= 1.5e-3 px).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_with_comment_tpu.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu.frontend import OrbExtractor as JaxExtractor
from orb_slam2_with_comment_tpu.ops import fast as jfast
from orb_slam2_with_comment_tpu.ops import image as jimage
from orb_slam2_with_comment_tpu.ops import orientation as jorient
from orb_slam2_with_comment_tpu_torch.frontend.extractor import (
    OrbExtractor, level_budgets)
from orb_slam2_with_comment_tpu_torch.ops import fast, image

torch.set_num_threads(2)

SIZES = {"320x240": (320, 240, 250.0, 500), "640x480": (640, 480, 500.0, 1000)}


def _render(size):
    w, h, f, _ = SIZES[size]
    R, t = orbit_trajectory(16)[5]
    img, _ = SyntheticWorld(seed=1).render(R, t, fx=f, fy=f, cx=w / 2,
                                           cy=h / 2, width=w, height=h)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module", params=sorted(SIZES))
def frame(request):
    size = request.param
    img = _render(size)
    n = SIZES[size][3]
    jpyr = [np.asarray(a) for a in jax.jit(jimage.build_pyramid)(
        jnp.asarray(img, jnp.float32))]
    jfeat = JaxExtractor(n_features=n)(jnp.asarray(img))
    tfeat = OrbExtractor(n_features=n)(torch.as_tensor(img))
    return size, img, jpyr, jfeat, tfeat


def test_pyramid_levels(frame):
    _, img, jpyr, _, _ = frame
    tpyr = image.build_pyramid(torch.as_tensor(img).float())
    assert [tuple(a.shape) for a in tpyr] == [a.shape for a in jpyr]
    np.testing.assert_array_equal(tpyr[0].numpy(), jpyr[0])
    for a, b in zip(tpyr, jpyr):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-3)


def test_fast_scores_and_selection_exact(frame):
    """Same level image in, bit-exact FAST scores and keypoint selection."""
    _, _, jpyr, _, _ = frame
    budgets = level_budgets(SIZES[frame[0]][3])
    for lvl, (lvl_img, budget) in enumerate(zip(jpyr, budgets)):
        js = np.asarray(jfast.fast_score_map(jnp.asarray(lvl_img)))
        ts = fast.fast_score_map(torch.as_tensor(lvl_img.copy()))
        np.testing.assert_array_equal(ts.numpy(), js, err_msg=f"level {lvl}")
        jyx, jresp, jvalid = (np.asarray(a) for a in jfast.select_keypoints(
            jnp.asarray(js), budget, 32, 8, 20.0, 7.0))
        tyx, tresp, tvalid = fast.select_keypoints(ts, budget, 32, 8)
        np.testing.assert_array_equal(tyx.numpy(), jyx)
        np.testing.assert_array_equal(tresp.numpy(), jresp)
        np.testing.assert_array_equal(tvalid.numpy(), jvalid)


def test_level_features_on_same_image(frame):
    """Per level, from the JAX package's level image: descriptors, octave,
    valid, response and positions exact; angles as stated above."""
    size, _, jpyr, _, _ = frame
    n = SIZES[size][3]
    jx = JaxExtractor(n_features=n)
    tx = OrbExtractor(n_features=n)
    kmat = jorient.moment_kernel_matrix()
    for lvl, budget in enumerate(jx.budgets):
        fn = jax.jit(lambda im, lvl=lvl, budget=budget: jx._level_features(
            im, lvl=lvl, budget=budget, kmat=kmat))
        jout = [np.asarray(a) for a in fn(jnp.asarray(jpyr[lvl]))]
        tout = [a.numpy() for a in tx._level_features(
            torch.as_tensor(jpyr[lvl].copy()), lvl, budget)]
        for k in (0, 1, 2, 5):  # xy, response, octave, valid
            np.testing.assert_array_equal(tout[k], jout[k])
        np.testing.assert_allclose(tout[3], jout[3], rtol=0,
                                   atol=1e-5 if lvl == 0 else 1e-4)
        np.testing.assert_array_equal(tout[4], jout[4].view(np.int32))


def test_extractor_end_to_end(frame):
    _, _, _, jf, tf = frame
    np.testing.assert_array_equal(tf.octave.numpy(), np.asarray(jf.octave))
    np.testing.assert_array_equal(tf.valid.numpy(), np.asarray(jf.valid))
    np.testing.assert_array_equal(tf.desc.numpy(),
                                  np.asarray(jf.desc).view(np.int32))
    np.testing.assert_allclose(tf.xy.numpy(), np.asarray(jf.xy), rtol=0,
                               atol=5e-3)
    level0 = tf.octave.numpy() == 0
    dang = np.abs(tf.angle.numpy() - np.asarray(jf.angle))
    assert dang[level0].max() <= 1e-5
    assert dang.max() <= 1e-4
