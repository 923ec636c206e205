"""The four search modes of the tracking slice, PyTorch port against the
JAX package on one synthetic scene: match indices, distances and matched
flags are bit-exact, as are the frustum's visibility and predicted levels.

The scene: 400 features of a 320x240 frame, 300 of them with a landmark
back-projected at 1-4 m, landmark descriptors = feature descriptors with
0-40 flipped bits, a second view shifted by a few pixels. The search runs
from a pose 5 mm and ~0.1 degree away from the one that created the
landmarks, as tracking does: from the creating pose itself every distance
ratio sits exactly on a pyramid-scale boundary, where the predicted level
turns on the last bit of log(), which XLA and PyTorch compute differently.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_with_comment_tpu.geometry import se3 as jse3
from orb_slam2_with_comment_tpu.matching import search as jsearch
from orb_slam2_with_comment_tpu.optim.residuals import CamParams as JCam
from orb_slam2_with_comment_tpu_torch.matching import search
from orb_slam2_with_comment_tpu_torch.optim.residuals import CamParams

torch.set_num_threads(2)

W, H = 320, 240
CAM = CamParams.of(250.0, 250.0, 160.0, 120.0, 20.0)
JCAM = JCam(*[jnp.float32(v) for v in CAM])


def _scene():
    rng = np.random.RandomState(5)
    n, m = 400, 300
    xy = np.stack([rng.uniform(20, 300, n), rng.uniform(20, 220, n)],
                  1).astype(np.float32)
    octave = rng.choice(4, n, p=[0.5, 0.25, 0.15, 0.1]).astype(np.int32)
    depth = rng.uniform(1.0, 4.0, n).astype(np.float32)
    ur = np.where(rng.rand(n) < 0.7, xy[:, 0] - CAM.bf / depth,
                  -1.0).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    desc = rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    valid = rng.rand(n) < 0.95
    w = np.array([0.02, -0.03, 0.01], np.float32)
    R = np.asarray(jse3.exp_so3(jnp.asarray(w)))
    t = np.array([0.05, -0.02, 0.1], np.float32)
    Xc = np.stack([(xy[:m, 0] - CAM.cx) / CAM.fx * depth[:m],
                   (xy[:m, 1] - CAM.cy) / CAM.fy * depth[:m], depth[:m]], 1)
    pw = ((Xc - t) @ R).astype(np.float32)
    lm_desc = desc[:m].copy()
    for i in range(m):
        for _ in range(rng.randint(0, 40)):
            w_, b = rng.randint(8), rng.randint(32)
            lm_desc[i, w_] ^= np.uint32(1 << b)
    Ow = -R.T @ t
    dist = np.linalg.norm(pw - Ow, axis=1)
    normal = ((pw - Ow) / dist[:, None]).astype(np.float32)
    dmax = (dist * 1.2 ** octave[:m]).astype(np.float32)
    lm = dict(pw=pw, normal=normal, dmin=(dmax / 1.2 ** 7).astype(np.float32),
              dmax=dmax, desc=lm_desc, valid=rng.rand(m) < 0.97)
    feats = dict(xy=xy, ur=ur, octave=octave, angle=angle, desc=desc,
                 valid=valid)
    prev = dict(feats, xy=(xy + rng.normal(0, 1.5, xy.shape)).astype(
        np.float32), angle=(angle + 0.05).astype(np.float32))
    prev = {k: v[:m] for k, v in prev.items()}
    return R, t, feats, prev, lm


def _fs(d, torch_side):
    if torch_side:
        return search.FeatureSet(**{k: torch.as_tensor(
            v.view(np.int32) if k == "desc" else v) for k, v in d.items()})
    return jsearch.FeatureSet(**{k: jnp.asarray(v) for k, v in d.items()})


def _ls(d, torch_side):
    if torch_side:
        return search.LandmarkSet(**{k: torch.as_tensor(
            v.view(np.int32) if k == "desc" else v) for k, v in d.items()})
    return jsearch.LandmarkSet(**{k: jnp.asarray(v) for k, v in d.items()})


def _run(mode, torch_side):
    R, t, feats, prev, lm = _scene()
    mod = search if torch_side else jsearch
    cam = CAM if torch_side else JCAM
    arr = torch.as_tensor if torch_side else jnp.asarray
    f, p, lms = _fs(feats, torch_side), _fs(prev, torch_side), _ls(lm, torch_side)
    R = np.asarray(jse3.exp_so3(jnp.asarray([0.0215, -0.031, 0.0105],
                                            jnp.float32)))
    Rt, tt = arr(R), arr((t + np.float32([0.004, 0.0, -0.003])).astype(
        np.float32))
    if mode == "projection_frame":
        has = arr(np.arange(300) % 7 != 0)
        extra = {} if torch_side else dict(forward=False, backward=False)
        return mod.search_by_projection_frame(
            cam, Rt, tt, lms.pw, p, has, f, 7.0, W, H, desc_th=100, **extra)
    if mode == "brute":
        return mod.search_brute(p.desc, f.desc, p.valid, f.valid, ratio=0.7,
                                angle_q=p.angle, angle_t=f.angle)
    if mode == "local_points":
        fr = mod.frustum_check(cam, Rt, tt, lms, W, H)
        used = arr(np.arange(400) % 5 == 0)
        out = mod.search_local_points(cam, Rt, tt, lms, fr, f, th=3.0,
                                      already_matched=used, desc_th=100)
        return tuple(out) + (fr.visible, fr.level)
    return mod.fuse_candidates(cam, Rt, tt, lms, f, W, H)


@pytest.mark.parametrize("mode", ["projection_frame", "brute",
                                  "local_points", "fuse"])
def test_search_mode_matches_jax(mode):
    got = [np.asarray(a) for a in _run(mode, True)]
    want = [np.asarray(a) for a in _run(mode, False)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert want[2].sum() >= 20, "scene too weak to exercise the matcher"
