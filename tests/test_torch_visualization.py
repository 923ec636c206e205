"""visualization/ and the mono_ar driver of the PyTorch port against the
JAX package's, on the CPU.

- draw_frame: pixel-exact (a numpy copy) on random keypoint sets, some
  off the image, and a status line with every glyph;
- export_map_ply / export_map_json: byte-identical files for the same map
  (a JAX map converted with convert.py), covisibility edges equal;
- the AR plane RANSAC fed the JAX package's own draws (the Gumbel noise
  of PRNGKey(i)'s first split, the spin of its second): the same inlier
  mask and ok, the plane within 1e-5, the refit normal within 1e-5 up to
  its sign, the plane pose within 1e-5, the overlay pixel-exact; and
  tests/test_ar.py's four cases drawing from a torch.Generator;
- the viewer: every endpoint over HTTP on a free port, the frame PNG
  decoded by the port's codec equal to draw_frame of the same frame, the
  controls; the RGB PNG writer against Pillow's decoder;
- mono_ar --synthetic on the CPU over the first frames of its orbit.
"""
import io
import json
import os
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_with_comment_tpu.mapstate import map as jmap
from orb_slam2_with_comment_tpu.models.camera import PinholeCamera
from orb_slam2_with_comment_tpu.visualization import ar as jar
from orb_slam2_with_comment_tpu.visualization import (
    frame_drawer as jframe, map_drawer as jmapd)
from orb_slam2_with_comment_tpu_torch import Sensor, System, convert
from orb_slam2_with_comment_tpu_torch.dataio import png
from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig
from orb_slam2_with_comment_tpu_torch.pipeline.tracking import TrackerConfig
from orb_slam2_with_comment_tpu_torch.visualization import (
    ar, draw_frame, export_map_json, export_map_ply, map_drawer)

from test_ar import _make_points
from test_torch_mapstate import maps  # noqa: F401  (a module fixture)

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", range(3))
def test_draw_frame_pixel_exact(seed):
    rng = np.random.RandomState(seed)
    img = rng.uniform(-20, 280, (120, 160)).astype(np.float32)
    n = 300
    xy = rng.uniform(-10, 170, (n, 2)).astype(np.float32)
    lm = np.where(rng.rand(n) < 0.5, rng.randint(0, 99, n), -1)
    valid = rng.rand(n) < 0.8
    kw = dict(state=["OK", "LOST", "NOT_INITIALIZED"][seed],
              n_kf=int(rng.randint(0, 999)), n_lm=int(rng.randint(0, 99999)))
    got = draw_frame(img, xy, lm, valid, **kw)
    want = jframe.draw_frame(img, xy, lm, valid, **kw)
    assert got.dtype == np.uint8 and got.shape == (140, 160, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 3])
def test_map_exports_byte_identical(maps, tmp_path, k):  # noqa: F811
    """The map after keyframe k's landmarks (tests/test_torch_mapstate.py's
    JAX-built maps), exported by both packages."""
    jm = maps[k][4]
    m = convert.map_from_numpy(jm, "cpu")
    n_kf = k + 1
    local = np.asarray(jm.lm_first_kf) == k
    export_map_ply(str(tmp_path / "p.ply"), m, n_kf,
                   local_mask=torch.as_tensor(local))
    jmapd.export_map_ply(str(tmp_path / "j.ply"), jm, n_kf, local_mask=local)
    export_map_json(str(tmp_path / "p.json"), m, n_kf, min_weight=5)
    jmapd.export_map_json(str(tmp_path / "j.json"), jm, n_kf, min_weight=5)
    for a, b in (("p.ply", "j.ply"), ("p.json", "j.json")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()
    edges = map_drawer.covisibility_edges(m, n_kf, 5)
    assert edges == jmapd.covisibility_edges(jm, n_kf, 5) and edges
    assert b"40 90 230" in (tmp_path / "p.ply").read_bytes()


def _jax_draws(key, iterations, n):
    """detect_plane's draws from PRNGKey(key): the hypotheses' Gumbel noise
    and the in-plane spin."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(key))
    g = jax.random.gumbel(k1, (iterations, n))
    rang = jax.random.uniform(k2, (), jnp.float32, -jnp.pi / 2, jnp.pi / 2)
    return k1, np.asarray(g), float(rang)


@pytest.mark.parametrize("case", range(4))
def test_plane_ransac_fed_the_jax_draws(case):
    rng = np.random.RandomState(10 + case)
    normal = [(0.0, 1.0, 0.0), (0.2, 0.9, 0.1), (1.0, 0.1, 0.0),
              (0.0, 0.3, 1.0)][case]
    pts, n_in = _make_points(rng, normal=normal, d=-1.2)
    valid = rng.rand(len(pts)) < 0.95
    k1, g, rang = _jax_draws(case, 50, len(pts))
    jn, jd, jin, jok = jar.fit_plane_ransac(jnp.asarray(pts),
                                            jnp.asarray(valid), k1)
    tn, td, tin, tok = ar.fit_plane_ransac(
        torch.as_tensor(pts), torch.as_tensor(valid),
        gumbel=torch.as_tensor(g))
    assert bool(tok) == bool(jok)
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    assert abs(float(td) - float(jd)) < 1e-5
    jnorm, jo = jar.refit_plane(jnp.asarray(pts), jin)
    tnorm, to = ar.refit_plane(torch.as_tensor(pts), tin)
    sign = np.sign(float(tnorm @ torch.as_tensor(np.asarray(jnorm))))
    np.testing.assert_allclose(sign * tnorm.numpy(), np.asarray(jnorm),
                               atol=1e-5)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    Rcw = np.eye(3, dtype=np.float32)
    tcw = np.array([0.0, 0.0, 2.5], np.float32)
    want = jar.detect_plane(pts, valid, Rcw, tcw, jax.random.PRNGKey(case))
    got = ar.detect_plane(pts, valid, Rcw, tcw, gumbel=g, rang=rang)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    cam = PinholeCamera.create(500.0, 500.0, 320.0, 240.0)
    img = np.full((480, 640), 50, np.uint8)
    np.testing.assert_array_equal(
        ar.draw_ar(img, cam, Rcw, tcw, want[0], want[1], cube_size=0.3),
        jar.draw_ar(img, cam, Rcw, tcw, want[0], want[1], cube_size=0.3))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_plane_ransac_recovers_plane():
    rng = np.random.RandomState(3)
    pts, n_in = _make_points(rng)
    valid = np.ones(len(pts), bool)
    n, d, inliers, ok = ar.fit_plane_ransac(
        torch.as_tensor(pts), torch.as_tensor(valid), _gen(0))
    assert bool(ok)
    assert abs(abs(float(n[1])) - 1.0) < 0.02
    inl = inliers.numpy()
    assert inl[:n_in].mean() > 0.2 and inl[n_in:].mean() < 0.1
    normal, origin = ar.refit_plane(torch.as_tensor(pts), inliers)
    assert abs(abs(float(normal[1])) - 1.0) < 1e-3
    assert abs(float(origin[1]) - 1.5) < 0.01


def test_refit_and_pose_orientation():
    rng = np.random.RandomState(7)
    pts, n_in = _make_points(rng, normal=(0.2, 0.9, 0.1), d=-1.0)
    inliers = np.zeros(len(pts), bool)
    inliers[:n_in] = True
    normal, origin = ar.refit_plane(torch.as_tensor(pts),
                                    torch.as_tensor(inliers))
    true_n = np.array([0.2, 0.9, 0.1])
    true_n /= np.linalg.norm(true_n)
    assert abs(abs(float(normal.numpy() @ true_n)) - 1.0) < 1e-3
    cam_center = torch.zeros(3)
    Rpw, _ = ar.plane_pose(normal, origin, cam_center, 0.3)
    Rpw = Rpw.numpy()
    assert np.allclose(Rpw @ Rpw.T, np.eye(3), atol=1e-5)
    xc = (cam_center - origin).numpy()
    assert float(xc @ Rpw[:, 1]) <= 1e-5
    assert abs(abs(Rpw[:, 1] @ true_n) - 1.0) < 1e-3


def test_detect_plane_too_few_points_returns_none():
    valid = np.zeros(100, bool)
    valid[:30] = True
    assert ar.detect_plane(np.zeros((100, 3), np.float32), valid, np.eye(3),
                           np.zeros(3), _gen(1)) is None


def test_draw_ar_renders_cube_pixels():
    rng = np.random.RandomState(0)
    pts, _ = _make_points(rng, d=-0.0)
    Rcw = np.eye(3, dtype=np.float32)
    tcw = np.array([0.0, 0.0, 2.5], np.float32)
    out = ar.detect_plane(pts, np.ones(len(pts), bool), Rcw, tcw, _gen(2))
    assert out is not None
    Rpw, opw, inliers = out
    assert inliers.sum() >= 30
    cam = PinholeCamera.create(500.0, 500.0, 320.0, 240.0)
    over = ar.draw_ar(np.full((480, 640), 50, np.uint8), cam, Rcw, tcw, Rpw,
                      opw, cube_size=0.3)
    assert over.shape == (480, 640, 3)
    assert (over == np.array([235, 60, 200])).all(axis=2).sum() > 50


def test_rgb_png_against_pillow():
    from PIL import Image
    rgb = np.random.RandomState(4).randint(0, 256, (37, 53, 3)).astype(
        np.uint8)
    buf = io.BytesIO()
    png.write_png(buf, rgb)
    data = buf.getvalue()
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  rgb)
    np.testing.assert_array_equal(png.decode_png(data), rgb)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read()


def _post(port, path, doc):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(doc).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.read()


def test_viewer_end_to_end():
    """tests/test_viewer.py's run at 320x240."""
    cam = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    cfg = TrackerConfig(**cam, n_features=600, min_init_features=150,
                        map_cfg=MapConfig(k_max=6, n_feat=600, l_max=3000,
                                          d_max=8), fps=10)
    slam = System(config=cfg, sensor=Sensor.RGBD, use_viewer=True,
                  viewer_port=0, device="cpu")
    port = slam.viewer.port
    try:
        world = SyntheticWorld(seed=1)
        for k, (R, t) in enumerate(orbit_trajectory(n_frames=8)):
            img, depth = world.render(R, t, **cam)
            slam.track_rgbd(img, depth, timestamp=k / 10.0)
        slam.tracker.flush()
        assert b"live viewer" in _get(port, "/")
        doc = json.loads(_get(port, "/state.json"))
        assert doc["state"] == "OK" and len(doc["points"]) > 100
        assert len(doc["keyframes"]) >= 1 and doc["camera"] is not None
        data = _get(port, "/frame.png")
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        tr = slam.tracker
        obs = tr.last_obs
        want = draw_frame(np.asarray(img, np.float32), obs.feats.xy.numpy(),
                          obs.lm.numpy(), obs.feats.valid.numpy(),
                          state="OK", n_kf=tr.n_kf_host,
                          n_lm=int(tr.map.lm_valid.sum()))
        np.testing.assert_array_equal(png.decode_png(data), want)
        _post(port, "/control", {"localization": True})
        assert slam.tracker.localization_only
        _post(port, "/control", {"localization": False})
        assert not slam.tracker.localization_only
        _post(port, "/control", {"reset": True})
        assert slam.tracker.n_kf_host == 0
    finally:
        slam.shutdown()
    assert slam.viewer is None


def test_mono_ar_synthetic_writes_overlays(tmp_path, monkeypatch):
    """The driver's synthetic mode over the first 6 frames of its 80-frame
    orbit (the renders cut in the test: a frame costs seconds on this
    CPU): it bootstraps, writes one overlay PNG per tracked frame, at the
    frame's size plus the status bar."""
    from orb_slam2_with_comment_tpu_torch.dataio import fixtures
    from orb_slam2_with_comment_tpu_torch.examples import mono_ar
    real = fixtures.render_views
    monkeypatch.setattr(fixtures, "render_views",
                        lambda spec, views, kw=None, workers=1, chunk=5:
                        real(spec, views[:6], kw, 1, chunk))
    out = tmp_path / "ar"
    assert mono_ar.main(["mono_ar", "--synthetic", "--device=cpu",
                         f"--out={out}"]) == 0
    files = sorted(os.listdir(out))
    assert len(files) >= 3, files
    over = png.read_png(str(out / files[-1]))
    assert over.shape == (500, 640, 3)
