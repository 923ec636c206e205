"""The System façade, settings, undistortion, checkpoints and nodes of the
PyTorch port against the JAX package's, on the CPU.

- Settings parsed from tests/test_system_dataio.py's TUM1.yaml (and its
  EuRoC block) equal the JAX package's, field for field, and so do the
  tracker configurations built from them (rgbd and mono).
- undistort_points for the TUM1 distortion of tests/test_geometry.py
  within 1e-4 px of the JAX package's (measured 6.1e-5 px at 640x480).
- One session, made up in the test (12 keyframes with random poses, 2 of
  them archived, 40 logged frames), saved by the JAX package and loaded by
  the port: the three trajectory files both packages write from it agree
  line for line, TUM numbers within one unit of their last printed digit
  (the quaternion is computed in float32 by two libraries; measured 0:
  identical here), KITTI lines identical.
- Checkpoints cross-load both ways with every array exact: a map, a
  session (map, poses, log, uids, archive) and an AutoTracker state.
- The pairing cases of tests/test_nodes.py, and an RGBDNode whose raw depth
  is divided into metres initializes a System.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_with_comment_tpu import checkpoint as jckpt
from orb_slam2_with_comment_tpu.dataio import settings as jsettings
from orb_slam2_with_comment_tpu.mapstate import map as jmap
from orb_slam2_with_comment_tpu.models.camera import (
    PinholeCamera as JaxPinholeCamera)
from orb_slam2_with_comment_tpu.pipeline import (
    AutoTracker as JaxAutoTracker, Tracker as JaxTracker,
    TrackerConfig as JaxTrackerConfig)
from orb_slam2_with_comment_tpu.system import System as JaxSystem
from orb_slam2_with_comment_tpu_torch import Sensor, System, checkpoint
from orb_slam2_with_comment_tpu_torch import convert
from orb_slam2_with_comment_tpu_torch.dataio import settings
from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig
from orb_slam2_with_comment_tpu_torch.models.camera import PinholeCamera
from orb_slam2_with_comment_tpu_torch.nodes import RGBDNode, _PairingQueue
from orb_slam2_with_comment_tpu_torch.pipeline import (
    AutoTracker, Tracker, TrackerConfig, TrackState)
from test_system_dataio import EUROC_BLOCK, TUM_YAML

torch.set_num_threads(2)

CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
KW = dict(CAM, bf=20.0, n_features=500, min_init_features=100, fps=30)
MAP = (16, 500, 3000, 8)
TUM_DIST = (0.2624, -0.9531, -0.0054, 0.0026, 1.1633)


def _as_dict(obj):
    out = dict(vars(obj))
    for k, v in out.items():
        if isinstance(v, np.ndarray):
            out[k] = v.tolist()
        elif isinstance(v, dict):
            out[k] = {a: np.asarray(b).tolist() for a, b in v.items()}
        elif hasattr(v, "_asdict"):
            out[k] = tuple(v)
    return out


def test_settings_match_jax(tmp_path):
    p = tmp_path / "TUM1.yaml"
    p.write_text(TUM_YAML + EUROC_BLOCK)
    a, b = settings.parse_opencv_yaml(str(p)), jsettings.parse_opencv_yaml(
        str(p))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert _as_dict(settings.load_settings(str(p))) == _as_dict(
        jsettings.load_settings(str(p)))
    p.write_text(TUM_YAML)
    for sensor in ("rgbd", "mono"):
        got = settings.load_tracker_config(str(p), expected_frames=900,
                                           sensor=sensor)
        want = jsettings.load_tracker_config(str(p), expected_frames=900,
                                             sensor=sensor)
        assert isinstance(got, TrackerConfig)
        assert _as_dict(got) == _as_dict(want)
    slam = System(settings_path=str(p), sensor=Sensor.RGBD, device="cpu")
    assert slam.tracker._undist_cam is not None
    assert slam.config.dist == want.dist and slam.config.sensor == "rgbd"


def test_undistort_points_match_jax():
    rng = np.random.RandomState(0)
    uv = rng.uniform([5, 5], [635, 475], (500, 2)).astype(np.float32)
    want = np.asarray(JaxPinholeCamera.create(
        517.3, 516.5, 318.6, 255.3, dist=jnp.asarray(TUM_DIST, jnp.float32)
    ).undistort_points(jnp.asarray(uv)))
    cam = PinholeCamera.create(517.3, 516.5, 318.6, 255.3, dist=TUM_DIST)
    got = cam.undistort_points(torch.as_tensor(uv)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.abs(got - uv).max() > 5.0  # the distortion is strong
    # and projecting the undistorted point through the distortion again
    xn = (torch.as_tensor(got) - torch.tensor([cam.cx, cam.cy])) \
        / torch.tensor([cam.fx, cam.fy])
    back = cam.distort_normalized(xn) * torch.tensor([cam.fx, cam.fy]) \
        + torch.tensor([cam.cx, cam.cy])
    assert float((back - torch.as_tensor(uv)).abs().max()) < 0.5


def _rand_rot(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]],
        np.float32)


def _random_map(rng):
    m = jax.device_get(jmap.empty_map(jmap.MapConfig(*MAP)))
    m = {f: np.array(getattr(m, f)) for f in m._fields}
    n_kf, n_lm = 12, 700
    m["kf_R"][:n_kf] = np.stack([_rand_rot(rng) for _ in range(n_kf)])
    m["kf_t"][:n_kf] = rng.normal(size=(n_kf, 3)).astype(np.float32)
    m["kf_valid"][:n_kf] = True
    m["kf_frame_id"][:n_kf] = np.arange(n_kf) * 3
    m["kf_desc"][:n_kf] = rng.randint(0, 2 ** 32, (n_kf, MAP[1], 8),
                                      dtype=np.uint64).astype(np.uint32)
    m["kf_feat_valid"][:n_kf] = rng.uniform(size=(n_kf, MAP[1])) < 0.9
    m["kf_xy"][:n_kf] = rng.uniform(0, 300, (n_kf, MAP[1], 2))
    m["kf_lm"][:n_kf] = rng.randint(-1, n_lm, (n_kf, MAP[1]))
    m["lm_pw"][:n_lm] = rng.normal(size=(n_lm, 3))
    m["lm_valid"][:n_lm] = True
    m["lm_obs_kf"][:n_lm, :2] = rng.randint(0, n_kf, (n_lm, 2))
    m["n_kf"], m["n_lm"] = np.int32(n_kf), np.int32(n_lm)
    return jmap.MapState(**{f: jnp.asarray(v) for f, v in m.items()})


def _jax_session_tracker(rng):
    jt = JaxTracker(JaxTrackerConfig(map_cfg=jmap.MapConfig(*MAP), **KW))
    jt.map = _random_map(rng)
    jt.state = jt.state.__class__.OK
    jt.n_kf_host, jt.ref_kf, jt.last_kf_frame = 12, 11, 33
    jt.frame_count, jt._n_inliers = 40, 123
    jt.kf_uids = [0, 1, 2, 4, 5, 6, 7, 8, 10, 11, 12, 13]
    jt._kf_uid_counter = 14
    jt.kf_archive = {3: (2, _rand_rot(rng), rng.normal(size=3).astype(
        np.float32)), 9: (-1, _rand_rot(rng), rng.normal(size=3).astype(
            np.float32))}
    jt.last_R = jnp.asarray(_rand_rot(rng))
    jt.last_t = jnp.asarray(rng.normal(size=3).astype(np.float32))
    jt.velocity = (jnp.asarray(_rand_rot(rng)),
                   jnp.asarray(rng.normal(size=3).astype(np.float32)))
    uids = list(range(14))
    jt.rel_log = [(f, 0.033 * f + 1e4, int(rng.choice(uids)),
                   jnp.asarray(_rand_rot(rng)),
                   jnp.asarray(rng.normal(size=3).astype(np.float32)))
                  for f in range(40)]
    return jt


def _port_tracker():
    return Tracker(TrackerConfig(map_cfg=MapConfig(*MAP), **KW), device="cpu")


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    rng = np.random.RandomState(3)
    jt = _jax_session_tracker(rng)
    path = str(tmp_path_factory.mktemp("ckpt") / "jax_session.npz")
    jckpt.save_session(path, jt)
    tt = _port_tracker()
    checkpoint.load_session(path, tt)
    return jt, tt, path


def _assert_session_equal(tt, jt):
    for f, a in convert.map_to_numpy(tt.map).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jt.map, f)), f)
    for a, b in ((tt.last_R, jt.last_R), (tt.last_t, jt.last_t),
                 (tt.velocity[0], jt.velocity[0]),
                 (tt.velocity[1], jt.velocity[1])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tt.state.name == jt.state.name
    for f in ("ref_kf", "last_kf_frame", "frame_count", "n_kf_host",
              "_n_inliers", "kf_uids", "_kf_uid_counter"):
        assert getattr(tt, f) == getattr(jt, f), f
    assert [r[:3] for r in tt.rel_log] == [r[:3] for r in jt.rel_log]
    for a, b in zip(tt.rel_log, jt.rel_log):
        np.testing.assert_array_equal(np.asarray(a[3]), np.asarray(b[3]))
        np.testing.assert_array_equal(np.asarray(a[4]), np.asarray(b[4]))
    assert tt.kf_archive.keys() == jt.kf_archive.keys()
    for u in tt.kf_archive:
        assert tt.kf_archive[u][0] == jt.kf_archive[u][0]
        for i in (1, 2):
            np.testing.assert_array_equal(tt.kf_archive[u][i],
                                          jt.kf_archive[u][i])


def test_session_cross_loads(session, tmp_path):
    jt, tt, _ = session
    _assert_session_equal(tt, jt)
    assert tt.db is not None and tt.loop_closer is not None
    np.testing.assert_array_equal(tt.last_obs.lm.numpy(),
                                  np.asarray(jt.map.kf_lm[11]))
    path = str(tmp_path / "port_session.npz")
    checkpoint.save_session(path, tt)
    back = JaxTracker(JaxTrackerConfig(map_cfg=jmap.MapConfig(*MAP), **KW))
    jckpt.load_session(path, back)
    _assert_session_equal(tt, back)


def test_trajectory_files_agree(session, tmp_path):
    jt, tt, _ = session
    js = JaxSystem.__new__(JaxSystem)
    js.tracker = jt
    ts = System.__new__(System)
    ts.tracker = tt
    for fn in ("save_trajectory_tum", "save_keyframe_trajectory_tum",
               "save_trajectory_kitti"):
        a, b = tmp_path / f"port_{fn}.txt", tmp_path / f"jax_{fn}.txt"
        getattr(ts, fn)(str(a))
        getattr(js, fn)(str(b))
        got, want = a.read_text().splitlines(), b.read_text().splitlines()
        assert len(got) == len(want) > 10, fn
        if fn == "save_trajectory_kitti":
            assert got == want
            continue
        g = np.array([[float(v) for v in ln.split()] for ln in got])
        w = np.array([[float(v) for v in ln.split()] for ln in want])
        np.testing.assert_array_equal(g[:, :4], w[:, :4])  # ts and position
        assert np.abs(g - w).max() <= 1.01e-7, fn


def test_map_and_auto_state_cross_load(tmp_path):
    rng = np.random.RandomState(5)
    jm = _random_map(rng)
    jckpt.save_map(str(tmp_path / "jax_map.npz"), jm)
    tm = checkpoint.load_map(str(tmp_path / "jax_map.npz"), device="cpu")
    got = convert.map_to_numpy(tm)
    for f in got:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jm, f)), f)
        assert got[f].dtype == np.asarray(getattr(jm, f)).dtype, f
    checkpoint.save_map(str(tmp_path / "port_map"), tm)
    back = jckpt.load_map(str(tmp_path / "port_map"))
    for f in got:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), got[f])
    # an AutoTracker state, made up, both ways
    cfg = dict(KW, depth_factor=1.0)
    ja = JaxAutoTracker(JaxTrackerConfig(map_cfg=jmap.MapConfig(*MAP), **cfg))
    ja.state = ja.state._replace(
        map=jm, frame_idx=jnp.int32(7), ref_kf=jnp.int32(3),
        have_vel=jnp.bool_(True), maint_neighbors=jnp.arange(10,
                                                              dtype=jnp.int32),
        traj_t=jnp.asarray(rng.normal(size=ja.state.traj_t.shape),
                           jnp.float32),
        loop=ja.state.loop._replace(n_loops=jnp.int32(2)))
    ja.frame_count, ja.timestamps = 7, [0.1 * i for i in range(7)]
    jckpt.save_auto_state(str(tmp_path / "jax_auto.npz"), ja)
    ta = AutoTracker(TrackerConfig(map_cfg=MapConfig(*MAP), **cfg),
                     device="cpu")
    checkpoint.load_auto_state(str(tmp_path / "jax_auto.npz"), ta)
    assert ta.frame_count == 7 and ta.timestamps == ja.timestamps
    got = convert.auto_state_to_numpy(ta.state)
    want = jax.device_get(ja.state)
    for f in ("frame_idx", "ref_kf", "have_vel", "maint_neighbors", "traj_t",
              "traj_R", "traj_stats", "maint_lambda", "last_R"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)), f)
    for f in got["map"]:
        np.testing.assert_array_equal(got["map"][f],
                                      np.asarray(getattr(want.map, f)), f)
    assert ta.state.loop.n_loops == 2
    checkpoint.save_auto_state(str(tmp_path / "port_auto"), ta)
    jb = JaxAutoTracker(JaxTrackerConfig(map_cfg=jmap.MapConfig(*MAP), **cfg))
    jckpt.load_auto_state(str(tmp_path / "port_auto"), jb)
    leaves_a = jax.tree.leaves(jax.device_get(ja.state))
    leaves_b = jax.tree.leaves(jax.device_get(jb.state))
    assert len(leaves_a) == len(leaves_b)
    for i, (a, b) in enumerate(zip(leaves_a, leaves_b)):
        if a.dtype == np.uint32 and a.shape == (2,):
            continue  # the PRNG key
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), str(i))
        assert np.asarray(b).dtype == np.asarray(a).dtype, i


class TestPairingQueue:
    def test_exact_match(self):
        q = _PairingQueue(slop=0.01)
        assert q.push("a", 1.000, "A") is None
        assert q.push("b", 1.004, "B") == (1.000, "A", "B")

    def test_drops_stale(self):
        q = _PairingQueue(slop=0.01)
        q.push("a", 1.0, "A0")
        q.push("a", 2.0, "A1")
        assert q.push("b", 2.001, "B") == (2.0, "A1", "B")
        assert q.dropped == 1

    def test_out_of_slop_never_pairs(self):
        q = _PairingQueue(slop=0.005)
        q.push("a", 1.0, "A")
        assert q.push("b", 1.5, "B") is None


def test_rgbd_node_divides_depth_and_initializes():
    cfg = TrackerConfig(map_cfg=MapConfig(*MAP), **KW)
    slam = System(config=cfg, sensor=Sensor.RGBD, device="cpu")
    node = RGBDNode(slam, depth_factor=5000.0)
    poses = []
    node.pose_callback = lambda ts, pose: poses.append(np.asarray(pose))
    world = SyntheticWorld(seed=1)
    img, depth = world.render(*orbit_trajectory(n_frames=2)[0], **CAM)
    assert not node.on_rgb(np.clip(img, 0, 255).astype(np.uint8), 0.0)
    assert node.on_depth((depth * 5000.0).astype(np.float32), 0.001)
    assert slam.get_tracking_state() == TrackState.OK
    assert len(poses) == 1 and poses[0].shape == (4, 4)
    np.testing.assert_allclose(poses[0], np.eye(4), atol=1e-6)
    assert node.stats.frames_tracked == 1 and slam.map_changed()
    # the viewer is ported: it starts with the System and stops at shutdown
    viewed = System(config=cfg, use_viewer=True, viewer_port=0, device="cpu")
    assert viewed.viewer is not None and viewed.viewer.port > 0
    viewed.shutdown()
    assert viewed.viewer is None


def test_load_map_defaults_to_the_card(tmp_path, monkeypatch):
    """load_map loads onto the card unless the CPU is asked for, and
    without a card it raises rather than falling back."""
    import inspect
    from orb_slam2_with_comment_tpu_torch.mapstate.map import empty_map
    default = inspect.signature(checkpoint.load_map).parameters["device"]
    assert torch.device(default.default).type == "cuda"
    path = str(tmp_path / "m.npz")
    checkpoint.save_map(path, empty_map(MapConfig(4, 8, 16, 2), "cpu"))
    assert checkpoint.load_map(path, device="cpu").kf_R.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.load_map(path)
