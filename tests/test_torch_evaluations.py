"""The port's accuracy evaluations against the JAX package's scripts, on the
CPU, on fixed files and one held-out world:

- evaluation/trajectory.py's readers (TUM and KITTI, centres and full
  poses, timestamp association) equal scripts/run_fixture_eval.py's on the
  same files, exactly (the same numpy arithmetic).
- examples.eval_street --skip-run prints the same results-table row and the
  same JSON scores as scripts/eval_street.py --skip-run on the same
  trajectory files: the row as text, the scores exactly.
- examples.run_fixture_eval's scores of fixed run directories equal the
  JAX package's evaluation functions on the JAX script's readers, exactly;
  runs without files are listed as pending in the table it writes.
- examples.eval_vocab on the first held-out world (seed 200, the default
  vocabulary): each score within 1e-6 of the JAX script's functions
  (measured 4.5e-8: the port's extraction gives the same words), and the
  same table row as scripts/eval_vocab.py's evaluate on that world.
- dataio/synthetic.render_views (the street fixture's renderer on a card)
  against the numpy render: at most one grey level apart at no more than
  0.1% of the pixels, depth within 1e-5 relative.
"""
import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_with_comment_tpu.evaluation.ate import ate_rmse as jax_ate
from orb_slam2_with_comment_tpu.evaluation.rpe import (
    kitti_segment_drift as jax_drift, rpe as jax_rpe)
from orb_slam2_with_comment_tpu_torch.dataio import fixtures, synthetic
from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
    StreetWorld, SyntheticWorld, orbit_trajectory, street_trajectory)
from orb_slam2_with_comment_tpu_torch.evaluation import trajectory
from orb_slam2_with_comment_tpu_torch.examples import (
    eval_street, eval_vocab, run_fixture_eval)
from orb_slam2_with_comment_tpu_torch.place import vocabulary as V

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    """A script of the JAX package's tooling, imported; the environment
    variables it sets at import are restored."""
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    env = dict(os.environ)
    try:
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
    return mod


JAX_EVAL = _script("run_fixture_eval")  # its main is never called


def _perturbed(poses, seed, scale=1.0):
    """World->camera poses with noise (and a scaled map, for mono)."""
    rng = np.random.default_rng(seed)
    out = []
    for R, t in poses:
        w = rng.normal(0, 0.01, 3)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        out.append((np.asarray(R) @ (np.eye(3) + K),
                    scale * (np.asarray(t) + rng.normal(0, 0.02, 3))))
    return out


def _kitti_lines(poses):
    rows = []
    for R, t in poses:
        Rwc = np.asarray(R, np.float64).T
        P = np.hstack([Rwc, (-Rwc @ np.asarray(t, np.float64))[:, None]])
        rows.append(" ".join(f"{v:.9e}" for v in P.reshape(-1)))
    return "\n".join(rows) + "\n"


def _tum_lines(stamps, poses):
    rows = []
    for ts, (R, t) in zip(stamps, poses):
        Rwc = np.asarray(R, np.float64).T
        c = -Rwc @ np.asarray(t, np.float64)
        q = fixtures._quat_wxyz(Rwc)
        rows.append(f"{ts:.6f} {c[0]:.7f} {c[1]:.7f} {c[2]:.7f} "
                    f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}")
    return "\n".join(rows) + "\n"


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


@pytest.fixture(scope="module")
def runs_root(tmp_path_factory):
    """Fixture and run directories with fixed trajectory files: TUM (40
    frames, 36 tracked), KITTI (30, all tracked), mono keyframes (every
    4th frame, at half scale) and the street (60 poses of the circuit)."""
    root = str(tmp_path_factory.mktemp("runs"))
    gt = orbit_trajectory(40)
    stamps = [k / 30.0 for k in range(40)]
    _write(os.path.join(root, "tum_fixture", "groundtruth.txt"),
           "# ts tx ty tz qx qy qz qw\n" + _tum_lines(stamps, gt))
    keep = [k for k in range(40) if k % 10 != 3]
    _write(os.path.join(root, "run_tum", "CameraTrajectory.txt"),
           _tum_lines([stamps[k] for k in keep],
                      _perturbed([gt[k] for k in keep], 1)))
    kf = list(range(0, 40, 4))
    _write(os.path.join(root, "run_mono", "KeyFrameTrajectory.txt"),
           _tum_lines([stamps[k] for k in kf],
                      _perturbed([gt[k] for k in kf], 2, scale=0.5)))
    kgt = orbit_trajectory(30, x_amp=1.3)
    _write(os.path.join(root, "kitti_fixture", "poses_gt.txt"),
           _kitti_lines(kgt))
    _write(os.path.join(root, "run_kitti", "CameraTrajectory.txt"),
           _kitti_lines(_perturbed(kgt, 3)))
    street = street_trajectory(StreetWorld(seed=3), 60, laps=1.08)
    _write(os.path.join(root, "kitti_street_fixture", "poses_gt.txt"),
           _kitti_lines(street))
    _write(os.path.join(root, "run_street", "CameraTrajectory.txt"),
           _kitti_lines(_perturbed(street[:58], 4)))
    _write(os.path.join(root, "run_street", "run_summary.json"), json.dumps(
        {"n_frames": 60, "n_keyframes": 21, "n_loops_closed": 1,
         "lost_at": -1, "n_compact_kf": 2, "n_compact_lm": 0, "fps": 3.5}))
    return root


def test_readers_match_the_scripts(runs_root):
    tum = os.path.join(runs_root, "run_tum", "CameraTrajectory.txt")
    kit = os.path.join(runs_root, "run_kitti", "CameraTrajectory.txt")
    gt = os.path.join(runs_root, "tum_fixture", "groundtruth.txt")
    for name, path in (("read_tum", tum), ("read_tum_full", tum),
                       ("read_kitti", kit), ("read_kitti_full", kit)):
        got = getattr(trajectory, name)(path)
        want = getattr(JAX_EVAL, name)(path)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(g, w, err_msg=name)
    ts_e, ts_g = trajectory.read_tum(tum)[0], trajectory.read_tum(gt)[0]
    for diff in (0.02, 0.004):
        assert (trajectory.associate(ts_e + 0.003, ts_g, diff)
                == JAX_EVAL.associate(ts_e + 0.003, ts_g, diff))
    assert len(trajectory.associate(ts_e, ts_g)) == 36


def test_eval_street_prints_the_scripts_row(runs_root, monkeypatch):
    jax_street = _script("eval_street")
    monkeypatch.setattr("sys.argv", ["eval_street.py", "--root", runs_root,
                                     "--skip-run"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_street.main()
    want = buf.getvalue().splitlines()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert eval_street.main(["--root", runs_root, "--skip-run",
                                 "--device", "cpu"]) == 0
    got = buf.getvalue().splitlines()
    assert got[0] == want[0] and got[0].startswith("| KITTI-geometry street")
    assert json.loads(got[1]) == json.loads(want[1])
    scores = json.loads(got[1])
    assert scores["n_segments"] > 0 and 60 < scores["path_len_m"] < 70
    with open(os.path.join(runs_root, "run_street", "street_row.txt")) as f:
        assert f.read() == got[0] + "\n"


def test_fixture_eval_scores_match_the_jax_functions(runs_root):
    res = run_fixture_eval.score_runs(runs_root)
    assert set(res) == {"run_tum", "run_kitti", "run_mono"}
    r = JAX_EVAL  # the JAX script's readers and the JAX evaluation
    est = os.path.join(runs_root, "run_tum", "CameraTrajectory.txt")
    gt = os.path.join(runs_root, "tum_fixture", "groundtruth.txt")
    ts_e, R_e, t_e = r.read_tum_full(est)
    ts_g, R_g, t_g = r.read_tum_full(gt)
    pairs = r.associate(ts_e, ts_g)
    ia, ib = [p[0] for p in pairs], [p[1] for p in pairs]
    c_e = np.stack([-(R.T @ t) for R, t in zip(R_e[ia], t_e[ia])])
    c_g = np.stack([-(R.T @ t) for R, t in zip(R_g[ib], t_g[ib])])
    rp = jax_rpe(R_e[ia], t_e[ia], R_g[ib], t_g[ib], delta=1)
    assert res["run_tum"] == {
        "tracked": 36, "ate_rmse_m": float(jax_ate(c_e, c_g)),
        "rpe_trans_rmse_m": rp["trans_rmse"],
        "rpe_rot_rmse_deg": float(np.degrees(rp["rot_rmse"]))}
    est = os.path.join(runs_root, "run_kitti", "CameraTrajectory.txt")
    gt = os.path.join(runs_root, "kitti_fixture", "poses_gt.txt")
    R_e, t_e = r.read_kitti_full(est)
    R_g, t_g = r.read_kitti_full(gt)
    d = jax_drift(R_e, t_e, R_g, t_g, lengths=(1, 2))
    assert res["run_kitti"] == {
        "frames": 30, "tracked": 30,
        "ate_rmse_m": float(jax_ate(r.read_kitti(est), r.read_kitti(gt))),
        "drift_trans_pct": d["trans_pct"],
        "drift_rot_deg_per_m": d["rot_deg_per_m"]}
    ts_e, c_e = r.read_tum(os.path.join(runs_root, "run_mono",
                                        "KeyFrameTrajectory.txt"))
    ts_g, c_g = r.read_tum(os.path.join(runs_root, "tum_fixture",
                                        "groundtruth.txt"))
    pairs = r.associate(ts_e, ts_g)
    ate = jax_ate(c_e[[p[0] for p in pairs]], c_g[[p[1] for p in pairs]],
                  with_scale=True)
    assert res["run_mono"] == {"tracked": 10, "ate_rmse_m_scaled": ate}
    out = os.path.join(runs_root, "table.md")
    with contextlib.redirect_stdout(io.StringIO()):
        assert run_fixture_eval.main(["--root", runs_root, "--skip-run",
                                      "--frames", "40", "--out", out]) == 0
    with open(out) as f:
        text = f.read()
    for row in run_fixture_eval.table_rows(res, 40).values():
        assert row in text
    assert f"| {res['run_tum']['ate_rmse_m'] * 100:.1f} cm |" in text
    assert "Pending (no trajectory file yet)" in text
    assert run_fixture_eval.LABELS["run_euroc"] in text.split("Pending")[1]


def test_eval_vocab_world_matches_the_script():
    jax_vocab = _script("eval_vocab")
    views = eval_vocab.world_views(200)
    voc = V.load_vocabulary(V.DEFAULT_PATH, "cpu")
    got = eval_vocab.evaluate(voc, "88.5k", [views], "cpu")
    jvoc = jax_vocab.load_vocabulary(os.path.join(
        ROOT, "orb_slam2_with_comment_tpu", "place", "data",
        "vocab_default.npz"), as_numpy=True)
    ext = jax_vocab.OrbExtractor(n_features=eval_vocab.N_FEATURES)
    rng = np.random.default_rng(77)
    img_a, img_b, img_n1, img_n2 = views
    va = jax_vocab.vec(jvoc, ext, img_a)
    rows = [jax_vocab.vec(jvoc, ext, im) for im in (
        jax_vocab.jitter(img_a, rng), jax_vocab.jitter(img_b, rng), img_n1,
        img_n2)]
    want = np.asarray(jax_vocab.score_l1_sparse(
        va[0], va[1], jnp.stack([r[0] for r in rows]),
        jnp.stack([r[1] for r in rows]), int(jvoc.n_words)))
    np.testing.assert_allclose(np.concatenate([got["same"], got["diff"]]),
                               want, rtol=0, atol=1e-6)
    jax_vocab.HELD_OUT_SEEDS = range(200, 201)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        recall = jax_vocab.evaluate(jvoc, "88.5k")
    assert buf.getvalue().strip() == got["row"]
    assert recall == got["recall"] == 1.0


@pytest.mark.parametrize("scene", ["room", "street"])
def test_device_renderer_matches_the_numpy_render(scene):
    if scene == "room":
        world, poses = SyntheticWorld(seed=1), orbit_trajectory(16)[3:5]
        cam = dict(fx=125.0, fy=125.0, cx=80.0, cy=60.0, width=160,
                   height=120)
    else:  # the KITTI camera at a quarter of its width
        world = StreetWorld(seed=3)
        poses = street_trajectory(world, 40, laps=1.08)[7:9]
        cam = dict(fx=179.714, fy=179.714, cx=151.798, cy=46.304,
                   width=310, height=94)
    got = synthetic.render_views(world, poses, "cpu", **cam)
    again = fixtures.render_views(("street", 3, False) if scene == "street"
                                  else ("room", 1, False), poses, cam,
                                  device="cpu")
    for (img, depth), (img2, depth2), (R, t) in zip(got, again, poses):
        np.testing.assert_array_equal(img, img2)
        want_img, want_depth = world.render(R, t, **cam)
        a = np.clip(img, 0, 255).astype(np.uint8).astype(int)
        b = np.clip(want_img, 0, 255).astype(np.uint8).astype(int)
        assert np.abs(a - b).max() <= 1 and (a != b).mean() <= 1e-3
        assert (depth > 0).mean() > 0.5
        np.testing.assert_allclose(depth, want_depth, rtol=1e-5, atol=0)
