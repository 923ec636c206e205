"""The output check: what the window produced, against the plain reference
and the ground truth the traffic was rendered from.

During the window ``Capture`` keeps, for a sample of the window's frames
drawn from the seed, what the timed path produced: the front end's
keypoints, descriptors, right coordinates and depths, and the last
one-pose problem the pose solver was given in that frame with its result.
The capture wraps the program's calls from outside and copies those
tensors on the device; it reads nothing back inside the window.

After the window, with the tracker's trajectory read back and its state
freed, ``compare`` works out, for each number, how far the program lies
from the reference:

- ``orb_mismatch_pct``: of the sampled frames' keypoints, the program's and
  the reference's (``reference/frontend.extract`` on the same image), the
  share that the other side lacks, position, octave and all 256 descriptor
  bits compared exactly;
- ``stereo_mismatch_pct`` (stereo): of the left keypoints both sides have,
  with a match on either side, the share whose right coordinate or depth
  differs (``reference/frontend.stereo_depth`` on the reference's own
  left and right keypoints);
- ``search_mismatch_pct``: of the matches the sampled frames' tracking
  searches made (the two motion-model projection searches, the reference
  keyframe's sweep and the local-map projection search, each on K1), the
  program's and the reference's (``reference/search``, on the inputs the
  program's search was given: the predicted or optimized pose, the last
  frame's landmarks or the local map's, the frame's features), the share
  that the other side lacks, each match a (query, feature) pair;
- ``pose_gap_mm``: the largest distance, over the sampled frames, between
  the frame's pose in the trajectory and the reference's pose-only LM
  (``reference/pose.optimize_pose``) on the problem the program's solver
  was given for it (the landmarks and the matches are the program's state:
  the reference follows it from there);
- ``ba_pose_gap_mm`` and ``ba_point_gap_mm``: for the first local BA
  solves from the first sampled frame on (``BA_CAPTURES``), the largest
  camera-centre distance over the free keyframes, and the largest distance
  over the landmarks, between the program's result and the reference's
  dense LM (``reference/ba.solve``) on the problem the program's solver
  was given (the map it gathered the window from is the program's state);
- ``rpe_mm``: the median, over the window's frames, of the error of the
  relative motion over ``rpe_step`` frames against the ground truth. It is
  reported, not judged: the lower-precision control leaves the trajectory
  as it is, so this number has no control reading to set a limit below.
  So are ``t_err_mm`` and ``rot_err_deg``, the median errors of the
  window's poses against the ground truth (``pose_errors``).

``judge`` holds the numbers that ``limits/<workload>.json`` lists.

``dt`` selects the reference's precision: float32, or bfloat16 for the
control.
"""
from __future__ import annotations

import inspect

import numpy as np
import torch

from .reference import ba as ref_ba
from .reference import frontend as ref_frontend
from .reference import pose as ref_pose
from .reference import search as ref_search

BA_CAPTURES = 2  # local BA solves kept, from the first sampled frame on


class Capture:
    """Copies of what the timed path produced on the sampled frames."""

    def __init__(self, tracker, pose_module, ba_module, samples,
                 steps_module, search_module):
        self.samples = set(samples)
        self.frontend = {}  # frame -> dict of device tensors
        self.problems = {}  # frame -> the frame's last one-pose problem
        self.ba = []  # (frame, problem, the program's result)
        self.searches = []  # (frame, kind, inputs, the program's matches)
        self._current = -1
        self._tracking = False
        step = tracker._step
        run_frame = step.run_frame

        def capture_frame(s, feats, d):
            self._current = s.frame_idx
            if s.frame_idx in self.samples:
                self.frontend[s.frame_idx] = {
                    "xy": feats.xy.clone(), "octave": feats.octave.clone(),
                    "desc": feats.desc.clone(), "valid": feats.valid.clone(),
                    "ur": feats.ur.clone(), "depth": d.clone()}
            return run_frame(s, feats, d)

        solve = pose_module.optimize_pose

        def capture_solve(cam, R0, t0, Xw, obs_uvr, inv_sigma2, valid,
                          *args, **kwargs):
            res = solve(cam, R0, t0, Xw, obs_uvr, inv_sigma2, valid, *args,
                        **kwargs)
            if self._current in self.samples and valid.shape[0] == 1:
                self.problems[self._current] = {
                    "cam": tuple(cam), "R0": R0.clone(), "t0": t0.clone(),
                    "Xw": Xw.clone(), "obs_uvr": obs_uvr.clone(),
                    "inv_sigma2": inv_sigma2.clone(),
                    "valid": valid.clone(), "inliers": res.inliers.clone()}
            return res

        ba_solve = ba_module.ba_solve
        first = min(self.samples)

        def capture_ba(cam, prob, iters=10, robust=True, init_lambda=1e-4,
                       *args, **kwargs):
            res = ba_solve(cam, prob, iters, robust, init_lambda, *args,
                           **kwargs)
            if self._current >= first and len(self.ba) < BA_CAPTURES:
                lam = (init_lambda.clone()
                       if isinstance(init_lambda, torch.Tensor)
                       else init_lambda)
                self.ba.append((self._current, {
                    "cam": tuple(cam), "iters": iters, "robust": robust,
                    "init_lambda": lam,
                    "prob": {k: v.clone() for k, v in prob._asdict().items()},
                    "R": res.R.clone(), "t": res.t.clone(),
                    "X": res.X.clone()}))
            return res

        self._restore = (step, pose_module, solve, ba_module, ba_solve)
        step.run_frame = capture_frame
        pose_module.optimize_pose = capture_solve
        ba_module.ba_solve = capture_ba
        self._patched = []
        core = steps_module.track_frame_core

        def tracking(*args, **kwargs):
            self._tracking = True
            try:
                return core(*args, **kwargs)
            finally:
                self._tracking = False

        self._patch(steps_module, "track_frame_core", tracking)
        for kind, name in SEARCH_CALLS.items():
            self._patch(search_module, name, self._search_capture(
                kind, getattr(search_module, name)))

    def _patch(self, module, name, fn):
        self._patched.append((module, name, getattr(module, name)))
        setattr(module, name, fn)

    def _search_capture(self, kind, fn):
        sig = inspect.signature(fn)

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self._tracking and self._current in self.samples:
                a = sig.bind(*args, **kwargs)
                a.apply_defaults()
                self.searches.append((self._current, kind, _search_inputs(
                    kind, a.arguments), tuple(x.clone() for x in out)))
            return out
        return wrapped

    def remove(self):
        step, pose_module, solve, ba_module, ba_solve = self._restore
        step.__dict__.pop("run_frame", None)
        pose_module.optimize_pose = solve
        ba_module.ba_solve = ba_solve
        for module, name, fn in reversed(self._patched):
            setattr(module, name, fn)
        self._patched = []


# the tracking searches, by their names in matching/search.py, which
# pipeline/steps.py calls through its module
SEARCH_CALLS = {"motion_model": "search_by_projection_frame",
                "local_points": "search_local_points",
                "brute": "search_brute"}


def _search_inputs(kind: str, a: dict) -> dict:
    """Copies of what a search was given, under the names
    ``reference/search`` reads."""
    c = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
         for k, v in a.items()}
    if kind == "brute":
        return {"desc_q": c["desc_q"], "desc_t": c["desc_t"],
                "valid_q": c["valid_q"], "valid_t": c["valid_t"],
                "ratio": c["ratio"], "max_dist": c["max_dist"],
                "angle_q": c["angle_q"], "angle_t": c["angle_t"]}
    f = c["feats"]
    out = {"cam": tuple(float(x) for x in c["cam"]), "R": c["R"],
           "t": c["t"], "th": float(c["th"]), "desc_th": c["desc_th"],
           "xy": f.xy, "ur": f.ur, "octave": f.octave, "angle": f.angle,
           "desc": f.desc, "valid": f.valid}
    if kind == "motion_model":
        pf = c["prev_feats"]
        out.update(prev_pw=c["prev_pw"], prev_octave=pf.octave,
                   prev_angle=pf.angle, prev_desc=pf.desc,
                   prev_valid=pf.valid, prev_has_point=c["prev_has_point"],
                   width=float(c["width"]), height=float(c["height"]))
    else:  # local_points: the frustum is the reference's to work out
        lm, n = c["lm"], f.xy.shape[0]
        already = c["already_matched"]
        out.update(pw=lm.pw, normal=lm.normal, dmin=lm.dmin, dmax=lm.dmax,
                   lm_desc=lm.desc, lm_valid=lm.valid,
                   already=(already if already is not None else
                            torch.zeros(n, dtype=torch.bool)))
    return out


def sample_frames(seed: int, first: int, span: int, n: int) -> list:
    """``n`` distinct frames of ``first`` .. ``first + span - 1``, drawn
    from the seed."""
    rng = np.random.default_rng([abs(int(seed)), 7])
    return sorted(int(first + k) for k in rng.choice(span, n, replace=False))


def _keys(xy, octave, desc, valid) -> set:
    xy, octave, desc, valid = (a.cpu().numpy() for a in (xy, octave, desc,
                                                         valid))
    return {(int(o), float(x), float(y), d.tobytes())
            for (x, y), o, d, v in zip(xy, octave, desc, valid) if v}


def _pose_gap_mm(R_a, t_a, R_b, t_b) -> float:
    """Distance in mm between the camera centres of two world->camera
    poses."""
    c_a = -R_a.T @ t_a
    c_b = -R_b.T @ t_b
    return 1000.0 * float(np.linalg.norm(c_a - c_b))


def rpe_mm(R, t, valid, gt, first: int, last: int, step: int):
    """Median error (mm) of the motion over ``step`` frames of frames
    ``first + step`` .. ``last - 1`` against the ground truth; None where no
    pair of valid frames exists. R, t, valid are indexed by frame; ``gt(i)``
    gives frame i's true (R, t)."""
    errs = []
    for i in range(first + step, last):
        j = i - step
        if not (valid[i] and valid[j]):
            continue
        Rg_i, tg_i = gt(i)
        Rg_j, tg_j = gt(j)
        rel_est = t[i] - R[i] @ R[j].T @ t[j]
        rel_gt = tg_i - Rg_i @ Rg_j.T @ tg_j
        errs.append(float(np.linalg.norm(rel_est - rel_gt)))
    return 1000.0 * float(np.median(errs)) if errs else None


def pose_errors(R, t, valid, gt, first: int, last: int):
    """(median translation error in mm, median rotation error in degrees)
    of the valid frames ``first`` .. ``last - 1`` against the ground truth
    expressed from frame 0, where the tracker puts its world; None where
    no frame is valid. The arithmetic of the port's ``bench.py``
    ``pose_errors`` at commit 41c5463."""
    R0, t0 = gt(0)
    t_err, r_err = [], []
    for i in range(first, last):
        if not valid[i]:
            continue
        Rg, tg = gt(i)
        Rg, tg = Rg @ R0.T, tg - Rg @ R0.T @ t0
        t_err.append(np.linalg.norm(t[i] - tg))
        r_err.append(np.degrees(np.arccos(np.clip(
            (np.trace(R[i] @ Rg.T) - 1) / 2, -1, 1))))
    if not t_err:
        return None, None
    return 1000.0 * float(np.median(t_err)), float(np.median(r_err))


def _frontend_numbers(cap: Capture, seq, cfg: dict, device, dt) -> dict:
    n_feat = int(cfg["ORBextractor.nFeatures"])
    stereo = cfg["sensor"] == "stereo"
    total = miss = s_total = s_miss = 0
    for f, got in sorted(cap.frontend.items()):
        left, right = seq.frame(f)
        want, pyr_l = ref_frontend.extract(
            torch.as_tensor(left).to(device), n_feat, dt)
        k_got = _keys(got["xy"], got["octave"], got["desc"], got["valid"])
        k_want = _keys(want.xy, want.octave, want.desc, want.valid)
        total += len(k_got) + len(k_want)
        miss += len(k_got ^ k_want)
        if not stereo:
            continue
        want_r, pyr_r = ref_frontend.extract(
            torch.as_tensor(right).to(device), n_feat, dt)
        ur, depth = ref_frontend.stereo_depth(
            want, want_r, pyr_l, pyr_r, n_feat, cfg["Camera.bf"],
            cfg["Camera.fx"])
        w_at = _stereo_at(want.xy, want.octave, want.valid, ur, depth)
        g_at = _stereo_at(got["xy"], got["octave"], got["valid"], got["ur"],
                          got["depth"])
        for key in w_at.keys() & g_at.keys():
            a, b = w_at[key], g_at[key]
            if a[1] >= 0 or b[1] >= 0:  # a match on either side
                s_total += 1
                s_miss += a != b
    out = {"orb_mismatch_pct": 100.0 * miss / total if total else None}
    if stereo:
        out["stereo_mismatch_pct"] = (100.0 * s_miss / s_total if s_total
                                      else None)
    return out


def _pose_numbers(cap: Capture, out: dict, dt) -> dict:
    gaps, detail = [], []
    for f, p in sorted(cap.problems.items()):
        if not out["valid"][f] or (f > 0 and out["stats"][f][7]
                                   != out["stats"][f - 1][7]):
            continue  # lost, or a closed loop re-expressed the pose
        R, t, inl = ref_pose.optimize_pose(
            p["cam"], p["R0"], p["t0"], p["Xw"], p["obs_uvr"],
            p["inv_sigma2"], p["valid"], dt)
        gaps.append(_pose_gap_mm(out["R"][f], out["t"][f],
                                 R[0].cpu().numpy(), t[0].cpu().numpy()))
        # (frame, gap mm, edges, the program's inliers, the reference's,
        # edges the two classify differently)
        detail.append((f, round(gaps[-1], 6), int(p["valid"].sum()),
                       int(p["inliers"].sum()), int(inl.sum()),
                       int((p["inliers"] != inl).sum())))
    return {"pose_gap_mm": max(gaps) if gaps else None,
            "_pose_detail": detail,
            "_pose_skipped": len(cap.problems) - len(gaps)}


def _search_numbers(cap: Capture, cfg: dict, dt) -> dict:
    total = miss = 0
    detail = []
    for f, kind, p, (idx, _, matched) in cap.searches:
        if kind == "local_points":
            p = dict(p, width=float(cfg["Camera.width"]),
                     height=float(cfg["Camera.height"]))
        want = ref_search.SEARCHES[kind](p, dt)
        got_idx, got_ok = idx.cpu().numpy(), matched.cpu().numpy()
        got = {int(q): int(got_idx[q]) for q in np.flatnonzero(got_ok)}
        diff = len(set(got.items()) ^ set(want.items()))
        total += len(got) + len(want)
        miss += diff
        # (frame, search, the program's matches, the reference's, pairs
        # one side lacks)
        detail.append((f, kind, len(got), len(want), diff))
    return {"search_mismatch_pct": 100.0 * miss / total if total else None,
            "_search_detail": detail}


def _ba_numbers(cap: Capture, dt) -> dict:
    pose_gaps, point_gaps, point_medians = [], [], []
    for _, b in cap.ba:
        R, t, X = ref_ba.solve(b["cam"], b["prob"], b["iters"], b["robust"],
                               b["init_lambda"], dt)
        prob = b["prob"]
        free = ~prob["pose_fixed"]
        if bool(free.any()):
            c_ref = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
            c_got = -(b["R"].transpose(-1, -2) @ b["t"][..., None])[..., 0]
            pose_gaps.append(1000.0 * float(
                (c_ref - c_got)[free].norm(dim=-1).max()))
        pts = prob["point_valid"]
        if bool(pts.any()):
            gap = 1000.0 * (X - b["X"])[pts].norm(dim=-1)
            point_gaps.append(float(gap.max()))
            point_medians.append(float(gap.median()))
    return {"ba_pose_gap_mm": max(pose_gaps) if pose_gaps else None,
            "ba_point_gap_mm": max(point_gaps) if point_gaps else None,
            "_ba_point_median": point_medians}


def compare(cap: Capture, seq, cfg: dict, out: dict, first: int, last: int,
            rpe_step: int, device, dt=torch.float32) -> dict:
    """Each number the check compares, None where it has no reading, and
    the ground-truth numbers reported beside them. ``out`` is the
    tracker's ``finalize()``; the window is frames ``first`` .. ``last -
    1``."""
    numbers = _frontend_numbers(cap, seq, cfg, device, dt)
    numbers.update(_search_numbers(cap, cfg, dt))
    numbers.update(_pose_numbers(cap, out, dt))
    numbers.update(_ba_numbers(cap, dt))
    numbers["rpe_mm"] = rpe_mm(out["R"], out["t"], out["valid"], seq.pose,
                               first, last, rpe_step)
    numbers["t_err_mm"], numbers["rot_err_deg"] = pose_errors(
        out["R"], out["t"], out["valid"], seq.pose, first, last)
    return numbers


def _stereo_at(xy, octave, valid, ur, depth) -> dict:
    """(octave, x, y) of each valid left keypoint -> (u_right, depth)."""
    xy, octave, valid, ur, depth = (a.cpu().numpy() for a in (
        xy, octave, valid, ur, depth))
    return {(int(o), float(x), float(y)): (float(u), float(d))
            for (x, y), o, u, d, v in zip(xy, octave, ur, depth, valid) if v}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, each number beside its limit): a number with no reading
    fails."""
    shown = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value <= limit
        ok = ok and good
        shown[name] = {"value": value, "limit": limit}
    return ok, shown
