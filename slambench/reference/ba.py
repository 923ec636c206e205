"""Plain local bundle adjustment: the reference the map that keyframe
maintenance leaves is compared with.

A frozen copy of the port's ``ba_solve_plain`` (``optim/ba.py``: the
linearization over the [L, D] observation table, the dense reduced camera
system by the Schur complement, its solve, back-substitution, the accept
test and the damping, then one orthonormalization) at commit 41c5463. It
imports nothing of the port. A problem is a dict with the port's
``BAProblem`` fields: R [P, 3, 3], t [P, 3], X [L, 3], obs_pose [L, D],
obs_uvr [L, D, 3] (u_r < 0: mono), obs_w [L, D] (0: absent), pose_fixed
[P], point_valid [L].

``dt`` is the precision of everything but the reduced system's solve:
float32 for the reference, bfloat16 for the control (float32 solve).
"""
from __future__ import annotations

import torch

from .pose import HUBER_MONO, HUBER_STEREO, _huber, exp_se3, f32, hat


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A, B, C = e * i - f * h, c * h - b * i, b * f - c * e
    Dd, E, F = f * g - d * i, a * i - c * g, c * d - a * f
    G, H, Ii = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A + b * Dd + c * G
    inv_det = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)
    adj = torch.stack([torch.stack([A, B, C], -1), torch.stack([Dd, E, F], -1),
                       torch.stack([G, H, Ii], -1)], -2)
    return adj * inv_det[..., None, None]


def _project(Robs, tobs, X):
    Xc = (Robs @ X[:, None, :, None])[..., 0] + tobs
    z = Xc[..., 2]
    return Xc[..., 0], Xc[..., 1], torch.where(z.abs() < 1e-9, 1e-9, z)


def _components(cam, p, R, t, X):
    fx, fy, cx, cy, bf = cam
    Robs, tobs = R[p["obs_pose"]], t[p["obs_pose"]]
    x, y, z = _project(Robs, tobs, X)
    iz = 1.0 / z
    iz2 = iz * iz
    obs = p["obs_uvr"]
    srow = (obs[..., 2] >= 0).to(x.dtype)
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    ur = u - bf * iz
    e = torch.stack([obs[..., 0] - u, obs[..., 1] - v,
                     (obs[..., 2] - ur) * srow], -1)
    zero = torch.zeros_like(x)
    Jproj = torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz2], -1),
        torch.stack([zero, fy * iz, -fy * y * iz2], -1),
        torch.stack([(fx * iz) * srow, zero,
                     (-fx * x * iz2 + bf * iz2) * srow], -1)], -2)
    Xc = torch.stack([x, y, z], -1)
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(Jproj.shape)
    Jp = -(Jproj @ torch.cat([eye, -hat(Xc)], -1))
    Jl = -(Jproj @ Robs)
    return e, Jp, Jl


def _chi2(cam, p, w_active, R, t, X):
    fx, fy, cx, cy, bf = cam
    x, y, z = _project(R[p["obs_pose"]], t[p["obs_pose"]], X)
    iz = 1.0 / z
    obs = p["obs_uvr"]
    srow = (obs[..., 2] >= 0).to(x.dtype)
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    ur = u - bf * iz
    e2 = ((obs[..., 0] - u) ** 2 + (obs[..., 1] - v) ** 2
          + ((obs[..., 2] - ur) * srow) ** 2)
    return e2 * w_active


def solve(cam, prob: dict, iters: int, robust: bool, init_lambda,
          dt=torch.float32):
    """(R [P, 3, 3], t [P, 3], X [L, 3]) of ``iters`` LM iterations of the
    dense local BA from the problem's state. ``cam`` is (fx, fy, cx, cy,
    bf)."""
    cam = tuple(f32(v) for v in cam)
    p = {k: (v.to(dt) if v.is_floating_point() else v)
         for k, v in prob.items()}
    P = p["R"].shape[0]
    dev = p["X"].device
    R, t, X = p["R"], p["t"], p["X"]
    lam = (init_lambda.to(dev, torch.float32).reshape(())
           if isinstance(init_lambda, torch.Tensor)
           else torch.full((), init_lambda, dtype=torch.float32, device=dev))
    delta_h = torch.where(p["obs_uvr"][..., 2] >= 0, HUBER_STEREO,
                          HUBER_MONO)
    active = (p["obs_w"] > 0) & p["point_valid"][:, None]
    w_active = torch.where(active, p["obs_w"], 0.0).to(dt)
    free_obs = (~p["pose_fixed"])[p["obs_pose"]].to(dt)
    G = torch.nn.functional.one_hot(p["obs_pose"], P).to(dt)
    ar = torch.arange(P, device=dev)
    free_pose = ~p["pose_fixed"]
    keep = (free_pose[:, None] & free_pose[None, :]).to(torch.float32)
    fixed_blk = torch.where(p["pose_fixed"][:, None, None],
                            torch.eye(6, device=dev), 0.0)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    for _ in range(iters):
        e, Jp, Jl = _components(cam, p, R, t, X)
        chi2_i = (e * e).sum(-1) * p["obs_w"]
        w_rob = _huber(chi2_i, delta_h) if robust else 1.0
        w = (w_active * w_rob).to(dt)
        Jp = Jp * free_obs[..., None, None]
        wJp = Jp * w[..., None, None]
        wJl = Jl * w[..., None, None]
        Hll = torch.einsum("ldri,ldrj->lij", wJl, Jl)
        bl = torch.einsum("ldri,ldr->li", wJl, e)
        Y = torch.einsum("ldri,ldrj->ldij", wJp, Jl)
        diag_ll = torch.diagonal(Hll, dim1=-2, dim2=-1).clamp(min=1e-6)
        Hll_d = Hll + lam.to(dt) * torch.diag_embed(diag_ll)
        Hll_d = torch.where(p["point_valid"][:, None, None], Hll_d, eye3)
        Hll_inv = _inv3x3(Hll_d)
        chi2_old = torch.where(active, chi2_i, 0.0).to(torch.float32).sum()
        Hpp = torch.einsum("ldri,ldrj,ldp->pij", wJp, Jp, G)
        bp = torch.einsum("ldri,ldr,ldp->pi", wJp, e, G)
        A = torch.einsum("ldp,ldik->lpik", G, Y @ Hll_inv[:, None])
        Bm = torch.einsum("ldp,ldjk->lpjk", G, Y)
        S_off = torch.einsum("lpik,lqjk->pqij", A, Bm).to(torch.float32)
        Hpp = Hpp.to(torch.float32)
        diag_pp = torch.diagonal(Hpp, dim1=-2, dim2=-1).clamp(min=1e-6)
        S = -S_off
        S[ar, ar] += Hpp + lam * torch.diag_embed(diag_pp)
        b_s = (bp - torch.einsum("lpik,lk->pi", A, bl)).to(torch.float32)
        S = S * keep[..., None, None]
        S[ar, ar] += fixed_blk
        b_s = torch.where(p["pose_fixed"][:, None], 0.0, b_s)
        sol, _ = torch.linalg.solve_ex(
            S.permute(0, 2, 1, 3).reshape(P * 6, P * 6), b_s.reshape(-1, 1))
        dxi = (-sol.reshape(P, 6)).to(dt)
        rhs_l = bl + torch.einsum("ldij,ldi->lj", Y, dxi[p["obs_pose"]])
        dX = -(Hll_inv @ rhs_l[..., None])[..., 0]
        dX = torch.where(p["point_valid"][:, None], dX, 0.0)
        dR, dtt = exp_se3(dxi)
        R_new = dR @ R
        t_new = (dR @ t[..., None])[..., 0] + dtt
        X_new = X + dX
        chi2_new = _chi2(cam, p, w_active, R_new, t_new, X_new).to(
            torch.float32).sum()
        ok = ((chi2_new < chi2_old) & torch.isfinite(dxi).all()
              & torch.isfinite(dX).all())
        R = torch.where(ok, R_new, R)
        t = torch.where(ok, t_new, t)
        X = torch.where(ok, X_new, X)
        lam = torch.where(ok, lam * 0.5, lam * 5.0).clamp(1e-9, 1e8)
    rtr = R.transpose(-1, -2) @ R
    R = R @ (1.5 * torch.eye(3, dtype=R.dtype, device=dev) - 0.5 * rtr)
    return R.to(torch.float32), t.to(torch.float32), X.to(torch.float32)
