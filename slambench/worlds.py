"""The benchmark's scenes and camera paths, rendered on the card.

A frozen copy of ``orb_slam2_with_comment_tpu_torch/dataio/synthetic.py``
at commit 41c5463 (``_Plane``, ``SyntheticWorld``'s open room,
``render_views`` and ``orbit_trajectory``), so that no later change of the
program changes the benchmark's inputs. What differs from the original:

- ``StreetCanyon`` is new: an open street that curves gently and never
  comes back, built from ``StreetWorld``'s parts (facades at
  +-``street_half``, a ground plane, small billboards facing along the
  street), in tiles, each with textures of its own seed.
- ``render_frames`` renders a plane only inside the box its corners project
  to in the batch's views (a plane is convex, so no pixel outside that box
  can hit it); the pixels inside get ``render_views``' arithmetic
  unchanged. Images leave the card as uint8 (truncated, as
  ``np.clip(img, 0, 255).astype(np.uint8)`` truncates) and depth as
  float32 metres.
- ``orbit_poses`` samples one closed lap of ``orbit_trajectory``'s arc at
  ``n`` distinct poses (``s = k / n``), so laps play back to back without a
  repeated pose.
"""
from __future__ import annotations

import numpy as np
import torch


class _Plane:
    def __init__(self, p0, ea, eb, half_a, half_b, rng, cell=0.3):
        self.p0 = np.asarray(p0, np.float32)
        self.ea = np.asarray(ea, np.float32)
        self.eb = np.asarray(eb, np.float32)
        self.n = np.cross(self.ea, self.eb).astype(np.float32)
        self.half_a = half_a
        self.half_b = half_b
        self.cell = cell
        self.far = 150.0  # not drawn where wholly beyond this depth (m)
        na = int(2 * half_a / cell) + 5
        nb = int(2 * half_b / cell) + 5
        # coarse corner-bearing blocks + a weak fine octave
        self.tex = rng.uniform(40, 240, (na, nb)).astype(np.float32)
        self.tex2 = rng.uniform(-14, 14, (2 * na, 2 * nb)).astype(np.float32)
        self.phase = rng.uniform(0, 6.28, 4).astype(np.float32)

    def corners(self) -> np.ndarray:
        """[4, 3] world corners."""
        a = self.half_a * self.ea
        b = self.half_b * self.eb
        return np.stack([self.p0 + sa * a + sb * b
                         for sa in (-1, 1) for sb in (-1, 1)])


class Room:
    """``SyntheticWorld(seed)``: a textured room (back wall, floor,
    ceiling, two side walls) with 14 fronto-parallel pillars at 1.1-2.6 m,
    TUM-desk-like working distances, and no depth noise."""

    def __init__(self, seed: int):
        rng = np.random.RandomState(seed)
        W, H, Z = 2.2, 1.2, 3.2  # half-width, half-height, wall distance
        wc = 0.3
        self.planes = [
            _Plane([0, 0, Z], [1, 0, 0], [0, 1, 0], 4.5, 2.5, rng, cell=wc),
            _Plane([0, H, 0], [1, 0, 0], [0, 0, 1], 4.5, 8.0, rng, cell=wc),
            _Plane([0, -H, 0], [1, 0, 0], [0, 0, 1], 4.5, 8.0, rng, cell=wc),
            _Plane([-W, 0, 0], [0, 0, 1], [0, 1, 0], 8.0, 2.5, rng, cell=wc),
            _Plane([W, 0, 0], [0, 0, 1], [0, 1, 0], 8.0, 2.5, rng, cell=wc),
        ]
        for _ in range(14):
            px = rng.uniform(-1.8, 1.8)
            py = rng.uniform(-0.9, 0.9)
            pz = rng.uniform(1.1, 2.6)
            half = rng.uniform(0.18, 0.4)
            self.planes.append(_Plane([px, py, pz], [1, 0, 0], [0, 1, 0],
                                      half, half, rng, cell=0.1))


def orbit_poses(n: int, x_amp=0.35, y_amp=0.08, z_amp=0.12,
                yaw_amp=0.03) -> list:
    """One lap of ``orbit_trajectory``'s lateral arc with small yaw at
    ``n`` poses, world->camera (R, t); pose 0 is the identity."""
    poses = []
    for k in range(n):
        s = k / n
        C = np.array([x_amp * np.sin(2 * np.pi * s),
                      y_amp * np.sin(4 * np.pi * s),
                      z_amp * np.sin(2 * np.pi * s)], np.float32)
        yaw = yaw_amp * np.sin(2 * np.pi * s)
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        Rwc = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]], np.float32)
        R = Rwc.T
        poses.append((R, (-R @ C).astype(np.float32)))
    return poses


class StreetCanyon:
    """An open street for a forward drive: the path's heading is
    ``curve_rad * sin(2 pi s / curve_period_m)`` at arclength s (a gentle
    S-curve whose z only grows, so the path never comes back), the camera
    at height 0 with the ground at ``y_ground`` below.

    The street is built of tiles ``tile_m`` long. A tile is a facade on
    each side at +-``street_half``, the ground, and every
    ``board_every_m`` on each side a small billboard facing along the
    street at 1.8 m from the path (as ``StreetWorld`` places them), so a
    driving camera sees fronto-parallel structure as well as grazing
    facades; its textures and billboards come from its own seed, so a tile
    looks the same wherever it lies. Tiles ``0 .. n_tiles - 1`` from s = 0
    on are the drive's: ``order`` says which of the ``n_tiles`` tile seeds
    each one takes. The tiles behind s = 0 and beyond take seeds of their
    own, the same whatever the order."""

    def __init__(self, base_seed: int, order, length_m: float, tile_m=11.0,
                 curve_rad=0.25, curve_period_m=200.0, street_half=2.5,
                 wall_half_h=1.6, y_ground=1.5, board_every_m=4.0,
                 start_m=-22.0):
        self.curve_rad = float(curve_rad)
        self.curve_period = float(curve_period_m)
        self.ds = 0.01
        end = length_m + 200.0  # geometry beyond the last pose's view
        s = np.arange(start_m, end + self.ds, self.ds)
        self._s0 = float(start_m)
        th = self.heading(s)
        step = np.stack([np.sin(th), np.zeros_like(th), np.cos(th)], 1)
        xyz = np.cumsum(step, 0) * self.ds
        xyz -= xyz[int(round(-start_m / self.ds))]
        self._xyz = xyz.astype(np.float64)
        order = list(order)
        down = np.array([0.0, 1.0, 0.0], np.float32)
        planes = []
        for k in range(int(np.floor(start_m / tile_m)),
                       int(np.ceil(end / tile_m))):
            tile = order[k] if 0 <= k < len(order) else len(order) + 1000 + k
            rng = np.random.RandomState(base_seed * 7919 + tile)
            s0 = k * tile_m
            mid = s0 + 0.5 * tile_m
            P, fwd = self.position(mid), self.forward(mid)
            right = np.cross(down, fwd).astype(np.float32)
            half = 0.5 * tile_m + 0.3  # overlap at the joints
            for side in (1.0, -1.0):
                planes.append(_Plane(P + side * street_half * right, fwd,
                                     down, half, wall_half_h, rng))
            planes.append(_Plane(P + np.array([0, y_ground, 0], np.float32),
                                 fwd, right, half, street_half + 1.0, rng))
            for sb in np.arange(s0 + 1.0, s0 + tile_m, board_every_m):
                P, fwd = self.position(sb), self.forward(sb)
                right = np.cross(down, fwd).astype(np.float32)
                for side in (1.0, -1.0):
                    c = P + side * (street_half - 0.7) * right
                    c = c + np.array([0, rng.uniform(-0.5, 0.5), 0],
                                     np.float32)
                    board = _Plane(c, right, down, rng.uniform(0.3, 0.55),
                                   rng.uniform(0.3, 0.55), rng, cell=0.12)
                    board.far = 80.0  # under 7 px beyond
                    planes.append(board)
        self.planes = planes

    def heading(self, s):
        return self.curve_rad * np.sin(2 * np.pi * np.asarray(s)
                                       / self.curve_period)

    def position(self, s: float) -> np.ndarray:
        i = int(round((s - self._s0) / self.ds))
        return self._xyz[min(max(i, 0), len(self._xyz) - 1)].astype(
            np.float32)

    def forward(self, s: float) -> np.ndarray:
        th = float(self.heading(s))
        return np.array([np.sin(th), 0.0, np.cos(th)], np.float32)

    def poses(self, n: int, spacing_m: float) -> list:
        """world->camera (R, t) of n poses ``spacing_m`` apart from s = 0
        (pose 0 is the identity), facing along the street."""
        down = np.array([0.0, 1.0, 0.0], np.float32)
        out = []
        for k in range(n):
            s = k * spacing_m
            fwd = self.forward(s)
            right = np.cross(down, fwd).astype(np.float32)
            R = np.stack([right, down, fwd], axis=1).T.astype(np.float32)
            out.append((R, (-R @ self.position(s)).astype(np.float32)))
        return out


def _plane_tensors(pl: _Plane, device) -> dict:
    cache = pl.__dict__.setdefault("_on", {})
    key = str(device)
    if key not in cache:
        cache[key] = {name: torch.as_tensor(getattr(pl, name), device=device)
                      for name in ("p0", "ea", "eb", "n", "tex", "tex2",
                                   "phase")}
    return cache[key]


def _bilinear(tex: torch.Tensor, ga: torch.Tensor, gb: torch.Tensor):
    ga = ga.clamp(0.0, float(tex.shape[0] - 2))
    gb = gb.clamp(0.0, float(tex.shape[1] - 2))
    ia = torch.floor(ga).long()
    ib = torch.floor(gb).long()
    fa = (ga - ia).clamp(0, 1)
    fb = (gb - ib).clamp(0, 1)
    return (tex[ia, ib] * (1 - fa) * (1 - fb) + tex[ia, ib + 1] * (1 - fa) * fb
            + tex[ia + 1, ib] * fa * (1 - fb) + tex[ia + 1, ib + 1] * fa * fb)


def _box(pl: _Plane, Rs: np.ndarray, ts: np.ndarray, cam: dict,
         z_min: float):
    """(y0, y1, x0, x1) of the pixels the plane can cover in any of the
    views, or None where it is behind every view, beyond its ``far`` depth
    in every view, or outside every image."""
    X = np.einsum("vij,cj->vci", Rs, pl.corners()) + ts[:, None, :]
    z = X[..., 2]
    if (z <= z_min).all() or (z > pl.far).all():
        return None
    W, H = cam["width"], cam["height"]
    if (z <= z_min).any():
        return 0, H, 0, W
    u = cam["fx"] * X[..., 0] / z + cam["cx"]
    v = cam["fy"] * X[..., 1] / z + cam["cy"]
    x0, x1 = int(np.floor(u.min())) - 1, int(np.ceil(u.max())) + 2
    y0, y1 = int(np.floor(v.min())) - 1, int(np.ceil(v.max())) + 2
    x0, x1, y0, y1 = max(x0, 0), min(x1, W), max(y0, 0), min(y1, H)
    if x0 >= x1 or y0 >= y1:
        return None
    return y0, y1, x0, x1


def render_views(planes, views, device, cam: dict, z_min: float = 0.4):
    """(image [V, H, W] float32, depth [V, H, W] float32 metres) of every
    view (R, t) on ``device``: ``render_views``' arithmetic, each plane
    only inside its box. A plane wholly beyond its ``far`` depth is not
    drawn: at 150 m a street's far end covers a few pixels round its
    vanishing point (a billboard at 80 m under 7), and drawing the hundreds
    of planes beyond would cost more than the rest."""
    f32 = torch.float32
    Rs = np.stack([np.asarray(r, np.float32) for r, _ in views])
    ts = np.stack([np.asarray(t, np.float32) for _, t in views])
    R = torch.as_tensor(Rs, device=device)
    t = torch.as_tensor(ts, device=device)
    C = -(R * t[:, :, None]).sum(1)
    width, height = cam["width"], cam["height"]
    xs = (torch.arange(width, dtype=f32, device=device) - cam["cx"]) / cam["fx"]
    ys = (torch.arange(height, dtype=f32, device=device) - cam["cy"]) / cam["fy"]
    dy, dx = torch.meshgrid(ys, xs, indexing="ij")
    d_cam = torch.stack([dx, dy, torch.ones_like(dx)], -1)
    d_world = sum(d_cam[None, :, :, i, None] * R[:, None, None, i, :]
                  for i in range(3))
    V = len(views)
    img = torch.full((V, height, width), 25.0, dtype=f32, device=device)
    depth = torch.zeros((V, height, width), dtype=f32, device=device)
    best_t = torch.full((V, height, width), float("inf"), dtype=f32,
                        device=device)
    Cb = C[:, None, None, :]

    def dot(a, b):
        return a[..., 0] * b[0] + a[..., 1] * b[1] + a[..., 2] * b[2]

    for pl in planes:
        box = _box(pl, Rs, ts, cam, z_min)
        if box is None:
            continue
        y0, y1, x0, x1 = box
        g = _plane_tensors(pl, device)
        dw = d_world[:, y0:y1, x0:x1]
        denom = dot(dw, g["n"])
        denom = torch.where(denom.abs() < 1e-9, 1e-9, denom)
        tt = dot(g["p0"] - Cb, g["n"]) / denom
        rel = Cb + tt[..., None] * dw - g["p0"]
        a = torch.nan_to_num(dot(rel, g["ea"]), posinf=1e6, neginf=-1e6)
        b = torch.nan_to_num(dot(rel, g["eb"]), posinf=1e6, neginf=-1e6)
        bt = best_t[:, y0:y1, x0:x1]
        ok = ((tt > z_min) & (tt < bt) & (a.abs() < pl.half_a)
              & (b.abs() < pl.half_b))
        ga = (a + pl.half_a) / pl.cell + 2
        gb = (b + pl.half_b) / pl.cell + 2
        p = g["phase"]
        ga_w = (ga + 0.35 * torch.sin(gb * 1.7 + p[0])
                + 0.2 * torch.sin(gb * 0.61 + p[1]))
        gb_w = (gb + 0.35 * torch.sin(ga * 1.3 + p[2])
                + 0.2 * torch.sin(ga * 0.47 + p[3]))
        val = (_bilinear(g["tex"], ga_w, gb_w)
               + _bilinear(g["tex2"], 2 * ga, 2 * gb))
        img[:, y0:y1, x0:x1] = torch.where(ok, val, img[:, y0:y1, x0:x1])
        depth[:, y0:y1, x0:x1] = torch.where(ok, tt, depth[:, y0:y1, x0:x1])
        best_t[:, y0:y1, x0:x1] = torch.where(ok, tt, bt)
    return img, depth


def render_frames(planes, poses, cam: dict, device, want_depth: bool,
                  batch: int = 64):
    """uint8 images [V, H, W] (numpy, host) of every pose, and with
    ``want_depth`` float32 depth in metres [V, H, W] (numpy, host), rendered
    on ``device`` ``batch`` views at a time."""
    V = len(poses)
    imgs = np.empty((V, cam["height"], cam["width"]), np.uint8)
    depths = (np.empty((V, cam["height"], cam["width"]), np.float32)
              if want_depth else None)
    for i in range(0, V, batch):
        img, depth = render_views(planes, poses[i:i + batch], device, cam)
        imgs[i:i + batch] = img.clamp(0, 255).to(torch.uint8).cpu().numpy()
        if want_depth:
            depths[i:i + batch] = depth.cpu().numpy()
    return imgs, depths
