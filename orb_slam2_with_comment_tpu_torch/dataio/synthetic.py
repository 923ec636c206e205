"""Synthetic RGB-D sequence generator for end-to-end pipeline tests.

Replaces dataset downloads (none available offline) with a ray-cast
textured room: planes (back wall, floor, ceiling, side walls) carrying
world-anchored random bilinear textures. Per-pixel ray casting gives

  - exact, per-pixel depth (no T-junction / occlusion-boundary artifacts),
  - sub-pixel-consistent appearance under viewpoint change (bilinear
    interpolation of a fixed world grid — corners live at grid-cell
    boundaries and move exactly with the projective flow),
  - real depth spread (floor/walls at 1-7 m) so pose estimation is
    well-conditioned (a fronto-parallel plane makes x-translation vs yaw
    near-degenerate).

This is the synthetic-scene module-test strategy of SURVEY.md §4(b).
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
        na = int(2 * half_a / cell) + 5
        nb = int(2 * half_b / cell) + 5
        # coarse corner-bearing blocks + weak smooth fine octave. Coarse
        # spacing (~30 px at 5 m) far exceeds any prediction error, so
        # windowed matching can never alias onto a neighboring cell; the
        # fine octave is too weak to spawn competing corners.
        self.tex = rng.uniform(40, 240, (na, nb)).astype(np.float32)
        self.tex2 = rng.uniform(-14, 14, (2 * na, 2 * nb)).astype(np.float32)
        self.phase = rng.uniform(0, 6.28, 4).astype(np.float32)

    def sample(self, a, b):
        """Bilinear texture at plane-local coords, domain-warped so cell
        boundaries form no global lattice (aperiodic corners)."""
        def bil(tex, ga, gb):
            # clamp in FLOAT before the int cast: rays nearly parallel to
            # the plane hit at ~1e12 plane-units, and float32->int32 on
            # such values is an invalid cast (they never pass the caller's
            # `ok` gate, so the sampled value is discarded anyway)
            ga = np.clip(ga, 0.0, float(tex.shape[0] - 2))
            gb = np.clip(gb, 0.0, float(tex.shape[1] - 2))
            ia = np.floor(ga).astype(np.int32)
            ib = np.floor(gb).astype(np.int32)
            fa = np.clip(ga - ia, 0, 1)
            fb = np.clip(gb - ib, 0, 1)
            v00 = tex[ia, ib]
            v01 = tex[ia, ib + 1]
            v10 = tex[ia + 1, ib]
            v11 = tex[ia + 1, ib + 1]
            return (v00 * (1 - fa) * (1 - fb) + v01 * (1 - fa) * fb
                    + v10 * fa * (1 - fb) + v11 * fa * fb)

        ga = (a + self.half_a) / self.cell + 2
        gb = (b + self.half_b) / self.cell + 2
        p = self.phase
        ga_w = ga + 0.35 * np.sin(gb * 1.7 + p[0]) + 0.2 * np.sin(gb * 0.61 + p[1])
        gb_w = gb + 0.35 * np.sin(ga * 1.3 + p[2]) + 0.2 * np.sin(ga * 0.47 + p[3])
        return bil(self.tex, ga_w, gb_w) + bil(self.tex2, 2 * ga, 2 * gb)


class SyntheticWorld:
    """A textured room: back wall + floor + ceiling + two side walls."""

    def __init__(self, seed=0, depth_noise=0.0, closed=False):
        rng = np.random.RandomState(seed)
        self.depth_noise = depth_noise
        self.rng = np.random.RandomState(seed + 1)
        # TUM-desk-like working distances: structure at 1-3 m, where 1 px of
        # corner noise maps to 2-6 mm of depth-scaled pose noise (a 5-7 m
        # room is "hard mode" — 1 px there is worth 10-14 mm).
        W, H, Z = 2.2, 1.2, 3.2  # room half-width, half-height, wall distance
        # closed mode is built for CLOSE viewing (lookout_trajectory puts
        # walls 1-2.5 m away): 0.3 m texture cells subtend ~100 px there
        # and FAST finds almost no level-0 corners — use fine cells
        wc = 0.12 if closed else 0.3  # wall texture cell
        self.planes = [
            # back wall at z=Z, facing the camera
            _Plane([0, 0, Z], [1, 0, 0], [0, 1, 0], 4.5, 2.5, rng, cell=wc),
            # floor y=+H (y down in camera convention at identity)
            _Plane([0, H, 0], [1, 0, 0], [0, 0, 1], 4.5, 8.0, rng, cell=wc),
            # ceiling y=-H
            _Plane([0, -H, 0], [1, 0, 0], [0, 0, 1], 4.5, 8.0, rng, cell=wc),
            # left wall x=-W, right wall x=+W
            _Plane([-W, 0, 0], [0, 0, 1], [0, 1, 0], 8.0, 2.5, rng, cell=wc),
            _Plane([W, 0, 0], [0, 0, 1], [0, 1, 0], 8.0, 2.5, rng, cell=wc),
        ]
        if closed:
            # front wall at z=-Z: a fully CLOSED room, so a 360-degree
            # look-around sweep (lookout_trajectory) always faces
            # structure — the open -z end would otherwise show empty
            # background for part of each lap
            self.planes.append(
                _Plane([0, 0, -Z], [1, 0, 0], [0, 1, 0], 4.5, 2.5, rng,
                       cell=wc))
        # Fronto-parallel textured "furniture" pillars at mid depth: stable,
        # matchable close structure (like TUM desk clutter). Grazing-angle
        # floor texture alone matches too poorly to constrain translation,
        # leaving the back wall's x-vs-yaw valley in charge.
        pc = 0.06 if closed else 0.1  # pillar texture cell
        if closed:
            # pillar RING facing the lookout path: clutter at EVERY gaze
            # direction. Monocular tracking needs depth variety in every
            # sector — the pillar-free +-x wall sectors of the forward-
            # biased layout presented a single frontal plane and mono
            # pose repeatedly failed there mid-sweep.
            for j in range(22):
                phi = 2 * np.pi * j / 22 + rng.uniform(-0.08, 0.08)
                rr = rng.uniform(1.5, 2.0)
                cp = [rr * np.sin(phi), rng.uniform(-0.5, 0.5),
                      rr * np.cos(phi)]
                ea = [np.cos(phi), 0, -np.sin(phi)]  # tangential
                half = rng.uniform(0.15, 0.3)
                self.planes.append(
                    _Plane(cp, ea, [0, 1, 0], half, half, rng, cell=pc))
        else:
            for _ in range(14):
                px = rng.uniform(-1.8, 1.8)
                py = rng.uniform(-0.9, 0.9)
                pz = rng.uniform(1.1, 2.6)
                half = rng.uniform(0.18, 0.4)
                self.planes.append(
                    _Plane([px, py, pz], [1, 0, 0], [0, 1, 0], half, half,
                           rng, cell=pc))

    def render(self, R, t, fx=500.0, fy=500.0, cx=320.0, cy=240.0,
               width=640, height=480, z_min=0.4, dirs=None):
        """Render (image, depth) for world->camera pose (R, t).

        ``dirs`` [H, W, 3]: optional per-pixel camera-frame ray directions
        replacing the pinhole grid — used to render through a DISTORTED
        camera model (EuRoC-style fixtures: each raw pixel's ray is the
        undistorted normalized coordinate of that pixel)."""
        R = np.asarray(R, np.float32)
        t = np.asarray(t, np.float32)
        C = -R.T @ t  # camera center in world
        if dirs is None:
            xs = (np.arange(width, dtype=np.float32) - cx) / fx
            ys = (np.arange(height, dtype=np.float32) - cy) / fy
            dx, dy = np.meshgrid(xs, ys)
            d_cam = np.stack([dx, dy, np.ones_like(dx)], axis=-1)  # [H,W,3]
        else:
            d_cam = np.asarray(dirs, np.float32)
            height, width = d_cam.shape[:2]
        d_world = d_cam @ R  # R^T applied to each ray
        img = np.full((height, width), 25.0, np.float32)
        depth = np.zeros((height, width), np.float32)
        best_t = np.full((height, width), np.inf, np.float32)
        for pl in self.planes:
            denom = d_world @ pl.n
            denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            tt = ((pl.p0 - C) @ pl.n) / denom  # camera-z of intersection
            hit_p = C + tt[..., None] * d_world
            rel = hit_p - pl.p0
            # rays nearly parallel to the plane produce huge/inf coords;
            # sanitize before sampling (they never pass the `ok` gate)
            a = np.nan_to_num(rel @ pl.ea, posinf=1e6, neginf=-1e6)
            b = np.nan_to_num(rel @ pl.eb, posinf=1e6, neginf=-1e6)
            ok = (tt > z_min) & (tt < best_t) & (np.abs(a) < pl.half_a) & (np.abs(b) < pl.half_b)
            val = pl.sample(a, b)
            img = np.where(ok, val, img)
            depth = np.where(ok, tt, depth)
            best_t = np.where(ok, tt, best_t)
        if self.depth_noise > 0:
            noise = self.rng.randn(height, width).astype(np.float32)
            depth = np.where(depth > 0, depth * (1 + self.depth_noise * noise), 0.0)
        return np.clip(img, 0, 255), depth


def _plane_tensors(pl: _Plane, device) -> dict:
    """A plane's geometry and textures on ``device``, made once."""
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


def render_views(world, views, device, fx=500.0, fy=500.0, cx=320.0,
                 cy=240.0, width=640, height=480, z_min=0.4, dirs=None):
    """``world.render`` of every view (R, t) at once, in float32 on
    ``device`` (a torch device): a list of (image, depth) numpy arrays in
    view order. The arithmetic is render's, elementwise (no matrix
    product), so an image differs from render's by float32 rounding of
    the trigonometry and the sums, at most a few grey levels at a few
    pixels. Depth noise, where the world has it, is drawn on the host in
    view order, as render draws it."""
    f32 = torch.float32
    R = torch.as_tensor(np.stack([np.asarray(r, np.float32)
                                  for r, _ in views]), device=device)
    t = torch.as_tensor(np.stack([np.asarray(tt, np.float32)
                                  for _, tt in views]), device=device)
    C = -(R * t[:, :, None]).sum(1)  # [V, 3]: -R^T t
    if dirs is None:
        xs = (torch.arange(width, dtype=f32, device=device) - cx) / fx
        ys = (torch.arange(height, dtype=f32, device=device) - cy) / fy
        dy, dx = torch.meshgrid(ys, xs, indexing="ij")
        d_cam = torch.stack([dx, dy, torch.ones_like(dx)], -1)  # [H, W, 3]
    else:  # per-pixel rays, as render takes them
        d_cam = torch.as_tensor(np.asarray(dirs, np.float32), device=device)
        height, width = d_cam.shape[:2]
    # d_world[v, h, w, j] = sum_i d_cam[h, w, i] R[v, i, j]
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

    for pl in world.planes:
        g = _plane_tensors(pl, device)
        denom = dot(d_world, g["n"])
        denom = torch.where(denom.abs() < 1e-9, 1e-9, denom)
        tt = dot(g["p0"] - Cb, g["n"]) / denom
        rel = Cb + tt[..., None] * d_world - g["p0"]
        a = torch.nan_to_num(dot(rel, g["ea"]), posinf=1e6, neginf=-1e6)
        b = torch.nan_to_num(dot(rel, g["eb"]), posinf=1e6, neginf=-1e6)
        ok = ((tt > z_min) & (tt < best_t) & (a.abs() < pl.half_a)
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
        img = torch.where(ok, val, img)
        depth = torch.where(ok, tt, depth)
        best_t = torch.where(ok, tt, best_t)
    imgs = img.clamp(0, 255).cpu().numpy()
    depths = depth.cpu().numpy()
    out = []
    for k in range(V):
        d = depths[k]
        if world.depth_noise > 0:
            noise = world.rng.randn(height, width).astype(np.float32)
            d = np.where(d > 0, d * (1 + world.depth_noise * noise), 0.0)
        out.append((imgs[k], d))
    return out


def orbit_trajectory(n_frames, x_amp=0.35, y_amp=0.08, z_amp=0.12,
                     yaw_amp=0.03):
    """Smooth lateral arc with small yaw — world->camera (R, t) per frame."""
    poses = []
    for k in range(n_frames):
        s = k / max(n_frames - 1, 1)
        C = np.array([x_amp * np.sin(2 * np.pi * s),
                      y_amp * np.sin(4 * np.pi * s),
                      z_amp * np.sin(2 * np.pi * s)], np.float32)
        yaw = yaw_amp * np.sin(2 * np.pi * s)
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        Rwc = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]], np.float32)
        R = Rwc.T  # world->camera
        t = -R @ C
        poses.append((R, t.astype(np.float32)))
    return poses


def lookout_trajectory(n_frames, laps=2.0, radius=0.8, y_amp=0.05,
                       center=(0.0, 0.0, 0.0)):
    """Outward-looking circular sweep inside a CLOSED room
    (SyntheticWorld(closed=True)): the camera rides a circle of
    ``radius`` gazing radially outward, so view content rotates through
    the full 360 degrees each lap. This is a GENUINE revisit trajectory:
    keyframes from opposite phases of the lap share no content, the
    covisibility graph to the start decays, and lap 2 re-encounters the
    start exactly the way loop-closure datasets do (the plain
    orbit_trajectory stares at one wall throughout, every keyframe stays
    covisible with every other, and the detector's non-covisible
    candidate set is correctly empty — no loop exists to close there).

    Tangential motion + radial gaze also maximizes triangulation
    parallax, the monocular mapping's operating requirement."""
    c0 = np.asarray(center, np.float32)
    poses = []
    for k in range(n_frames):
        s = laps * k / max(n_frames - 1, 1)
        th = 2 * np.pi * s
        out = np.array([np.sin(th), 0.0, np.cos(th)], np.float32)
        C = c0 + radius * out
        C[1] += y_amp * np.sin(4 * np.pi * s)
        z = out                                   # gaze: radial outward
        y = np.array([0.0, 1.0, 0.0], np.float32)  # y down, camera level
        x = np.cross(y, z).astype(np.float32)
        x /= np.linalg.norm(x)
        Rwc = np.stack([x, y, z], axis=1)
        R = Rwc.T.astype(np.float32)
        t = (-R @ C).astype(np.float32)
        poses.append((R, t))
    return poses


class StreetWorld:
    """Street-scale ray-cast world: a closed rectangular city-block
    circuit of textured facade walls (a street canyon) with ground plane
    and fronto-facing billboards, for LONG trajectories (>=50 m) that
    revisit their start — the operating point of KITTI-style stereo
    drivers (reference Examples/Stereo/stereo_kitti.cc + KITTI00-02.yaml)
    where compaction, capacity growth and loop closure all fire in one
    run (VERDICT r4 #6).

    Path rectangle half-extents (A, B) with corner radius r; walls at
    lateral offset +-street_half from the path. Camera travels the
    circuit counterclockwise facing the tangent."""

    def __init__(self, seed=0, A=10.0, B=6.0, r=2.0, street_half=2.5,
                 wall_half_h=1.6, y_ground=1.5):
        rng = np.random.RandomState(seed)
        self.A, self.B, self.r = float(A), float(B), float(r)
        self.street_half = float(street_half)
        planes = []
        # inner + outer facade rectangles in the x-z plane (y vertical,
        # y down convention: ground at +y_ground)
        for off, fo in ((street_half, -1.0), (-street_half, +1.0)):
            ax, bz = A + off, B + off
            # walls: +-z sides (normal along z), +-x sides (normal along x)
            planes += [
                _Plane([0, 0, bz], [1, 0, 0], [0, 1, 0], ax + 0.5,
                       wall_half_h, rng),
                _Plane([0, 0, -bz], [1, 0, 0], [0, 1, 0], ax + 0.5,
                       wall_half_h, rng),
                _Plane([ax, 0, 0], [0, 0, 1], [0, 1, 0], bz + 0.5,
                       wall_half_h, rng),
                _Plane([-ax, 0, 0], [0, 0, 1], [0, 1, 0], bz + 0.5,
                       wall_half_h, rng),
            ]
        # ground plane covering the whole block
        planes.append(_Plane([0, y_ground, 0], [1, 0, 0], [0, 0, 1],
                             A + street_half + 1, B + street_half + 1,
                             rng))
        # billboards: small planes with normals ALONG the street (fronto-
        # parallel to a camera driving toward them — grazing-angle facade
        # texture alone matches too poorly to constrain translation, same
        # reason the room world carries pillars)
        for sgn in (1.0, -1.0):
            # boards along the +-z straights face along x
            for xb in np.arange(-A + 1.0, A - 0.5, 2.0):
                for zoff in (B - street_half + 0.7, B + street_half - 0.7):
                    planes.append(_Plane(
                        [xb, rng.uniform(-0.5, 0.5), sgn * zoff],
                        [0, 0, sgn], [0, 1, 0],
                        rng.uniform(0.3, 0.55), rng.uniform(0.3, 0.55),
                        rng, cell=0.12))
            # boards along the +-x straights face along z
            for zb in np.arange(-B + 1.0, B - 0.5, 2.0):
                for xoff in (A - street_half + 0.7, A + street_half - 0.7):
                    planes.append(_Plane(
                        [sgn * xoff, rng.uniform(-0.5, 0.5), zb],
                        [sgn, 0, 0], [0, 1, 0],
                        rng.uniform(0.3, 0.55), rng.uniform(0.3, 0.55),
                        rng, cell=0.12))
        self.planes = planes
        self.depth_noise = 0.0
        self.rng = np.random.RandomState(seed + 1)

    render = SyntheticWorld.render

    def perimeter(self):
        A, B, r = self.A, self.B, self.r
        return 4 * (A - r) + 4 * (B - r) + 2 * np.pi * r

    def circuit_pose(self, s):
        """Arclength s -> (C world position [3], theta heading). The
        path is the rounded rectangle of half-extents (A, B), corner
        radius r, traversed counterclockwise (as seen with y down)."""
        A, B, r = self.A, self.B, self.r
        lx, lz = 2 * (A - r), 2 * (B - r)  # straight lengths
        qa = 0.5 * np.pi * r  # quarter-arc length
        P = self.perimeter()
        s = np.fmod(s, P)
        # segments: +z straight (x: -A+r..A-r), arc, +x side (z: B-r..-B+r),
        # arc, -z straight, arc, -x side, arc
        segs = [lx, qa, lz, qa, lx, qa, lz, qa]
        c = 0.0
        for i, L in enumerate(segs):
            if s <= c + L or i == 7:
                u = s - c
                break
            c += L
        if i == 0:   # along +x at z=+B
            C = np.array([-A + r + u, 0.0, B])
            th = 0.5 * np.pi  # heading +x
        elif i == 1:  # corner (+A-r, +B-r), turning +x -> -z
            ang = u / r
            C = np.array([A - r + r * np.sin(ang), 0.0,
                          B - r + r * np.cos(ang)])
            th = 0.5 * np.pi + ang
        elif i == 2:  # along -z at x=+A
            C = np.array([A, 0.0, B - r - u])
            th = np.pi
        elif i == 3:  # corner (+A-r, -B+r), -z -> -x
            ang = u / r
            C = np.array([A - r + r * np.cos(ang), 0.0,
                          -B + r - r * np.sin(ang)])
            th = np.pi + ang
        elif i == 4:  # along -x at z=-B
            C = np.array([A - r - u, 0.0, -B])
            th = 1.5 * np.pi
        elif i == 5:  # corner (-A+r, -B+r), -x -> +z
            ang = u / r
            C = np.array([-A + r - r * np.sin(ang), 0.0,
                          -B + r - r * np.cos(ang)])
            th = 1.5 * np.pi + ang
        elif i == 6:  # along +z at x=-A
            C = np.array([-A, 0.0, -B + r + u])
            th = 0.0
        else:        # corner (-A+r, +B-r), +z -> +x
            ang = u / r
            C = np.array([-A + r - r * np.cos(ang), 0.0,
                          B - r + r * np.sin(ang)])
            th = ang
        return C.astype(np.float32), float(np.fmod(th, 2 * np.pi))


def street_trajectory(world: StreetWorld, n_frames, laps=1.05):
    """world->camera (R, t) along the street circuit; laps > 1 revisits
    the start so the loop detector has a genuine reobservation."""
    total = world.perimeter() * laps
    poses = []
    for k in range(n_frames):
        s = total * k / max(n_frames - 1, 1)
        C, th = world.circuit_pose(s)
        ct, st_ = np.cos(th), np.sin(th)
        fwd = np.array([st_, 0.0, ct], np.float32)       # heading
        down = np.array([0.0, 1.0, 0.0], np.float32)
        right = np.cross(down, fwd).astype(np.float32)   # y x z = x
        Rwc = np.stack([right, down, fwd], axis=1)       # columns
        R = Rwc.T
        t = (-R @ C).astype(np.float32)
        poses.append((R.astype(np.float32), t))
    return poses


# ---------------------------------------------------------------------------
# pose-only LM problems (the inputs of optim/pose_opt.optimize_pose)
# ---------------------------------------------------------------------------

POSE_CASES = ("mixed", "mono", "stereo", "outliers", "no_valid_row",
              "three_valid_row", "z_near_zero", "far_init", "batched_obs")


def _rotation(w) -> np.ndarray:
    """Rodrigues in float64: axis-angle [3] -> [3, 3]."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def pose_problem(case: str, seed: int, B: int = 3, N: int = 1000,
                 cam=(500.0, 500.0, 320.0, 240.0, 40.0)) -> dict:
    """A pose-only LM problem of the kind tracking gives the solver, as
    numpy arrays: R0 [B,3,3], t0 [B,3], Xw [B,N,3], obs_uvr [N,3] (or
    [B,N,3] for ``batched_obs``), inv_sigma2 [N] (or [B,N]), valid [B,N].

    Landmarks 2-6 m in front of a true pose, observed with 0.7 px noise at
    octaves 0-3 (every fourth row mono, u_r = -1), about 90% valid per row,
    each row starting a few cm and 1-2 degrees away. ``case`` (POSE_CASES)
    changes one thing: ``mono`` / ``stereo`` rows only; ``outliers`` 10%
    gross outliers (up to 40 px); ``no_valid_row`` row 1 without a valid
    edge; ``three_valid_row`` row 2 with 3 valid edges; ``z_near_zero`` one
    landmark, not valid, at depth ~1e-10 under each row's initial pose; ``far_init``
    rows 0.1 rad and 0.2 m away; ``batched_obs`` the observations and their
    weights per row, each row its own noise."""
    if case not in POSE_CASES:
        raise ValueError(f"unknown case {case!r}")
    fx, fy, cx, cy, bf = cam
    rng = np.random.RandomState(seed)
    X = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                  rng.uniform(2, 6, N)], 1)
    R = _rotation([0.01, -0.02, 0.005])
    t = np.array([0.05, 0.01, -0.03])
    Xc = X @ R.T + t
    clean = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx,
                      fy * Xc[:, 1] / Xc[:, 2] + cy,
                      fx * Xc[:, 0] / Xc[:, 2] + cx - bf / Xc[:, 2]], 1)
    rows = B if case == "batched_obs" else 1
    uvr = clean[None] + rng.normal(0, 0.7, (rows, N, 3))
    mono = np.zeros(N, bool)
    if case == "mono":
        mono[:] = True
    elif case != "stereo":
        mono[::4] = True
    uvr[:, mono, 2] = -1.0
    if case == "outliers":
        bad = rng.rand(N) < 0.1
        uvr[:, bad, :2] += rng.uniform(-40, 40, (rows, bad.sum(), 2))
    octave = rng.randint(0, 4, (rows, N))
    inv_s2 = 1.0 / 1.44 ** octave
    valid = rng.rand(B, N) < 0.9
    if case == "no_valid_row" and B > 1:
        valid[1] = False
    if case == "three_valid_row" and B > 2:
        valid[2] = False
        valid[2, rng.choice(N, 3, replace=False)] = True
    scale = (0.1, 0.2) if case == "far_init" else (0.03, 0.06)
    R0, t0 = [], []
    for _ in range(B):
        w = rng.normal(0, 1, 3)
        d = rng.normal(0, 1, 3)
        R0.append(_rotation(scale[0] * w / np.linalg.norm(w)) @ R)
        t0.append(t + scale[1] * d / np.linalg.norm(d))
    Xw = np.repeat(X[None], B, 0)
    if case == "z_near_zero":
        # landmark 0 at depth ~1e-10 under row b's initial pose (float32
        # rounding leaves about 1e-8), an edge that is not valid: a valid
        # one would outweigh the others in H by some 1e19, beyond what a
        # float32 solve resolves, and any order of the sums would then
        # decide the pose
        for b in range(B):
            Xw[b, 0] = R0[b].T @ (np.array([0.3, -0.2, 1e-10]) - t0[b])
        valid[:, 0] = False
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    obs = uvr if rows > 1 else uvr[0]
    s2 = inv_s2 if rows > 1 else inv_s2[0]
    return dict(R0=f32(np.stack(R0)), t0=f32(np.stack(t0)), Xw=f32(Xw),
                obs_uvr=f32(obs), inv_sigma2=f32(s2), valid=valid)


# ---------------------------------------------------------------------------
# dense bundle adjustment problems (the inputs of optim/ba.ba_solve)
# ---------------------------------------------------------------------------

BA_CASES = ("mixed", "mono", "all_invalid")


def ba_problem(case: str, seed: int, P: int = 24, L: int = 8192, D: int = 8,
               n_fixed: int = 8, outliers: float = 0.1,
               cam=(500.0, 500.0, 320.0, 240.0, 40.0),
               spread: bool = False) -> dict:
    """A local-BA problem of the kind keyframe maintenance gives the dense
    solver, as numpy arrays: R [P,3,3], t [P,3], X [L,3], obs_pose [L,D]
    int64, obs_uvr [L,D,3], obs_w [L,D], pose_fixed [P], point_valid [L].

    P keyframes 25 cm apart along x, turning 0.11 degrees a step, see
    landmarks 2-6 m ahead; each landmark is observed by 2 to D distinct
    poses of the window of 9 around the pose it lies in front of, the
    window's two ends among them (the widest baseline the window has), in
    its first slots (the rest weight 0, pose 0), with 0.8 px noise at
    octaves 0-3, ``outliers`` of the observations moved up to 40 px (u and
    u_r alike, as a wrong match moves them); the
    last ``n_fixed`` poses are fixed, the free ones start about 3 mrad and
    1 cm away, the landmarks 3 cm away; 95% of the landmarks valid.
    ``case`` (BA_CASES): ``mixed`` each landmark's first observation
    stereo and a quarter of the others mono (u_r = -1); ``mono`` all of
    them mono; ``all_invalid`` mixed with no valid landmark. A landmark is
    well determined where the map's are (a stereo observation, or a wide
    baseline): float32 and float64 solves agree on it. ``spread``: each
    landmark's D slots shuffled after the draws (a permutation of its own),
    so that its observations lie anywhere among them, as a map's slot table
    holds them once observations have been culled."""
    if case not in BA_CASES:
        raise ValueError(f"unknown case {case!r}")
    fx, fy, cx, cy, bf = cam
    rng = np.random.RandomState(seed)
    step = 0.25
    Rs = np.stack([_rotation([0.0, 0.002 * p, 0.0]) for p in range(P)])
    ts = np.stack([-Rs[p] @ [step * p, 0.0, 0.0] for p in range(P)])
    base = rng.randint(0, P, L)
    X = np.stack([step * base + rng.uniform(-1.5, 1.5, L),
                  rng.uniform(-1.2, 1.2, L), rng.uniform(2.0, 6.0, L)], 1)
    obs_pose = np.zeros((L, D), np.int64)
    w = np.zeros((L, D))
    uvr = np.zeros((L, D, 3))
    for i in range(L):
        window = np.arange(max(base[i] - 4, 0), min(base[i] + 5, P))
        k = min(rng.randint(2, D + 1), len(window))
        inner = rng.permutation(window[1:-1])[:max(k - 2, 0)]
        obs_pose[i, :k] = np.concatenate([window[[0, -1]], inner])[:k]
        w[i, :k] = 1.0 / 1.44 ** rng.randint(0, 4, k)
    Xc = np.einsum("ldij,lj->ldi", Rs[obs_pose], X) + ts[obs_pose]
    uvr[..., 0] = fx * Xc[..., 0] / Xc[..., 2] + cx
    uvr[..., 1] = fy * Xc[..., 1] / Xc[..., 2] + cy
    uvr[..., 2] = uvr[..., 0] - bf / Xc[..., 2]
    uvr += rng.normal(0, 0.8, uvr.shape)
    bad = rng.rand(L, D) < outliers
    shift = rng.uniform(-40, 40, (int(bad.sum()), 2))
    uvr[bad] += shift[:, [0, 1, 0]]  # a wrong match moves u and u_r alike
    mono = (rng.rand(L, D) < 0.25) if case != "mono" else np.ones((L, D),
                                                                  bool)
    if case != "mono":
        mono[:, 0] = False
    uvr[mono, 2] = -1.0
    fixed = np.zeros(P, bool)
    fixed[P - n_fixed:] = True
    R0, t0 = Rs.copy(), ts.copy()
    for p in np.nonzero(~fixed)[0]:
        R0[p] = _rotation(rng.normal(0, 0.003, 3)) @ Rs[p]
        t0[p] = ts[p] + rng.normal(0, 0.01, 3)
    valid = rng.rand(L) < 0.95
    if case == "all_invalid":
        valid[:] = False
    if spread:
        perm = np.argsort(rng.rand(L, D), axis=1)
        obs_pose = np.take_along_axis(obs_pose, perm, 1)
        w = np.take_along_axis(w, perm, 1)
        uvr = np.take_along_axis(uvr, perm[..., None], 1)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return dict(R=f32(R0), t=f32(t0), X=f32(X + rng.normal(0, 0.03, X.shape)),
                obs_pose=obs_pose, obs_uvr=f32(uvr), obs_w=f32(w),
                pose_fixed=fixed, point_valid=valid)
