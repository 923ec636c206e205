"""Augmented-reality support (the reference's MonoAR / ViewerAR; port of
visualization/ar.py).

- :func:`fit_plane_ransac`: ``ViewerAR::DetectPlane`` (ViewerAR.cc:392-508)
  as a batched RANSAC: every 3-point hypothesis plane is fitted and scored
  at once. Score = the ``max(0.2*N, 20)``-th smallest point-plane
  distance; inliers = distance < 1.4 * best score.
- :func:`plane_pose`: ``Plane::Recompute`` (ViewerAR.cc:516-585): the
  all-inlier refit (smallest eigenvector of the centered scatter matrix),
  the normal's sign fixed against the camera ray (XC.n <= 0), the plane
  frame made by rotating +Y onto the normal with an in-plane spin.
- :func:`cube_edges` / :func:`draw_ar`: ``DrawCube``/``DrawPlane``
  (ViewerAR.cc:336-376) as the cube wireframe and plane grid projected
  through the pinhole model and rasterized onto the frame (numpy, as in
  the JAX package).

The random draws, the hypotheses' Gumbel noise and the in-plane spin, come
from a torch.Generator the caller passes; a caller may pass the samples
themselves instead (``gumbel``, ``rang``), as the tests feed the JAX
package's. The device functions take tensors on any device and read
nothing back to the host but ``detect_plane``'s go/no-go.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..geometry.se3 import exp_so3

CUBE_EDGE_COLOR = (235, 60, 200)
GRID_COLOR = (120, 120, 120)


def fit_plane_ransac(points: torch.Tensor, valid: torch.Tensor,
                     gen: torch.Generator | None = None,
                     iterations: int = 50,
                     gumbel: torch.Tensor | None = None):
    """Batched 3-point RANSAC plane fit.

    points: [N, 3] float world points; valid: [N] bool; ``gumbel``:
    [iterations, N] noise that picks each hypothesis' three points (drawn
    from ``gen`` when not given). Returns ``(normal [3], d, inlier_mask
    [N], ok)`` for the plane n.x + d = 0; ``ok`` is False when fewer than
    50 valid points exist (ViewerAR.cc:414-415).
    """
    dev = points.device
    N = points.shape[0]
    n_valid = valid.sum(dtype=torch.int32)
    if gumbel is None:  # standard Gumbel samples, -log(-log(U))
        u = torch.rand((iterations, N), generator=gen, device=dev)
        u = u.clamp(min=torch.finfo(u.dtype).tiny)
        gumbel = -torch.log(-torch.log(u))
    iterations = gumbel.shape[0]
    # three distinct valid points per hypothesis: Gumbel top-k over the
    # masked noise weighs the valid points uniformly
    g = torch.where(valid[None, :], gumbel.to(dev), -math.inf)
    idx = torch.topk(g, 3, dim=1).indices  # [I, 3]
    p = points[idx]  # [I, 3, 3]
    nvec = torch.linalg.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    nn = torch.linalg.norm(nvec, dim=1, keepdim=True)
    nvec = nvec / nn.clamp(min=1e-12)
    d = -(nvec * p[:, 0]).sum(1)  # [I]
    dist = (points @ nvec.T + d[None, :]).abs().T  # [I, N]
    dist = torch.where(valid[None, :], dist, math.inf)
    # score: the max(0.2 N, 20)-th smallest distance (ViewerAR.cc:473-474)
    nth = torch.maximum((0.2 * n_valid).to(torch.int32),
                        torch.full_like(n_valid, 20))
    nth = torch.minimum(nth, (n_valid - 1).clamp(min=0))
    sorted_d = torch.sort(dist, dim=1).values
    score = sorted_d.gather(1, nth.long().expand(iterations, 1))[:, 0]
    score = torch.where(nn[:, 0] < 1e-9, math.inf, score)
    best = torch.argmin(score)
    th = 1.4 * score[best]  # ViewerAR.cc:484
    inliers = (dist[best] < th) & valid
    return nvec[best], d[best], inliers, n_valid >= 50


def refit_plane(points: torch.Tensor, inliers: torch.Tensor):
    """All-inlier homogeneous least-squares refit (Plane::Recompute,
    ViewerAR.cc:520-547): ``(unit normal [3], origin [3])``, the origin the
    inliers' centroid, the normal the smallest-eigenvalue eigenvector of
    their centered scatter matrix (its sign is the solver's; plane_pose
    fixes it)."""
    w = inliers.to(points.dtype)
    n_in = w.sum().clamp(min=1.0)
    o = (points * w[:, None]).sum(0) / n_in
    centered = (points - o) * w[:, None]
    _, vecs = torch.linalg.eigh(centered.T @ centered)
    normal = vecs[:, 0]
    return normal / torch.linalg.norm(normal).clamp(min=1e-12), o


def plane_pose(normal: torch.Tensor, origin: torch.Tensor,
               cam_center: torch.Tensor, rang):
    """The plane-to-world transform Tpw (ViewerAR.cc:551-579): the normal
    flipped so that (cam_center - origin).n <= 0, the rotation taking +Y
    onto it after an in-plane spin ``rang``. Returns ``(Rpw [3, 3],
    origin [3])``."""
    xc = cam_center - origin
    n = torch.where((xc * normal).sum() > 0, -normal, normal)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=normal.dtype,
                      device=normal.device)
    v = torch.linalg.cross(up, n)
    sa = torch.linalg.norm(v)
    ca = (up * n).sum()
    ang = torch.atan2(sa, ca)
    axis = torch.where(sa > 1e-8, v * ang / sa.clamp(min=1e-12),
                       torch.zeros_like(v))
    rang = torch.as_tensor(rang, dtype=normal.dtype, device=normal.device)
    return exp_so3(axis) @ exp_so3(up * rang), origin


def detect_plane(points, valid, Rcw, tcw, gen: torch.Generator | None = None,
                 iterations: int = 50, gumbel=None, rang=None):
    """DetectPlane: RANSAC, inlier refit, plane pose. ``gen`` draws the
    hypotheses' noise, then the in-plane spin in [-pi/2, pi/2)
    (ViewerAR.cc:512); ``gumbel`` and ``rang`` replace those draws.
    Returns ``(Rpw, opw, inliers)`` as numpy, or None when there are too
    few points (ViewerAR.cc:414, 172-180)."""
    points = torch.as_tensor(points, dtype=torch.float32)
    dev = points.device
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    if gumbel is not None:
        gumbel = torch.as_tensor(gumbel, dtype=torch.float32, device=dev)
    _, _, inliers, ok = fit_plane_ransac(points, valid, gen, iterations,
                                         gumbel)
    if not bool(ok):
        return None
    normal, origin = refit_plane(points, inliers)
    Rcw = torch.as_tensor(Rcw, dtype=torch.float32, device=dev)
    tcw = torch.as_tensor(tcw, dtype=torch.float32, device=dev)
    if rang is None:
        rang = (torch.rand((), generator=gen, device=dev) - 0.5) * math.pi
    Rpw, opw = plane_pose(normal, origin, -Rcw.T @ tcw, rang)
    return Rpw.cpu().numpy(), opw.cpu().numpy(), inliers.cpu().numpy()


def cube_edges(size: float):
    """Wireframe of a cube of side ``size`` sitting on the plane (y in
    [-size, 0] in plane coords; the reference translates by -size/2 along
    the plane normal before glutWireCube, ViewerAR.cc:336-344)."""
    s = size / 2.0
    v = np.array([[x, y, z] for x in (-s, s) for y in (-size, 0.0)
                  for z in (-s, s)], np.float32)
    e = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
         (0, 4), (1, 5), (2, 6), (3, 7)]
    return v, e


def plane_grid(size: float, ndivs: int = 7):
    """Grid-line segment endpoints in plane coords (DrawPlane,
    ViewerAR.cc:352-376)."""
    half = ndivs * size / 2.0
    segs = []
    for i in range(ndivs + 1):
        c = -half + i * size
        segs.append(((-half, 0.0, c), (half, 0.0, c)))
        segs.append(((c, 0.0, -half), (c, 0.0, half)))
    return np.asarray(segs, np.float32)


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _draw_line(img: np.ndarray, x0, y0, x1, y1, color):
    h, w = img.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
    xs = np.linspace(x0, x1, n).round().astype(int)
    ys = np.linspace(y0, y1, n).round().astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def _project(cam, Rcw, tcw, Xw):
    Xc = Xw @ _numpy(Rcw).T + _numpy(tcw)[None, :]
    z = np.maximum(Xc[:, 2], 1e-6)
    u = float(cam.fx) * Xc[:, 0] / z + float(cam.cx)
    v = float(cam.fy) * Xc[:, 1] / z + float(cam.cy)
    return np.stack([u, v], axis=1), Xc[:, 2] > 1e-4


def draw_ar(img: np.ndarray, cam, Rcw, tcw, Rpw, opw,
            cube_size: float = 0.05, draw_grid: bool = True) -> np.ndarray:
    """Render the AR overlay: plane grid and virtual cube wireframe.

    img: grayscale [H, W] or RGB [H, W, 3] uint8. Returns RGB uint8.
    """
    g = np.clip(_numpy(img), 0, 255).astype(np.uint8)
    out = np.repeat(g[:, :, None], 3, axis=2) if g.ndim == 2 else g.copy()
    Rpw = _numpy(Rpw)
    opw = _numpy(opw)

    def to_world(P):
        return P @ Rpw.T + opw[None, :]

    if draw_grid:
        segs = plane_grid(cube_size)
        pts = to_world(segs.reshape(-1, 3))
        uv, front = _project(cam, Rcw, tcw, pts)
        for i in range(0, len(uv), 2):
            if front[i] and front[i + 1]:
                _draw_line(out, uv[i, 0], uv[i, 1], uv[i + 1, 0],
                           uv[i + 1, 1], GRID_COLOR)
    v, e = cube_edges(cube_size)
    uv, front = _project(cam, Rcw, tcw, to_world(v))
    for a, b in e:
        if front[a] and front[b]:
            _draw_line(out, uv[a, 0], uv[a, 1], uv[b, 0], uv[b, 1],
                       CUBE_EDGE_COLOR)
    return out
