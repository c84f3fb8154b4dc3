"""True triangle-mesh ray casts and signed distances (port of
``perception/trimesh.py``).

The mesh is bucketed on the host into a uniform XY grid of padded
per-cell triangle lists (numpy, as in the JAX package); a query gathers the
lists it needs and tests every candidate at once:

* :func:`raycast_trimesh` marches each ray through the XY cells it crosses in
  a fixed number of steps (one cell per step, or ``max_distance / M`` for a
  near-vertical ray); each step gathers the cell's K candidates and runs a
  vectorized Möller–Trumbore test; the nearest hit so far is kept, the
  earlier step's on a tie.  Cell lists are inflated by half a cell, so a
  ray that clips a cell's corner cannot miss its triangles.
* :func:`query_sdf_trimesh` gathers the 3 x 3 cells around each point and
  takes the closest point on every candidate (Ericson's region walk); the
  sign comes from the best-aligned face normal among the triangles within
  1e-4 of the minimum, which holds at shared edges and vertices.  Exact
  within one cell of the surface; farther, the magnitude is clamped to the
  cell size and the sign kept; points with no real triangle nearby read the
  positive bound.

Index T (one past the real triangles) is a far, degenerate sentinel that
pads the lists; it is never hit and never nearest.  Gathers index with
int64; ``torch.argmin`` / ``torch.argmax`` return the first index on ties,
as ``jnp.argmin`` / ``jnp.argmax`` do.  Queries run in the dtype of their
points (the tables are cast to it).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.math import cross


@dataclass(frozen=True, eq=False)
class TriMeshData:
    """Grid-bucketed triangle mesh (host arrays; tensors per device and dtype
    on demand).  Triangle t is (v0[t], v0[t]+e1[t], v0[t]+e2[t])."""

    v0: np.ndarray           # [T+1, 3] float32
    e1: np.ndarray           # [T+1, 3]
    e2: np.ndarray           # [T+1, 3]
    normal: np.ndarray       # [T+1, 3] unit face normals
    cell_tris: np.ndarray    # [nx*ny, K] int32 per-cell lists (½-cell inflation)
    origin: Tuple[float, float]   # world xy of cell (0, 0)'s corner, float32-exact
    cell_size: float = 0.5
    nx: int = 1
    ny: int = 1
    _tensors: Dict[Tuple[str, torch.dtype], Dict[str, torch.Tensor]] = field(
        default_factory=dict, repr=False, compare=False)

    @property
    def sdf_radius(self) -> float:
        """SDF queries are exact within one cell of the surface (3 x 3 gather)."""
        return self.cell_size

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0] - 1

    def torch(self, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
        """The tables as ``dtype`` tensors on ``device`` and ``cell_tris`` as
        int64 (cached)."""
        key = (str(torch.device(device)), dtype)
        if key not in self._tensors:
            t = {k: torch.as_tensor(getattr(self, k), device=device).to(dtype)
                 for k in ("v0", "e1", "e2", "normal")}
            t["cell_tris"] = torch.as_tensor(self.cell_tris, device=device).to(torch.int64)
            self._tensors[key] = t
        return self._tensors[key]


# ---------------------------------------------------------------------------
# host-side construction (numpy, as in the JAX package)
# ---------------------------------------------------------------------------

def _bucket(tv: np.ndarray, origin, cell_size: float, nx: int, ny: int,
            inflate: float) -> np.ndarray:
    """Per-cell padded triangle-id lists: triangle t lands in every cell whose
    (inflated) square overlaps its XY AABB.  Returns [nx*ny, K] int32 padded
    with T (the sentinel id), K a multiple of 8.  Vectorized over triangles;
    the rare oversized triangle is looped."""
    T = tv.shape[0]
    xy_min = tv[..., :2].min(axis=1) - inflate
    xy_max = tv[..., :2].max(axis=1) + inflate
    i0 = np.clip(np.floor((xy_min[:, 0] - origin[0]) / cell_size), 0, nx - 1).astype(np.int64)
    i1 = np.clip(np.floor((xy_max[:, 0] - origin[0]) / cell_size), 0, nx - 1).astype(np.int64)
    j0 = np.clip(np.floor((xy_min[:, 1] - origin[1]) / cell_size), 0, ny - 1).astype(np.int64)
    j1 = np.clip(np.floor((xy_max[:, 1] - origin[1]) / cell_size), 0, ny - 1).astype(np.int64)
    si = i1 - i0 + 1
    sj = j1 - j0 + 1

    cells_of_tri = []
    tri_of_entry = []
    big = (si > 16) | (sj > 16)
    small = np.where(~big)[0]
    if small.size:
        for di in range(int(si[small].max())):
            for dj in range(int(sj[small].max())):
                sel = small[(di < si[small]) & (dj < sj[small])]
                if sel.size:
                    cells_of_tri.append((i0[sel] + di) * ny + (j0[sel] + dj))
                    tri_of_entry.append(sel)
    for t in np.where(big)[0]:
        ii = np.arange(i0[t], i1[t] + 1)
        jj = np.arange(j0[t], j1[t] + 1)
        cid = (ii[:, None] * ny + jj[None, :]).ravel()
        cells_of_tri.append(cid)
        tri_of_entry.append(np.full(cid.size, t, dtype=np.int64))
    cid = np.concatenate(cells_of_tri) if cells_of_tri else np.zeros(0, np.int64)
    tid = np.concatenate(tri_of_entry) if tri_of_entry else np.zeros(0, np.int64)

    counts = np.bincount(cid, minlength=nx * ny)
    K = int(counts.max()) if counts.size else 1
    K = max(1, -(-K // 8) * 8)
    lists = np.full((nx * ny, K), T, dtype=np.int32)
    order = np.argsort(cid, kind="stable")
    cid, tid = cid[order], tid[order]
    slot = np.arange(cid.size) - np.concatenate([[0], np.cumsum(counts)[:-1]])[cid]
    lists[cid, slot] = tid
    return lists


def build_trimesh(vertices: np.ndarray, triangles: np.ndarray,
                  cell_size: Optional[float] = None,
                  max_cells: int = 1 << 20) -> TriMeshData:
    """Bucket a triangle mesh for device queries.  ``cell_size`` defaults to
    about twice the median triangle XY extent (in [0.05, 2]); it also sets
    the exact-SDF radius."""
    vertices = np.asarray(vertices, dtype=np.float32)
    triangles = np.asarray(triangles, dtype=np.int64)
    tv = vertices[triangles]  # [T, 3, 3]
    if cell_size is None:
        ext = (tv[..., :2].max(axis=1) - tv[..., :2].min(axis=1)).max(axis=-1)
        cell_size = float(np.clip(2.0 * np.median(ext) if ext.size else 0.5, 0.05, 2.0))
    vmin = vertices.min(axis=0)
    vmax = vertices.max(axis=0)
    nx = int(np.ceil((vmax[0] - vmin[0]) / cell_size)) + 1
    ny = int(np.ceil((vmax[1] - vmin[1]) / cell_size)) + 1
    while nx * ny > max_cells:
        cell_size *= 1.5
        nx = int(np.ceil((vmax[0] - vmin[0]) / cell_size)) + 1
        ny = int(np.ceil((vmax[1] - vmin[1]) / cell_size)) + 1
    origin = vmin[:2]

    cell_tris = _bucket(tv, origin, cell_size, nx, ny, inflate=0.5 * cell_size)

    v0 = tv[:, 0]
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    n = np.cross(e1, e2)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    # sentinel: far away, degenerate (never hit, never nearest)
    v0 = np.concatenate([v0, [[1e6, 1e6, 1e6]]], axis=0).astype(np.float32)
    e1 = np.concatenate([e1, [[0.0, 0.0, 0.0]]], axis=0).astype(np.float32)
    e2 = np.concatenate([e2, [[0.0, 0.0, 0.0]]], axis=0).astype(np.float32)
    n = np.concatenate([n, [[0.0, 0.0, 1.0]]], axis=0).astype(np.float32)
    return TriMeshData(v0=v0, e1=e1, e2=e2, normal=n, cell_tris=cell_tris,
                       origin=(float(origin[0]), float(origin[1])), cell_size=float(cell_size),
                       nx=nx, ny=ny)


def trimesh_from_heightfield(ground: np.ndarray, hscale: float, origin=(0.0, 0.0),
                             ceiling: Optional[np.ndarray] = None,
                             slope_threshold: Optional[float] = None,
                             **build_kw) -> TriMeshData:
    """Triangulate a (two-layer) heightfield into a mesh, then bucket it.

    With ``slope_threshold`` the vertices of steep cell edges are shifted a
    cell sideways, which turns the slopes into vertical wall faces.  Ground
    faces point up (+z) and ceiling faces down (-z), so the SDF is positive
    in the free space between them.  Open-sky ceiling cells (>= 1e5) are
    clamped to a roof 3 m above the highest real ceiling: triangulating the
    1e6 sentinel would make kilometre-tall quads that ruin float32
    intersections."""
    layers = [(np.asarray(ground, np.float64), False)]
    if ceiling is not None and np.asarray(ceiling).min() < 1e5:
        c = np.asarray(ceiling, np.float64)
        roof = c[c < 1e5].max() + 3.0
        layers.append((np.minimum(c, roof), True))

    all_v, all_f = [], []
    voff = 0
    for h, flip in layers:
        H, W = h.shape
        xs = origin[0] + np.arange(H) * hscale
        ys = origin[1] + np.arange(W) * hscale
        X, Y = np.meshgrid(xs, ys, indexing="ij")
        Xc, Yc = X.copy(), Y.copy()
        if slope_threshold is not None:
            thr = slope_threshold * hscale
            dx = np.zeros_like(h)
            dy = np.zeros_like(h)
            dx[:-1] += (h[1:] - h[:-1] > thr)
            dx[1:] -= (h[:-1] - h[1:] > thr)
            dy[:, :-1] += (h[:, 1:] - h[:, :-1] > thr)
            dy[:, 1:] -= (h[:, :-1] - h[:, 1:] > thr)
            Xc += np.clip(dx, -1, 1) * hscale
            Yc += np.clip(dy, -1, 1) * hscale
        V = np.stack([Xc.ravel(), Yc.ravel(), h.ravel()], axis=-1)
        idx = np.arange(H * W).reshape(H, W)
        a = idx[:-1, :-1].ravel()
        b = idx[:-1, 1:].ravel()
        c = idx[1:, :-1].ravel()
        d = idx[1:, 1:].ravel()
        if flip:  # ceiling: wound to face down
            F = np.concatenate([np.stack([a, b, c], -1), np.stack([b, d, c], -1)])
        else:     # ground: wound to face up
            F = np.concatenate([np.stack([a, c, b], -1), np.stack([b, c, d], -1)])
        all_v.append(V)
        all_f.append(F + voff)
        voff += V.shape[0]

    build_kw.setdefault("cell_size", max(2.0 * hscale, 0.1))
    return build_trimesh(np.concatenate(all_v), np.concatenate(all_f), **build_kw)


# ---------------------------------------------------------------------------
# device queries
# ---------------------------------------------------------------------------

def _cell_coords(mesh: TriMeshData, xy: torch.Tensor):
    gi = torch.floor((xy[..., 0] - mesh.origin[0]) / mesh.cell_size).clamp(0, mesh.nx - 1)
    gj = torch.floor((xy[..., 1] - mesh.origin[1]) / mesh.cell_size).clamp(0, mesh.ny - 1)
    return gi.to(torch.int64), gj.to(torch.int64)


def _cell_id(mesh: TriMeshData, xy: torch.Tensor) -> torch.Tensor:
    gi, gj = _cell_coords(mesh, xy)
    return gi * mesh.ny + gj


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _moller_trumbore(v0, e1, e2, origin, direction):
    """Ray-triangle intersection -> t (inf on a miss).  ``origin`` and
    ``direction`` [..., 1, 3] broadcast against triangles [..., K, 3]."""
    pvec = cross(direction, e2)
    det = _dot(e1, pvec)
    ok_det = det.abs() > 1e-9
    inv = torch.where(ok_det, 1.0 / torch.where(ok_det, det, torch.ones_like(det)),
                      torch.zeros_like(det))
    tvec = origin - v0
    u = _dot(tvec, pvec) * inv
    qvec = cross(tvec, e1)
    v = _dot(direction, qvec) * inv
    t = _dot(e2, qvec) * inv
    eps = 1e-6
    ok = ok_det & (u >= -eps) & (v >= -eps) & (u + v <= 1.0 + eps) & (t > 1e-5)
    return torch.where(ok, t, torch.full_like(t, float("inf")))


def raycast_trimesh(mesh: TriMeshData, origins: torch.Tensor, dirs: torch.Tensor,
                    max_distance: float):
    """Rays [..., 3] against the mesh: ``(distance, hit, points, normal)``,
    the nearest hit within ``max_distance`` (``max_distance``, the end point
    and a zero normal on a miss)."""
    shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    R = o.shape[0]
    T = mesh.torch(o.device, o.dtype)

    # per-ray parametric step: one cell in XY per step, at most max_distance,
    # so near-vertical rays end within M steps too
    cs = mesh.cell_size
    M = min(int(np.ceil(float(max_distance) / cs)) + 2, 256)
    dxy = torch.linalg.norm(d[:, :2], dim=-1)
    dt = torch.where(dxy > 1e-6, cs / dxy.clamp(min=1e-6),
                     torch.full_like(dxy, max_distance)).clamp(max=max_distance)

    best_t = torch.full((R,), float("inf"), dtype=o.dtype, device=o.device)
    best_tri = torch.full((R,), mesh.num_triangles, dtype=torch.int64, device=o.device)
    for i in range(M):
        p = o + d * (float(i) * dt)[:, None]
        ids = T["cell_tris"][_cell_id(mesh, p[:, :2])]                   # [R, K]
        t = _moller_trumbore(T["v0"][ids], T["e1"][ids], T["e2"][ids], o[:, None, :],
                             d[:, None, :])                               # [R, K]
        t = torch.where(t <= max_distance, t, torch.full_like(t, float("inf")))
        k = torch.argmin(t, dim=-1, keepdim=True)
        tmin = t.gather(-1, k)[:, 0]
        upd = tmin < best_t
        best_t = torch.where(upd, tmin, best_t)
        best_tri = torch.where(upd, ids.gather(-1, k)[:, 0], best_tri)

    hit = torch.isfinite(best_t)
    dist = torch.where(hit, best_t, torch.full_like(best_t, max_distance))
    points = o + d * dist[:, None]
    normal = torch.where(hit[:, None], T["normal"][best_tri], torch.zeros_like(points))
    return (dist.reshape(shape), hit.reshape(shape), points.reshape(shape + (3,)),
            normal.reshape(shape + (3,)))


def _closest_point_triangle(p, v0, e1, e2):
    """Closest point on triangle (v0, v0+e1, v0+e2) to ``p`` [..., 1, 3]
    (triangles [..., K, 3]): Ericson's clamped-barycentric region walk
    (Real-Time Collision Detection 5.1.5), branch-free."""
    ab, ac = e1, e2
    ap = p - v0
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = p - (v0 + ab)
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp_ = p - (v0 + ac)
    d5, d6 = _dot(ab, cp_), _dot(ac, cp_)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = (va + vb + vc).clamp(min=1e-20)
    v = vb / denom
    w = vc / denom
    zero, one = torch.zeros_like(v), torch.ones_like(v)

    def safe(x):
        return torch.where(x.abs() > 1e-20, x, torch.full_like(x, 1e-20))

    in_a = (d1 <= 0) & (d2 <= 0)                        # vertex A
    v, w = torch.where(in_a, zero, v), torch.where(in_a, zero, w)
    in_b = (d3 >= 0) & (d4 <= d3)                       # vertex B
    v, w = torch.where(in_b, one, v), torch.where(in_b, zero, w)
    in_c = (d6 >= 0) & (d5 <= d6)                       # vertex C
    v, w = torch.where(in_c, zero, v), torch.where(in_c, one, w)
    in_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)           # edge AB
    v, w = torch.where(in_ab, d1 / safe(d1 - d3), v), torch.where(in_ab, zero, w)
    in_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)           # edge AC
    v, w = torch.where(in_ac, zero, v), torch.where(in_ac, d2 / safe(d2 - d6), w)
    in_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)  # edge BC
    t_bc = (d4 - d3) / safe((d4 - d3) + (d5 - d6))
    v, w = torch.where(in_bc, 1.0 - t_bc, v), torch.where(in_bc, t_bc, w)

    v, w = v.clamp(0.0, 1.0), w.clamp(0.0, 1.0)
    return v0 + ab * v[..., None] + ac * w[..., None]


def query_sdf_trimesh(mesh: TriMeshData, points: torch.Tensor):
    """Signed distance, gradient and nearest surface point for points
    [..., 3]: ``(sdf [...], grad [..., 3], nearest [..., 3])``; positive in
    free space."""
    shape = points.shape[:-1]
    p = points.reshape(-1, 3)
    T = mesh.torch(p.device, p.dtype)
    gi, gj = _cell_coords(mesh, p[:, :2])
    ids = torch.cat([T["cell_tris"][(gi + di).clamp(0, mesh.nx - 1) * mesh.ny
                                    + (gj + dj).clamp(0, mesh.ny - 1)]
                     for di in (-1, 0, 1) for dj in (-1, 0, 1)], dim=-1)   # [P, 9K]
    n = T["normal"][ids]
    cp = _closest_point_triangle(p[:, None, :], T["v0"][ids], T["e1"][ids], T["e2"][ids])
    u = p[:, None, :] - cp
    d = torch.linalg.norm(u, dim=-1)                                     # [P, 9K]
    dmin = d.amin(dim=-1)

    # among triangles within 1e-4 of the minimum, trust the one whose normal
    # is most aligned with p - cp: the sign holds at shared edges and vertices
    align = _dot(u, n).abs() / d.clamp(min=1e-9)
    score = torch.where(d <= dmin[:, None] + 1e-4, align, torch.full_like(align, -1.0))
    k = torch.argmax(score, dim=-1)
    rows = torch.arange(p.shape[0], device=p.device)
    u_b, n_b, cp_b, d_b = u[rows, k], n[rows, k], cp[rows, k], d[rows, k]
    sgn = torch.where(_dot(u_b, n_b) >= 0.0, 1.0, -1.0).to(p.dtype)

    sdf = sgn * dmin
    # the gradient is u_b over its own length: the chosen triangle may lie up
    # to 1e-4 farther than dmin, and u_b / dmin (the JAX package's) is then
    # longer than 1 near the surface, which makes the contact damper
    # kt I + (kd - kt) n nᵀ indefinite
    grad = torch.where(dmin[:, None] > 1e-6, sgn[:, None] * u_b / d_b.clamp(min=1e-9)[:, None],
                       n_b)
    # beyond the bucketing radius closer triangles may sit in unvisited cells:
    # clamp the magnitude but keep the sign (a point deep inside stays
    # negative); sentinel-only neighbourhoods read the positive bound
    r = mesh.sdf_radius
    sdf = torch.where(dmin < 1e5, sdf.clamp(-r, r), torch.full_like(sdf, r))
    return sdf.reshape(shape), grad.reshape(shape + (3,)), cp_b.reshape(shape + (3,))
