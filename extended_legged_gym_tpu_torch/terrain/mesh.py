"""OBJ mesh terrains (port of ``terrain/mesh.py``, host numpy).

The mesh is rasterized once at load time into a two-layer (ground +
ceiling) heightfield by intersecting the vertical line through each grid
cell with every triangle over it: the ground is the highest surface at or
below ``z_ref``, the ceiling the lowest above it.  Contacts sample the two
layers; the true mesh rides along (``to_device``) for ray casts and SDF
queries.  ``get_heights_batch(positions, cast_dir)`` reads the ground
(``-1``) or ceiling (``+1``) layer for spawn heights.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..perception.trimesh import build_trimesh
from .heightfield import TerrainData, from_numpy


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ parser → (vertices [V, 3], triangles [T, 3] int)."""
    verts = []
    faces = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate polygons
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int64)


def rasterize_mesh(vertices: np.ndarray, triangles: np.ndarray, hscale: float,
                   z_ref: float = 0.5, pad: float = 0.0):
    """Rasterize a triangle mesh into ground/ceiling heightfields.

    Per grid cell, the vertical line through the cell center is intersected
    with all overlapping triangles; among the hit z values, ground = highest
    surface at or below ``z_ref``, ceiling = lowest surface above it."""
    vmin = vertices.min(axis=0) - pad
    vmax = vertices.max(axis=0) + pad
    H = max(2, int(np.ceil((vmax[0] - vmin[0]) / hscale)) + 1)
    W = max(2, int(np.ceil((vmax[1] - vmin[1]) / hscale)) + 1)
    ground = np.full((H, W), vmin[2] - 1.0, dtype=np.float64)
    ceiling = np.full((H, W), 1e6, dtype=np.float64)

    tv = vertices[triangles]  # [T, 3, 3]
    for t in range(tv.shape[0]):
        a, b, c = tv[t]
        xy_min = np.minimum(np.minimum(a[:2], b[:2]), c[:2])
        xy_max = np.maximum(np.maximum(a[:2], b[:2]), c[:2])
        i0 = max(0, int(np.floor((xy_min[0] - vmin[0]) / hscale)))
        i1 = min(H - 1, int(np.ceil((xy_max[0] - vmin[0]) / hscale)))
        j0 = max(0, int(np.floor((xy_min[1] - vmin[1]) / hscale)))
        j1 = min(W - 1, int(np.ceil((xy_max[1] - vmin[1]) / hscale)))
        if i1 < i0 or j1 < j0:
            continue
        ii, jj = np.meshgrid(np.arange(i0, i1 + 1), np.arange(j0, j1 + 1),
                             indexing="ij")
        px = vmin[0] + ii * hscale
        py = vmin[1] + jj * hscale
        # barycentric coordinates in the xy plane
        v0 = b[:2] - a[:2]
        v1 = c[:2] - a[:2]
        den = v0[0] * v1[1] - v1[0] * v0[1]
        if abs(den) < 1e-12:
            continue
        wx = px - a[0]
        wy = py - a[1]
        l1 = (wx * v1[1] - v1[0] * wy) / den
        l2 = (v0[0] * wy - wx * v0[1]) / den
        l0 = 1.0 - l1 - l2
        eps = -1e-9
        inside = (l0 >= eps) & (l1 >= eps) & (l2 >= eps)
        if not inside.any():
            continue
        z = l0 * a[2] + l1 * b[2] + l2 * c[2]
        below = inside & (z <= z_ref)
        above = inside & (z > z_ref)
        sub_g = ground[i0:i1 + 1, j0:j1 + 1]
        sub_c = ceiling[i0:i1 + 1, j0:j1 + 1]
        np.maximum(sub_g, np.where(below, z, -1e9), out=sub_g)
        np.minimum(sub_c, np.where(above, z, 1e9), out=sub_c)

    # cells never covered by a ground triangle fall to the mesh floor
    ground[ground < vmin[2] - 0.5] = float(vertices[:, 2].min())
    return ground.astype(np.float32), ceiling.astype(np.float32), vmin


class TerrainObj:
    """An OBJ terrain: the rasterized layers, height queries and the
    terrain data."""

    def __init__(self, terrain_file: str, hscale: float = 0.1,
                 z_ref: float = 0.5, border_size: float = 0.0,
                 friction: float = 1.0):
        verts, tris = load_obj(terrain_file)
        self.vertices = verts
        self.triangles = tris
        ground, ceiling, vmin = rasterize_mesh(verts, tris, hscale, z_ref,
                                               pad=border_size)
        self.ground = ground
        self.ceiling = ceiling
        self.origin = (float(vmin[0]), float(vmin[1]))
        self.hscale = hscale
        self.friction = friction

    def get_heights_batch(self, positions: np.ndarray, cast_dir: int = -1) -> np.ndarray:
        """Host-side spawn heights: cast_dir=-1 reads the ground layer, +1
        the ceiling layer."""
        layer = self.ground if cast_dir < 0 else self.ceiling
        gi = np.clip(((positions[:, 0] - self.origin[0]) / self.hscale).astype(int),
                     0, layer.shape[0] - 1)
        gj = np.clip(((positions[:, 1] - self.origin[1]) / self.hscale).astype(int),
                     0, layer.shape[1] - 1)
        return layer[gi, gj]

    def to_device(self, attach_trimesh: bool = True) -> TerrainData:
        """The rasterized layers as :class:`TerrainData` (they carry the
        contacts); with ``attach_trimesh`` the true mesh rides along for ray
        casts and SDF queries (lateral faces, more than two layers)."""
        trimesh = None
        if attach_trimesh and len(self.triangles):
            trimesh = build_trimesh(self.vertices, self.triangles)
        return from_numpy(self.ground, self.hscale, origin=self.origin,
                          friction=self.friction, ceiling=self.ceiling,
                          trimesh=trimesh)
