"""Signed distances to the terrain (port of ``perception/sdf.py``).

On a two-layer heightfield the distance is the slope-corrected vertical gap
to the ground, ``(z - h) n_z``, or the gap to the ceiling, ``c - z``,
whichever is smaller in magnitude, with the ground normal or ``-z`` as its
gradient; it is blind to lateral faces.  With a triangle mesh attached, the
mesh's exact distance is used within its radius (``|sdf| < 0.999 r``) and
the heightfield's beyond it.  Positive in free space; the nearest surface
point is ``x - sdf·∇``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..terrain.heightfield import TerrainData, sample_ceiling, sample_height, sample_normal
from .trimesh import query_sdf_trimesh


class SDFResult(NamedTuple):
    sdf: torch.Tensor        # [...] signed distance (positive in free space)
    gradient: torch.Tensor   # [..., 3] direction of increasing distance
    nearest: torch.Tensor    # [..., 3] nearest point on the terrain surface


def query_sdf(terrain: TerrainData, points: torch.Tensor) -> SDFResult:
    """SDF, gradient and nearest surface point for ``points`` [..., 3]."""
    res_hf = _query_sdf_heightfield(terrain, points)
    mesh = terrain.trimesh
    if mesh is None:
        return res_hf
    sdf_tm, grad_tm, near_tm = query_sdf_trimesh(mesh, points)
    use_tm = sdf_tm.abs() < mesh.sdf_radius * 0.999
    return SDFResult(sdf=torch.where(use_tm, sdf_tm, res_hf.sdf),
                     gradient=torch.where(use_tm[..., None], grad_tm, res_hf.gradient),
                     nearest=torch.where(use_tm[..., None], near_tm, res_hf.nearest))


def _query_sdf_heightfield(terrain: TerrainData, points: torch.Tensor) -> SDFResult:
    xy, z = points[..., :2], points[..., 2]
    h = sample_height(terrain, xy)
    c = sample_ceiling(terrain, xy)
    n_ground = sample_normal(terrain, xy)
    d_ground = (z - h) * n_ground[..., 2]
    d_ceil = c - z
    use_ground = d_ground.abs() <= d_ceil.abs()
    sdf = torch.where(use_ground, d_ground, d_ceil)
    n_ceil = torch.zeros_like(n_ground)
    n_ceil[..., 2] = -1.0
    grad = torch.where(use_ground[..., None], n_ground, n_ceil)
    return SDFResult(sdf=sdf, gradient=grad, nearest=points - sdf[..., None] * grad)


class MeshSDF:
    """Per-point queries with the distance clipped to ``max_distance``."""

    def __init__(self, terrain: TerrainData, max_distance: float = 10.0):
        self.terrain = terrain
        self.max_distance = max_distance

    def query(self, points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        res = query_sdf(self.terrain, points)
        return res.sdf.clamp(-self.max_distance, self.max_distance), res.gradient

    def nearest_points(self, points: torch.Tensor) -> torch.Tensor:
        return query_sdf(self.terrain, points).nearest
