"""Rays against the terrain (port of ``perception/raycast.py``).

On a terrain that carries a triangle mesh (confined and OBJ terrains) a ray
is cast against the mesh exactly (``perception/trimesh.raycast_trimesh``):
lateral faces and thin features included.  Otherwise a ray is marched in
``MARCH_STEPS`` evenly spaced samples from its origin to ``max_distance``;
the first sample outside the free space and the one before it bracket the
hit, and ``BISECT_STEPS`` halvings of the bracket give the distance (to
``max_distance / 2**13``).  The march is one batched height
lookup over ``[..., R, MARCH_STEPS]``, the bisection a loop of eight steps on
``[..., R]``.  A ray that never leaves the free space reports
``max_distance``.  Under a ceiling the free space is ``ground < z <
ceiling``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..terrain.heightfield import TerrainData, sample_ceiling, sample_height
from ..utils.device import resolve_device
from ..utils.math import quat_rotate, yaw_quat
from .patterns import make_pattern
from .trimesh import raycast_trimesh

MARCH_STEPS = 48
BISECT_STEPS = 8


class RaycastResult(NamedTuple):
    distance: torch.Tensor   # [..., R] hit distance (max_distance on a miss)
    hit: torch.Tensor        # [..., R] bool
    points: torch.Tensor     # [..., R, 3] hit point (the end point on a miss)


def _below(terrain: TerrainData, p: torch.Tensor) -> torch.Tensor:
    """Points [..., 3] outside the free space: under the ground or above
    the ceiling."""
    gap = p[..., 2] - sample_height(terrain, p[..., :2])
    if terrain.has_ceiling:
        gap = torch.minimum(gap, sample_ceiling(terrain, p[..., :2]) - p[..., 2])
    return gap < 0.0


def raycast(terrain: TerrainData, origins: torch.Tensor, dirs: torch.Tensor,
            max_distance: float) -> RaycastResult:
    """Rays from ``origins`` along unit ``dirs`` (both [..., R, 3])."""
    if terrain.trimesh is not None:
        dist, hit, points, _ = raycast_trimesh(terrain.trimesh, origins, dirs, max_distance)
        return RaycastResult(distance=dist, hit=hit, points=points)
    ts = torch.linspace(0.0, 1.0, MARCH_STEPS, device=origins.device) * max_distance
    below = _below(terrain, origins[..., None, :] + dirs[..., None, :] * ts[:, None])
    any_hit = below.any(dim=-1)
    # the first sample below the ground (index M where none is), bracketed
    # with the one before it
    idx = torch.arange(MARCH_STEPS, device=origins.device)
    first = torch.where(below, idx, MARCH_STEPS).amin(dim=-1).clamp(1, MARCH_STEPS - 1)
    lo, hi = ts[first - 1], ts[first]
    for _ in range(BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        inside = _below(terrain, origins + dirs * mid[..., None])
        lo = torch.where(inside, lo, mid)
        hi = torch.where(inside, mid, hi)
    dist = torch.where(any_hit, 0.5 * (lo + hi), torch.full_like(lo, max_distance))
    return RaycastResult(distance=dist, hit=any_hit, points=origins + dirs * dist[..., None])


class RayCaster:
    """A fixed ray pattern attached to the base with an offset, turned by the
    full base quaternion or by its yaw only."""

    def __init__(self, cfg, terrain: TerrainData, device="cuda"):
        device = resolve_device(device)
        self.cfg, self.terrain = cfg, terrain
        pat = make_pattern(cfg)
        # every ray of these patterns starts at the mount offset
        offset = np.asarray(cfg.offset_pos, np.float32)
        self.ray_starts = torch.as_tensor(np.broadcast_to(offset, pat.shape).copy(), device=device)
        self.ray_dirs = torch.as_tensor(pat, device=device)
        self.num_rays = int(pat.shape[0])

    def cast(self, base_pos: torch.Tensor, base_quat: torch.Tensor) -> RaycastResult:
        """[B, 3], [B, 4] -> distances [B, R] and the rest."""
        q = yaw_quat(base_quat) if self.cfg.attach_yaw_only else base_quat
        origins = base_pos[:, None, :] + quat_rotate(q[:, None, :], self.ray_starts[None])
        dirs = quat_rotate(q[:, None, :], self.ray_dirs[None])
        return raycast(self.terrain, origins, dirs, self.cfg.max_distance)

    def observations(self, base_pos: torch.Tensor, base_quat: torch.Tensor) -> torch.Tensor:
        """Normalized inverse distances [B, R] in [0, 1]: 1 at the sensor,
        0 at ``max_distance`` or beyond."""
        res = self.cast(base_pos, base_quat)
        return 1.0 - torch.clamp(res.distance / self.cfg.max_distance, 0.0, 1.0)
