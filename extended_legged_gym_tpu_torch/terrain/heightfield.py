"""Heightfield terrain (port of ``terrain/heightfield.py``): a regular grid of
ground heights, sampled bilinearly, with an optional ceiling layer (confined
terrains) and an optional triangle mesh.

The terrain is made on the host with numpy and kept there; :meth:`TerrainData.torch`
gives the corner textures on a device, cached per device, as ``RobotModel.torch``
does.  A constant-height grid is flat (``is_flat``): sampling it reads no
grid, and the physics kernel takes its flat regime (B1) for it.

Two-layer terrains: ``ceiling[i, j]`` is the height of the ceiling above
the ground cell (``1e6`` where the sky is open); ``has_ceiling`` is set when
any cell lies below ``1e5``.  ``trimesh`` (``perception/trimesh.TriMeshData``)
carries a true triangle mesh of the scene: ray casts and SDF queries use it,
and with ``contact_trimesh`` the physics contacts do too.  A terrain with a
ceiling or with mesh contacts is stepped by the plain ABA engine
(``physics/engine.EngineEnvStep``): the fused kernel has no ceiling branch.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

OPEN_SKY = 1e6            # ceiling of a cell without one


@dataclass(frozen=True, eq=False)
class TerrainData:
    """Regular-grid heightfield.  ``height[i, j]`` is the terrain height at
    ``x = origin[0] + i * hscale``, ``y = origin[1] + j * hscale``."""

    height: np.ndarray                 # [H, W] float32 (meters)
    hscale: float                      # horizontal grid spacing (meters), float32-exact
    origin: Tuple[float, float]        # world xy of grid index (0, 0), float32-exact
    friction: float                    # terrain friction coefficient
    is_flat: bool                      # constant height: sampling reads no grid
    height00: float                    # height[0, 0]
    # corner-packed texture [H·W, 4], rows [h(i,j), h(i,j+1), h(i+1,j), h(i+1,j+1)]:
    # one 16-byte read fetches all four bilinear corners; None when flat
    corner_tex: Optional[np.ndarray] = None
    ceiling: Optional[np.ndarray] = None       # [H, W] float32, OPEN_SKY where open
    ceiling_tex: Optional[np.ndarray] = None   # corner-packed ceiling, with has_ceiling
    has_ceiling: bool = False                  # some cell has a ceiling below 1e5
    trimesh: Any = None                        # perception/trimesh.TriMeshData or None
    contact_trimesh: bool = False              # physics contacts on the triangle mesh
    _tensors: Dict[str, Dict[str, torch.Tensor]] = field(
        default_factory=dict, repr=False, compare=False)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.height.shape

    def replace(self, **changes) -> "TerrainData":
        """A copy with ``changes`` (and an empty device cache)."""
        return dataclasses.replace(self, _tensors={}, **changes)

    def torch(self, device) -> Dict[str, torch.Tensor]:
        """``corner_tex`` (and ``ceiling_tex`` with a ceiling) as float32
        tensors on ``device`` (cached)."""
        key = str(torch.device(device))
        if key not in self._tensors:
            t = {}
            for name in ("corner_tex", "ceiling_tex"):
                if getattr(self, name) is not None:
                    t[name] = torch.as_tensor(getattr(self, name), device=device)
            self._tensors[key] = t
        return self._tensors[key]


def _corner_pack(grid: np.ndarray) -> np.ndarray:
    """[H, W] -> [H·W, 4] rows [h(i,j), h(i,j+1), h(i+1,j), h(i+1,j+1)].
    Rolled edge rows are never read (grid coords clip to H-2 / W-2)."""
    g = np.asarray(grid, dtype=np.float32)
    packed = np.stack([g, np.roll(g, -1, 1), np.roll(g, -1, 0),
                       np.roll(np.roll(g, -1, 0), -1, 1)], axis=-1)
    return np.ascontiguousarray(packed.reshape(-1, 4))


def from_numpy(height: np.ndarray, hscale: float, origin=(0.0, 0.0),
               friction: float = 1.0, ceiling: Optional[np.ndarray] = None,
               trimesh=None) -> TerrainData:
    h = np.ascontiguousarray(height, dtype=np.float32)
    is_flat = bool(np.ptp(h) < 1e-9)
    has_ceiling = ceiling is not None and bool((np.asarray(ceiling) < 1e5).any())
    c = (np.full_like(h, OPEN_SKY) if ceiling is None
         else np.ascontiguousarray(ceiling, dtype=np.float32))
    f32 = lambda x: float(np.float32(x))
    return TerrainData(height=h, hscale=f32(hscale), origin=(f32(origin[0]), f32(origin[1])),
                       friction=f32(friction), is_flat=is_flat, height00=float(h[0, 0]),
                       corner_tex=None if is_flat else _corner_pack(h), ceiling=c,
                       ceiling_tex=_corner_pack(c) if has_ceiling else None,
                       has_ceiling=has_ceiling, trimesh=trimesh)


def flat_terrain(friction: float = 1.0, height: float = 0.0) -> TerrainData:
    """A plane at ``height`` (a 2 x 2 constant grid)."""
    return from_numpy(np.full((2, 2), height, np.float32), 1.0, friction=friction)


def _grid_coords(terrain: TerrainData, xy: torch.Tensor):
    H, W = terrain.shape
    gx = (xy[..., 0] - terrain.origin[0]) / terrain.hscale
    gy = (xy[..., 1] - terrain.origin[1]) / terrain.hscale
    return gx.clamp(0.0, H - 1.001), gy.clamp(0.0, W - 1.001)


def _corners(terrain: TerrainData, gx: torch.Tensor, gy: torch.Tensor, tex: str = "corner_tex"):
    """The four bilinear corners of texture ``tex`` (one row per point) and
    the cell fractions.  The flat index is clamped into the grid so that a
    non-finite point reads a real cell (its result stays non-finite through
    ``fx``)."""
    H, W = terrain.shape
    x0, y0 = torch.floor(gx), torch.floor(gy)
    base = (x0.to(torch.int64) * W + y0.to(torch.int64)).clamp(0, H * W - 1)
    rows = terrain.torch(gx.device)[tex][base]                   # [..., 4]
    return rows[..., 0], rows[..., 2], rows[..., 1], rows[..., 3], gx - x0, gy - y0


def _bilinear(h00, h10, h01, h11, fx, fy):
    return h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy) + h01 * (1 - fx) * fy + h11 * fx * fy


def sample_height(terrain: TerrainData, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear ground height at world xy positions [..., 2] -> [...]."""
    if terrain.is_flat:
        return torch.full(xy.shape[:-1], terrain.height00, dtype=xy.dtype, device=xy.device)
    return _bilinear(*_corners(terrain, *_grid_coords(terrain, xy)))


def sample_ceiling(terrain: TerrainData, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear ceiling height at world xy [..., 2] -> [...]; ``OPEN_SKY``
    everywhere on a terrain without a ceiling."""
    if not terrain.has_ceiling:
        return torch.full(xy.shape[:-1], OPEN_SKY, dtype=xy.dtype, device=xy.device)
    return _bilinear(*_corners(terrain, *_grid_coords(terrain, xy), tex="ceiling_tex"))


def sample_height_and_normal(terrain: TerrainData, xy: torch.Tensor):
    """Height and surface normal from one corner read: the normal is the
    analytic gradient of the bilinear patch, normalised.  A flat terrain
    reads nothing and returns ``n = z``."""
    if terrain.is_flat:
        h = torch.full(xy.shape[:-1], terrain.height00, dtype=xy.dtype, device=xy.device)
        n = torch.zeros(xy.shape[:-1] + (3,), dtype=xy.dtype, device=xy.device)
        n[..., 2] = 1.0
        return h, n
    h00, h10, h01, h11, fx, fy = _corners(terrain, *_grid_coords(terrain, xy))
    h = _bilinear(h00, h10, h01, h11, fx, fy)
    dhdx = ((h10 - h00) * (1 - fy) + (h11 - h01) * fy) / terrain.hscale
    dhdy = ((h01 - h00) * (1 - fx) + (h11 - h10) * fx) / terrain.hscale
    n = torch.stack([-dhdx, -dhdy, torch.ones_like(h)], dim=-1)
    return h, n / torch.linalg.norm(n, dim=-1, keepdim=True)


def sample_normal(terrain: TerrainData, xy: torch.Tensor) -> torch.Tensor:
    """Terrain surface normal (the bilinear patch's analytic gradient)."""
    return sample_height_and_normal(terrain, xy)[1]
