"""Heightfield terrain (port of ``terrain/heightfield.py``, without ceilings
and trimeshes): a regular grid of heights, sampled bilinearly.

The terrain is made on the host with numpy and kept there; :meth:`TerrainData.torch`
gives the corner texture on a device, cached per device, as ``RobotModel.torch``
does.  A constant-height grid is flat (``is_flat``): sampling it reads no
grid, and the physics kernel takes its flat regime (B1) for it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch


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
    _tensors: Dict[str, Dict[str, torch.Tensor]] = field(
        default_factory=dict, repr=False, compare=False)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.height.shape

    def torch(self, device) -> Dict[str, torch.Tensor]:
        """``corner_tex`` as a float32 tensor on ``device`` (cached; a
        heightfield only)."""
        key = str(torch.device(device))
        if key not in self._tensors:
            self._tensors[key] = {"corner_tex": torch.as_tensor(self.corner_tex, device=device)}
        return self._tensors[key]


def _corner_pack(grid: np.ndarray) -> np.ndarray:
    """[H, W] -> [H·W, 4] rows [h(i,j), h(i,j+1), h(i+1,j), h(i+1,j+1)].
    Rolled edge rows are never read (grid coords clip to H-2 / W-2)."""
    g = np.asarray(grid, dtype=np.float32)
    packed = np.stack([g, np.roll(g, -1, 1), np.roll(g, -1, 0),
                       np.roll(np.roll(g, -1, 0), -1, 1)], axis=-1)
    return np.ascontiguousarray(packed.reshape(-1, 4))


def from_numpy(height: np.ndarray, hscale: float, origin=(0.0, 0.0),
               friction: float = 1.0) -> TerrainData:
    h = np.ascontiguousarray(height, dtype=np.float32)
    is_flat = bool(np.ptp(h) < 1e-9)
    f32 = lambda x: float(np.float32(x))
    return TerrainData(height=h, hscale=f32(hscale), origin=(f32(origin[0]), f32(origin[1])),
                       friction=f32(friction), is_flat=is_flat, height00=float(h[0, 0]),
                       corner_tex=None if is_flat else _corner_pack(h))


def flat_terrain(friction: float = 1.0, height: float = 0.0) -> TerrainData:
    """A plane at ``height`` (a 2 x 2 constant grid)."""
    return from_numpy(np.full((2, 2), height, np.float32), 1.0, friction=friction)


def _grid_coords(terrain: TerrainData, xy: torch.Tensor):
    H, W = terrain.shape
    gx = (xy[..., 0] - terrain.origin[0]) / terrain.hscale
    gy = (xy[..., 1] - terrain.origin[1]) / terrain.hscale
    return gx.clamp(0.0, H - 1.001), gy.clamp(0.0, W - 1.001)


def _corners(terrain: TerrainData, gx: torch.Tensor, gy: torch.Tensor):
    """The four bilinear corners (one texture row per point) and the cell
    fractions.  The flat index is clamped into the grid so that a non-finite
    point reads a real cell (its result stays non-finite through ``fx``)."""
    H, W = terrain.shape
    x0, y0 = torch.floor(gx), torch.floor(gy)
    base = (x0.to(torch.int64) * W + y0.to(torch.int64)).clamp(0, H * W - 1)
    rows = terrain.torch(gx.device)["corner_tex"][base]          # [..., 4]
    return rows[..., 0], rows[..., 2], rows[..., 1], rows[..., 3], gx - x0, gy - y0


def sample_height(terrain: TerrainData, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear ground height at world xy positions [..., 2] -> [...]."""
    if terrain.is_flat:
        return torch.full(xy.shape[:-1], terrain.height00, dtype=xy.dtype, device=xy.device)
    h00, h10, h01, h11, fx, fy = _corners(terrain, *_grid_coords(terrain, xy))
    return h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy) + h01 * (1 - fx) * fy + h11 * fx * fy


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
    h = h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy) + h01 * (1 - fx) * fy + h11 * fx * fy
    dhdx = ((h10 - h00) * (1 - fy) + (h11 - h01) * fy) / terrain.hscale
    dhdy = ((h01 - h00) * (1 - fx) + (h11 - h10) * fx) / terrain.hscale
    n = torch.stack([-dhdx, -dhdy, torch.ones_like(h)], dim=-1)
    return h, n / torch.linalg.norm(n, dim=-1, keepdim=True)
