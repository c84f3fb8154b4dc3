"""Terrain, flat subset (port of ``terrain/heightfield.py``): a plane at a
constant height.  Rough heightfields come with the rough-terrain kernel (B2).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class TerrainData:
    height: float = 0.0         # plane height [m]
    friction: float = 1.0       # terrain friction coefficient


def flat_terrain(friction: float = 1.0, height: float = 0.0) -> TerrainData:
    return TerrainData(height=float(height), friction=float(friction))


def sample_height(terrain: TerrainData, xy: torch.Tensor) -> torch.Tensor:
    """Ground height at world xy positions [..., 2] -> [...]."""
    return torch.full(xy.shape[:-1], terrain.height, dtype=xy.dtype, device=xy.device)
