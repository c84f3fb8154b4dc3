"""Static box obstacles stamped into a heightfield (port of
``terrain/obstacles.py``, host numpy): around each env origin a random
number of boxes, some in clusters, each raising the ground under it by a
random height.  Drawn from ``np.random.RandomState(seed)``, so the same seed
gives the same heights as the JAX package."""
from __future__ import annotations

import numpy as np

from ..utils.config import configclass


@configclass
class ObstacleGenConfig:
    enable_obstacles: bool = False
    min_obstacles: int = 5
    max_obstacles: int = 15
    spawn_height_range: list = [0.1, 0.3]
    spawn_radius_range: list = [1.5, 6.0]
    size_range: list = [0.2, 0.6]
    cluster_probability: float = 0.3
    cluster_size: int = 3


def stamp_obstacles(height: np.ndarray, hscale: float, origin, env_origins: np.ndarray,
                    cfg: ObstacleGenConfig, seed: int = 0) -> np.ndarray:
    """Stamp box obstacles into a heightfield around each env origin."""
    rng = np.random.RandomState(seed)
    H, W = height.shape
    out = height.copy()
    for eo in env_origins:
        n = rng.randint(cfg.min_obstacles, cfg.max_obstacles + 1)
        spots = []
        while len(spots) < n:
            r = rng.uniform(*cfg.spawn_radius_range)
            th = rng.uniform(0, 2 * np.pi)
            base = np.array([eo[0] + r * np.cos(th), eo[1] + r * np.sin(th)])
            spots.append(base)
            if rng.rand() < cfg.cluster_probability:
                for _ in range(cfg.cluster_size - 1):
                    if len(spots) >= n:
                        break
                    spots.append(base + rng.uniform(-0.5, 0.5, 2))
        for sp in spots:
            size = rng.uniform(*cfg.size_range)
            h = rng.uniform(*cfg.spawn_height_range)
            i0 = int((sp[0] - size / 2 - origin[0]) / hscale)
            i1 = int((sp[0] + size / 2 - origin[0]) / hscale) + 1
            j0 = int((sp[1] - size / 2 - origin[1]) / hscale)
            j1 = int((sp[1] + size / 2 - origin[1]) / hscale) + 1
            i0, i1 = max(0, i0), min(H, i1)
            j0, j1 = max(0, j0), min(W, j1)
            if i1 > i0 and j1 > j0:
                out[i0:i1, j0:j1] = np.maximum(out[i0:i1, j0:j1], out[i0:i1, j0:j1] + h)
    return out
