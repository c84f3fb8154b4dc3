"""Plain reference of the curriculum terrain: a grid of ``num_rows``
(difficulty) x ``num_cols`` (type) subterrains with a border, drawn from
``numpy.random.RandomState(seed)``, as legged_gym's ``Terrain`` in curriculum
mode builds it (smooth and rough slopes, stairs down and up, discrete
obstacles by the cumulative ``terrain_proportions``).  Only the subterrain
kinds that curriculum mode can choose are here."""
from __future__ import annotations

import numpy as np

from .physics import Ground


def _random_uniform(hf, vs, hs, rng, min_height, max_height, step=0.005, downsampled_scale=0.2):
    width, length = hf.shape
    hmin, hmax = int(min_height / vs), int(max_height / vs)
    hstep = max(1, int(step / vs))
    ds = max(1, int(downsampled_scale / hs))
    nw, nl = width // ds + 1, length // ds + 1
    rough = rng.choice(np.arange(hmin, hmax + hstep, hstep), (nw, nl))
    xi, yi = np.linspace(0, nw - 1, width), np.linspace(0, nl - 1, length)
    x0 = np.clip(xi.astype(int), 0, nw - 2)
    y0 = np.clip(yi.astype(int), 0, nl - 2)
    fx, fy = (xi - x0)[:, None], (yi - y0)[None, :]
    up = (rough[x0][:, y0] * (1 - fx) * (1 - fy) + rough[x0 + 1][:, y0] * fx * (1 - fy)
          + rough[x0][:, y0 + 1] * (1 - fx) * fy + rough[x0 + 1][:, y0 + 1] * fx * fy)
    hf += up.astype(np.int32)


def _pyramid_slope(hf, vs, hs, slope):
    width, length = hf.shape
    x, y = np.arange(width), np.arange(length)
    cx, cy = width // 2, length // 2
    xx = (cx - np.abs(cx - x))[:, None] / cx
    yy = (cy - np.abs(cy - y))[None, :] / cy
    max_h = slope * (hs / vs) * (width / 2)
    hf += (max_h * xx * yy).astype(np.int32)


def _pyramid_stairs(hf, vs, hs, step_width, step_height, platform_size):
    sw, sh, plat = int(step_width / hs), int(step_height / vs), int(platform_size / hs)
    h, x0, x1, y0, y1 = 0, 0, hf.shape[0], 0, hf.shape[1]
    while (x1 - x0) > plat and (y1 - y0) > plat:
        x0 += sw; x1 -= sw; y0 += sw; y1 -= sw
        h += sh
        hf[x0:x1, y0:y1] = h


def _discrete_obstacles(hf, vs, hs, rng, max_height, min_size, max_size, num_rects,
                        platform_size):
    width, length = hf.shape
    mh = int(max_height / vs)
    heights = [-mh, -mh // 2, mh // 2, mh]
    for _ in range(num_rects):
        w = rng.randint(int(min_size / hs), int(max_size / hs))
        l = rng.randint(int(min_size / hs), int(max_size / hs))
        x = rng.randint(0, max(1, width - w))
        y = rng.randint(0, max(1, length - l))
        hf[x:x + w, y:y + l] = rng.choice(heights)
    p = int(platform_size / hs / 2)
    cx, cy = width // 2, length // 2
    hf[cx - p:cx + p, cy - p:cy + p] = 0


def curriculum_ground(terrain: dict, seed: int) -> Ground:
    """The heightfield of a curriculum terrain config (the ``terrain`` group
    of a configuration file) for ``seed``, with its grid corner at
    ``(-border, -border)``."""
    if not terrain["curriculum"] or terrain["mesh_type"] not in ("heightfield", "trimesh"):
        raise ValueError("the reference builds curriculum heightfields only")
    hs, vs = terrain["horizontal_scale"], terrain["vertical_scale"]
    rows, cols = terrain["num_rows"], terrain["num_cols"]
    props = terrain["terrain_proportions"]
    p = [float(np.sum(props[: i + 1])) for i in range(len(props))]
    if len(p) > 5:
        raise ValueError("the reference's curriculum has the first five subterrain kinds")
    rng = np.random.RandomState(seed)
    wpx = int(terrain["terrain_length"] / hs)
    lpx = int(terrain["terrain_width"] / hs)
    border = int(terrain["border_size"] / hs)
    raw = np.zeros((rows * wpx + 2 * border, cols * lpx + 2 * border), dtype=np.int32)
    for j in range(cols):
        for i in range(rows):
            difficulty = i / max(1, rows)
            choice = j / cols + 0.001
            hf = np.zeros((wpx, lpx), dtype=np.int32)
            slope = difficulty * 0.4
            step_height = 0.05 + 0.18 * difficulty
            if choice < p[0]:
                _pyramid_slope(hf, vs, hs, -slope if choice < p[0] / 2 else slope)
            elif choice < p[1]:
                _pyramid_slope(hf, vs, hs, slope)
                _random_uniform(hf, vs, hs, rng, -0.05, 0.05, 0.005, 0.2)
            elif choice < p[3]:
                _pyramid_stairs(hf, vs, hs, 0.31, -step_height if choice < p[2] else step_height,
                                3.0)
            else:
                _discrete_obstacles(hf, vs, hs, rng, 0.05 + difficulty * 0.2, 1.0, 2.0, 40, 3.0)
            i0, j0 = border + i * wpx, border + j * lpx
            raw[i0:i0 + wpx, j0:j0 + lpx] = hf
    heights = raw.astype(np.float32) * vs
    b = terrain["border_size"]
    return Ground(heights, hs, (-b, -b), terrain["static_friction"])
