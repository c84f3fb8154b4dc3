"""Procedural terrain generation (port of ``terrain/generator.py``): a grid
of ``num_rows`` (difficulty levels) x ``num_cols`` (types) subterrains of
{smooth slope, rough slope, stairs down, stairs up, discrete obstacles,
stepping stones, gap, pit}, chosen by ``terrain_proportions`` and scaled in
difficulty per row, in curriculum, randomized or selected mode.

Generation runs once on the host in numpy.  The JAX package draws from
numpy's global stream after ``np.random.seed(seed)``; the port draws from its
own ``np.random.RandomState(seed)`` (:attr:`Terrain.rng`) in the same order,
so it yields the same heights bit for bit, and the env's spawn-level draw
continues the same stream.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .heightfield import TerrainData, from_numpy


@dataclass
class SubTerrain:
    """Working patch of heightfield samples (vertical_scale units)."""
    width: int
    length: int
    vertical_scale: float
    horizontal_scale: float
    height_field_raw: np.ndarray = field(init=False)

    def __post_init__(self):
        self.height_field_raw = np.zeros((self.width, self.length), dtype=np.int32)


# ---------------------------------------------------------------------------
# Subterrain generators; each takes the patch and the generator's stream
# ---------------------------------------------------------------------------

def random_uniform_terrain(t: SubTerrain, rng, min_height, max_height, step=0.005,
                           downsampled_scale=0.2):
    hmin = int(min_height / t.vertical_scale)
    hmax = int(max_height / t.vertical_scale)
    hstep = max(1, int(step / t.vertical_scale))
    ds = max(1, int(downsampled_scale / t.horizontal_scale))
    nw = t.width // ds + 1
    nl = t.length // ds + 1
    rough = rng.choice(np.arange(hmin, hmax + hstep, hstep), (nw, nl))
    # bilinear upsample to full resolution
    xi = np.linspace(0, nw - 1, t.width)
    yi = np.linspace(0, nl - 1, t.length)
    x0 = np.clip(xi.astype(int), 0, nw - 2)
    y0 = np.clip(yi.astype(int), 0, nl - 2)
    fx = (xi - x0)[:, None]
    fy = (yi - y0)[None, :]
    up = (rough[x0][:, y0] * (1 - fx) * (1 - fy) + rough[x0 + 1][:, y0] * fx * (1 - fy)
          + rough[x0][:, y0 + 1] * (1 - fx) * fy + rough[x0 + 1][:, y0 + 1] * fx * fy)
    t.height_field_raw += up.astype(np.int32)
    return t


def pyramid_sloped_terrain(t: SubTerrain, rng, slope):
    x = np.arange(t.width)
    y = np.arange(t.length)
    cx, cy = t.width // 2, t.length // 2
    xx = (cx - np.abs(cx - x))[:, None] / cx
    yy = (cy - np.abs(cy - y))[None, :] / cy
    max_h = slope * (t.horizontal_scale / t.vertical_scale) * (t.width / 2)
    t.height_field_raw += (max_h * xx * yy).astype(np.int32)
    return t


def pyramid_stairs_terrain(t: SubTerrain, rng, step_width, step_height, platform_size=1.0):
    sw = int(step_width / t.horizontal_scale)
    sh = int(step_height / t.vertical_scale)
    plat = int(platform_size / t.horizontal_scale)
    h = 0
    x0, x1 = 0, t.width
    y0, y1 = 0, t.length
    while (x1 - x0) > plat and (y1 - y0) > plat:
        x0 += sw; x1 -= sw; y0 += sw; y1 -= sw
        h += sh
        t.height_field_raw[x0:x1, y0:y1] = h
    return t


def discrete_obstacles_terrain(t: SubTerrain, rng, max_height, min_size, max_size, num_rects,
                               platform_size=1.0):
    mh = int(max_height / t.vertical_scale)
    heights = [-mh, -mh // 2, mh // 2, mh]
    for _ in range(num_rects):
        w = rng.randint(int(min_size / t.horizontal_scale), int(max_size / t.horizontal_scale))
        l = rng.randint(int(min_size / t.horizontal_scale), int(max_size / t.horizontal_scale))
        x = rng.randint(0, max(1, t.width - w))
        y = rng.randint(0, max(1, t.length - l))
        t.height_field_raw[x:x + w, y:y + l] = rng.choice(heights)
    # flat platform in the center
    p = int(platform_size / t.horizontal_scale / 2)
    cx, cy = t.width // 2, t.length // 2
    t.height_field_raw[cx - p:cx + p, cy - p:cy + p] = 0
    return t


def stepping_stones_terrain(t: SubTerrain, rng, stone_size, stone_distance, max_height,
                            platform_size=1.0, depth=-10.0):
    ss = max(1, int(stone_size / t.horizontal_scale))
    sd = int(stone_distance / t.horizontal_scale)
    mh = int(max_height / t.vertical_scale)
    t.height_field_raw[:] = int(depth / t.vertical_scale)
    y = 0
    while y < t.length:
        x = rng.randint(0, ss) - ss
        while x < t.width:
            x2 = min(t.width, x + ss)
            y2 = min(t.length, y + ss)
            t.height_field_raw[max(0, x):x2, y:y2] = rng.randint(-mh, mh + 1)
            x += ss + sd
        y += ss + sd
    p = int(platform_size / t.horizontal_scale / 2)
    cx, cy = t.width // 2, t.length // 2
    t.height_field_raw[cx - p:cx + p, cy - p:cy + p] = 0
    return t


def gap_terrain(t: SubTerrain, rng, gap_size, platform_size=1.0):
    gs = int(gap_size / t.horizontal_scale)
    p = int(platform_size / t.horizontal_scale)
    cx, cy = t.width // 2, t.length // 2
    t.height_field_raw[cx - p - gs:cx + p + gs, cy - p - gs:cy + p + gs] = int(-10.0 / t.vertical_scale)
    t.height_field_raw[cx - p:cx + p, cy - p:cy + p] = 0
    return t


def pit_terrain(t: SubTerrain, rng, depth, platform_size=1.0):
    d = int(depth / t.vertical_scale)
    p = int(platform_size / t.horizontal_scale / 2)
    cx, cy = t.width // 2, t.length // 2
    t.height_field_raw[cx - p:cx + p, cy - p:cy + p] = -d
    return t


SUBTERRAINS = {f.__name__: f for f in (
    random_uniform_terrain, pyramid_sloped_terrain, pyramid_stairs_terrain,
    discrete_obstacles_terrain, stepping_stones_terrain, gap_terrain, pit_terrain)}


# ---------------------------------------------------------------------------
# Curriculum terrain grid
# ---------------------------------------------------------------------------

class Terrain:
    """Grid of subterrains with difficulty rows x type columns: one
    heightfield plus per-(row, col) env origins ``[rows, cols, 3]``."""

    def __init__(self, cfg, num_envs: int, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)
        self.env_length = cfg.terrain_length
        self.env_width = cfg.terrain_width
        self.num_rows = cfg.num_rows
        self.num_cols = cfg.num_cols
        props = cfg.terrain_proportions
        self.proportions = [np.sum(props[: i + 1]) for i in range(len(props))]

        self.width_per_env_pixels = int(self.env_length / cfg.horizontal_scale)
        self.length_per_env_pixels = int(self.env_width / cfg.horizontal_scale)
        self.border = int(cfg.border_size / cfg.horizontal_scale)
        self.tot_rows = self.num_rows * self.width_per_env_pixels + 2 * self.border
        self.tot_cols = self.num_cols * self.length_per_env_pixels + 2 * self.border

        self.height_field_raw = np.zeros((self.tot_rows, self.tot_cols), dtype=np.int32)
        self.env_origins = np.zeros((self.num_rows, self.num_cols, 3))

        if cfg.curriculum:
            self._curriculum()
        elif cfg.selected:
            self._selected()
        else:
            self._randomized()

        self.heights = self.height_field_raw.astype(np.float32) * cfg.vertical_scale

    def _make(self, choice: float, difficulty: float) -> SubTerrain:
        t = SubTerrain(self.width_per_env_pixels, self.length_per_env_pixels,
                       self.cfg.vertical_scale, self.cfg.horizontal_scale)
        rng = self.rng
        slope = difficulty * 0.4
        step_height = 0.05 + 0.18 * difficulty
        discrete_obstacles_height = 0.05 + difficulty * 0.2
        stepping_stones_size = 1.5 * (1.05 - difficulty)
        stone_distance = 0.05 if difficulty == 0 else 0.1
        gap_size = 1.0 * difficulty
        pit_depth = 1.0 * difficulty
        p = self.proportions
        if choice < p[0]:
            if choice < p[0] / 2:
                slope *= -1
            pyramid_sloped_terrain(t, rng, slope)
        elif choice < p[1]:
            pyramid_sloped_terrain(t, rng, slope)
            random_uniform_terrain(t, rng, -0.05, 0.05, 0.005, 0.2)
        elif choice < p[3]:
            # stairs: below p[2] descending, else ascending
            if choice < p[2]:
                step_height *= -1
            pyramid_stairs_terrain(t, rng, 0.31, step_height, 3.0)
        elif len(p) > 4 and choice < p[4]:
            discrete_obstacles_terrain(t, rng, discrete_obstacles_height, 1.0, 2.0, 40, 3.0)
        elif len(p) > 5 and choice < p[5]:
            stepping_stones_terrain(t, rng, stepping_stones_size, stone_distance, 0.0, 4.0)
        elif len(p) > 6 and choice < p[6]:
            gap_terrain(t, rng, gap_size, 3.0)
        else:
            pit_terrain(t, rng, pit_depth, 4.0)
        return t

    def _add(self, t: SubTerrain, row: int, col: int):
        i0 = self.border + row * self.width_per_env_pixels
        j0 = self.border + col * self.length_per_env_pixels
        self.height_field_raw[i0:i0 + self.width_per_env_pixels,
                              j0:j0 + self.length_per_env_pixels] = t.height_field_raw
        # origin at the subterrain center, z = max height of the central 1 m patch
        cx = i0 + self.width_per_env_pixels // 2
        cy = j0 + self.length_per_env_pixels // 2
        r = max(1, int(0.5 / self.cfg.horizontal_scale))
        z = self.height_field_raw[cx - r:cx + r, cy - r:cy + r].max() * self.cfg.vertical_scale
        # world coords; the grid corner sits at (-border, -border)
        self.env_origins[row, col] = [(row + 0.5) * self.env_length,
                                      (col + 0.5) * self.env_width, z]

    def _curriculum(self):
        for j in range(self.num_cols):
            for i in range(self.num_rows):
                difficulty = i / max(1, self.num_rows)
                choice = j / self.num_cols + 0.001
                self._add(self._make(choice, difficulty), i, j)

    def _randomized(self):
        for k in range(self.num_rows * self.num_cols):
            i, j = np.unravel_index(k, (self.num_rows, self.num_cols))
            choice = self.rng.uniform(0, 1)
            difficulty = self.rng.choice([0.5, 0.75, 0.9])
            self._add(self._make(choice, difficulty), i, j)

    def _selected(self):
        kwargs = dict(self.cfg.terrain_kwargs or {})
        fn = SUBTERRAINS[kwargs.pop("type", "random_uniform_terrain")]
        for k in range(self.num_rows * self.num_cols):
            i, j = np.unravel_index(k, (self.num_rows, self.num_cols))
            t = SubTerrain(self.width_per_env_pixels, self.length_per_env_pixels,
                           self.cfg.vertical_scale, self.cfg.horizontal_scale)
            fn(t, self.rng, **kwargs)
            self._add(t, i, j)

    def to_device(self, friction: float = 1.0) -> TerrainData:
        """The heightfield as :class:`TerrainData` (host arrays; tensors per
        device on demand)."""
        return from_numpy(self.heights, self.cfg.horizontal_scale,
                          origin=(-self.cfg.border_size, -self.cfg.border_size),
                          friction=friction)
