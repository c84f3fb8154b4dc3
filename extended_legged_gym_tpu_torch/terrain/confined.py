"""Two-layer (ground + ceiling) confined terrains (port of
``terrain/confined.py``).

Six generators (tunnel, barrier, timber piles, confined gap, column
obstacles, wall with a gap) share a central spawn area (``SPAWN_AREA_SIZE``
= 2 m) that is kept clear; :class:`TerrainConfined` lays them out in a
curriculum grid, difficulty rising with the row, the type chosen by the
column against the cumulative ``confined_terrain_proportions``.  Both layers
are float32 meters; an open-sky cell has a ceiling of 1e6.

Generation runs once on the host in numpy.  The JAX package draws from
numpy's global stream after ``np.random.seed(seed)``; the port draws from its
own ``np.random.RandomState(seed)`` (:attr:`TerrainConfined.rng`) in the same
order, so it yields the same arrays bit for bit, and the env's spawn-level
draw continues the same stream.  :meth:`TerrainConfined.to_device` attaches
a wall-corrected triangle mesh of both layers (``attach_trimesh``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..perception.trimesh import trimesh_from_heightfield
from .heightfield import OPEN_SKY, TerrainData, from_numpy

SPAWN_AREA_SIZE = 2.0          # m
DEFAULT_CEILING = 3.0          # m


@dataclass
class SubTerrainConfined:
    """Working patch with ground and ceiling layers in meters."""
    width: int
    length: int
    vertical_scale: float
    horizontal_scale: float

    def __post_init__(self):
        self.ground = np.zeros((self.width, self.length), dtype=np.float32)
        self.ceiling = np.full((self.width, self.length), DEFAULT_CEILING, dtype=np.float32)

    def m2px(self, x):
        return int(x / self.horizontal_scale)

    def spawn_box(self):
        """The central spawn area's pixel bounds: (cx, cy, x1, x2, y1, y2)."""
        cx, cy = self.width // 2, self.length // 2
        half = self.m2px(SPAWN_AREA_SIZE) // 2
        return cx, cy, cx - half, cx + half, cy - half, cy + half


def tunnel_terrain(t: SubTerrainConfined, rng, tunnel_width: float = 1.0,
                   tunnel_height: float = 2.0):
    """Four tunnels from the spawn area along ±x and ±y: the spawn's ceiling
    at ``tunnel_height``, the tunnel floors 0.1 m down under 1.2 m ceilings,
    the rest open under the default ceiling."""
    cx, cy, x1, x2, y1, y2 = t.spawn_box()
    half_w = t.m2px(tunnel_width) // 2

    t.ground[x1:x2, y1:y2] = 0.0
    t.ceiling[x1:x2, y1:y2] = tunnel_height

    lo_y, hi_y = max(cy - half_w, 0), min(cy + half_w, t.length)
    lo_x, hi_x = max(cx - half_w, 0), min(cx + half_w, t.width)
    t.ground[x2:, lo_y:hi_y] = -0.1
    t.ceiling[x2:, lo_y:hi_y] = 1.2
    t.ground[:x1, lo_y:hi_y] = -0.1
    t.ceiling[:x1, lo_y:hi_y] = 1.2
    t.ground[lo_x:hi_x, y2:] = -0.1
    t.ceiling[lo_x:hi_x, y2:] = 1.2
    t.ground[lo_x:hi_x, :y1] = -0.1
    t.ceiling[lo_x:hi_x, :y1] = 1.2
    return t


def _strips(t: SubTerrainConfined, inner: int, outer: int):
    """The four full-length strips ``inner..outer`` pixels out from the
    centre, each as (lo, hi, axis), clipped to the patch; empty ones
    dropped."""
    cx, cy = t.width // 2, t.length // 2
    out = []
    for lo, hi, axis in [(cy + inner, cy + outer, 1), (cy - outer, cy - inner, 1),
                         (cx + inner, cx + outer, 0), (cx - outer, cx - inner, 0)]:
        n = t.length if axis == 1 else t.width
        lo, hi = max(lo, 0), min(hi, n)
        if lo < hi:
            out.append((lo, hi, axis))
    return out


def barrier_terrain(t: SubTerrainConfined, rng, barrier_width: float = 0.35,
                    barrier_height: float = 0.2, gap_height: float = 0.8):
    """Step-over / duck-under barrier strips 0.5 m outside the spawn box:
    the ground raised to ``barrier_height`` under a ceiling ``gap_height``
    above it."""
    _, _, x1, x2, y1, y2 = t.spawn_box()
    half = t.m2px(SPAWN_AREA_SIZE) // 2
    off = t.m2px(0.5)
    bw = t.m2px(barrier_width)

    t.ground[x1:x2, y1:y2] = 0.0
    t.ceiling[x1:x2, y1:y2] = DEFAULT_CEILING
    for lo, hi, axis in _strips(t, half + off, half + off + bw):
        sl = (slice(None), slice(lo, hi)) if axis == 1 else (slice(lo, hi), slice(None))
        t.ground[sl] = barrier_height
        t.ceiling[sl] = barrier_height + gap_height
    return t


def timber_piles_terrain(t: SubTerrainConfined, rng, timber_spacing: float = 1.0,
                         timber_size: float = 0.3, pile_height: float = 1.2,
                         hanging_obstacles: bool = False, position_noise: float = 0.2,
                         height_noise: float = 0.1):
    """A grid of square timber piles with a raised spawn platform."""
    _, _, x1, x2, y1, y2 = t.spawn_box()
    sp = max(1, t.m2px(timber_spacing))
    sz = max(1, t.m2px(timber_size))
    npx = t.m2px(position_noise)

    half = sz // 2
    for px in np.arange(sz, t.width - sz, sp):
        for py in np.arange(sz, t.length - sz, sp):
            if npx > 0:
                px_n = np.clip(px + rng.randint(-npx, npx + 1), sz, t.width - sz - 1)
                py_n = np.clip(py + rng.randint(-npx, npx + 1), sz, t.length - sz - 1)
            else:
                px_n, py_n = px, py
            h = pile_height + rng.uniform(-height_noise, height_noise)
            t.ground[max(0, px_n - half):px_n + half, max(0, py_n - half):py_n + half] = h
            if hanging_obstacles:
                t.ceiling[max(0, px_n - half):px_n + half,
                          max(0, py_n - half):py_n + half] = h + 0.3

    # raised spawn platform at pile height under an open ceiling
    t.ground[x1:x2, y1:y2] = pile_height
    t.ceiling[x1:x2, y1:y2] = DEFAULT_CEILING
    return t


def confined_gap_terrain(t: SubTerrainConfined, rng, gap_width: float = 0.8):
    """1 m-deep gap strips 0.3 m outside the spawn box (whose ceiling is at
    2 m); everything else at ground level, the spawn included, becomes a
    0.3 m platform under a 1.8 m ceiling."""
    _, _, x1, x2, y1, y2 = t.spawn_box()
    half = t.m2px(SPAWN_AREA_SIZE) // 2
    off = t.m2px(0.3)
    gw = t.m2px(gap_width)

    t.ground[x1:x2, y1:y2] = 0.0
    t.ceiling[x1:x2, y1:y2] = 2.0
    for lo, hi, axis in _strips(t, half + off, half + off + gw):
        if axis == 1:
            t.ground[:, lo:hi] = -1.0
        else:
            t.ground[lo:hi, :] = -1.0
    mask = t.ground == 0.0
    t.ground[mask] = 0.3
    t.ceiling[mask] = 1.8
    return t


def column_obstacles_terrain(t: SubTerrainConfined, rng, column_spacing: float = 0.4,
                             column_radius: float = 0.1, column_height: float = 0.8,
                             hanging_length: float = 0.8, density: float = 0.7):
    """A grid of ground columns and / or hanging obstacles under a 1.2 m
    ceiling, a clear spawn cross through the middle."""
    ceiling_h = 1.2
    pert = 10 * t.vertical_scale
    sp = max(1, t.m2px(column_spacing))
    sz = max(1, t.m2px(column_radius * 2.0))
    excl = t.m2px(0.3 / 2.0)

    cx, cy = t.width // 2, t.length // 2
    t.ground[:, :] = 0.0
    t.ceiling[:, :] = ceiling_h

    half = sz // 2
    for col_x in np.arange(sz, t.width - sz, sp):
        for col_y in np.arange(sz, t.length - sz, sp):
            if abs(col_x - cx) < excl or abs(col_y - cy) < excl:
                continue
            if rng.random_sample() > density:
                continue
            lo_x, hi_x = max(0, col_x - half), min(t.width, col_x + half + 1)
            lo_y, hi_y = max(0, col_y - half), min(t.length, col_y + half + 1)
            kind = rng.choice(["ground", "ceiling", "both"], p=[0.3, 0.3, 0.4])
            if kind in ("ground", "both"):
                t.ground[lo_x:hi_x, lo_y:hi_y] = column_height + rng.uniform(-pert, pert)
            if kind in ("ceiling", "both"):
                t.ceiling[lo_x:hi_x, lo_y:hi_y] = (ceiling_h - hanging_length
                                                   + rng.uniform(-pert, pert))
    return t


def wall_with_gap_terrain(t: SubTerrainConfined, rng, gap_width: float = 0.4,
                          gap_height: float = 0.5, gap_center_height: float = 0.6,
                          wall_thickness: float = 0.2):
    """A transverse solid wall under a 1.2 m ceiling with a window of
    ``gap_width`` x ``gap_height`` about ``gap_center_height``."""
    ceiling_h = 1.2
    cx, cy = t.width // 2, t.length // 2
    t.ground[:, :] = 0.0
    t.ceiling[:, :] = ceiling_h

    wt = max(1, t.m2px(wall_thickness) // 2)
    gw = t.m2px(gap_width) // 2
    wall_x1, wall_x2 = max(0, cx - wt), min(t.width, cx + wt)
    gap_y1, gap_y2 = max(0, cy - gw), min(t.length, cy + gw)

    t.ground[wall_x1:wall_x2, :] = ceiling_h
    t.ground[wall_x1:wall_x2, gap_y1:gap_y2] = gap_center_height - gap_height / 2
    t.ceiling[wall_x1:wall_x2, gap_y1:gap_y2] = gap_center_height + gap_height / 2

    sp_half = t.m2px(0.3) // 2
    t.ground[cx - sp_half:cx + sp_half, cy - sp_half:cy + sp_half] = 0.0
    return t


class TerrainConfined:
    """Curriculum grid of confined subterrains; the types by the cumulative
    ``confined_terrain_proportions`` over [tunnel, barrier, timber_piles,
    confined_gap, column_obstacles, wall_with_gap] (four entries leave the
    last two out)."""

    def __init__(self, cfg, num_envs: int, seed: int = 0):
        self.rng = np.random.RandomState(seed)
        self.cfg = cfg
        self.env_length = cfg.terrain_length
        self.env_width = cfg.terrain_width
        self.num_rows = cfg.num_rows
        self.num_cols = cfg.num_cols
        self.proportions = cfg.confined_terrain_proportions

        self.wpx = int(self.env_length / cfg.horizontal_scale)
        self.lpx = int(self.env_width / cfg.horizontal_scale)
        self.border = int(cfg.border_size / cfg.horizontal_scale)
        rows_px = self.num_rows * self.wpx + 2 * self.border
        cols_px = self.num_cols * self.lpx + 2 * self.border
        self.ground = np.zeros((rows_px, cols_px), dtype=np.float32)
        self.ceiling = np.full((rows_px, cols_px), OPEN_SKY, dtype=np.float32)
        self.env_origins = np.zeros((self.num_rows, self.num_cols, 3))

        for i in range(self.num_rows):
            for j in range(self.num_cols):
                difficulty = (i + 1) / max(1, self.num_rows)
                choice = j / self.num_cols + 0.001
                t = SubTerrainConfined(self.wpx, self.lpx, cfg.vertical_scale,
                                       cfg.horizontal_scale)
                self._make(t, choice, difficulty)
                self._add(t, i, j)

    def _make(self, t: SubTerrainConfined, choice: float, difficulty: float):
        p, rng = self.proportions, self.rng
        if choice < p[0]:
            tunnel_terrain(t, rng, tunnel_width=1.5 * (1.2 - difficulty),
                           tunnel_height=0.8 * (1.1 - difficulty * 0.3))
        elif choice < p[1]:
            barrier_terrain(t, rng, barrier_height=0.2 + 0.1 * difficulty,
                            gap_height=0.5 * (1.0 - difficulty))
        elif choice < p[2]:
            timber_piles_terrain(t, rng, timber_spacing=0.5, timber_size=0.4, pile_height=0.6,
                                 position_noise=0.0, height_noise=0.0)
        elif choice < p[3]:
            confined_gap_terrain(t, rng, gap_width=0.6)
        elif len(p) > 4 and choice < p[4]:
            column_obstacles_terrain(t, rng, column_spacing=0.3, column_radius=0.1,
                                     column_height=0.6, hanging_length=0.4, density=0.8)
        else:
            wall_with_gap_terrain(t, rng, gap_width=2.0, gap_height=0.2,
                                  gap_center_height=0.7, wall_thickness=0.1)
        return t

    def _add(self, t: SubTerrainConfined, row: int, col: int):
        i0 = self.border + row * self.wpx
        j0 = self.border + col * self.lpx
        self.ground[i0:i0 + self.wpx, j0:j0 + self.lpx] = t.ground
        self.ceiling[i0:i0 + self.wpx, j0:j0 + self.lpx] = t.ceiling
        cx = i0 + self.wpx // 2
        cy = j0 + self.lpx // 2
        r = max(1, int(0.5 / self.cfg.horizontal_scale))
        z = self.ground[cx - r:cx + r, cy - r:cy + r].max()
        self.env_origins[row, col] = [(row + 0.5) * self.env_length,
                                      (col + 0.5) * self.env_width, z]

    def to_device(self, friction: float = 1.0, attach_trimesh: bool = True) -> TerrainData:
        """Both layers as :class:`TerrainData`, with a wall-corrected triangle
        mesh of them (slope threshold 1.5) when ``attach_trimesh``: ray casts
        and SDF queries then measure lateral distances to barriers, piles
        and tunnel walls."""
        origin = (-self.cfg.border_size, -self.cfg.border_size)
        trimesh = None
        if attach_trimesh:
            trimesh = trimesh_from_heightfield(self.ground, self.cfg.horizontal_scale,
                                               origin=origin, ceiling=self.ceiling,
                                               slope_threshold=1.5)
        return from_numpy(self.ground, self.cfg.horizontal_scale, origin=origin,
                          friction=friction, ceiling=self.ceiling, trimesh=trimesh)
