"""Ray patterns (port of ``perception/patterns.py``): host numpy, built once;
unit directions in the sensor frame, rotated per env on the device."""
from __future__ import annotations

import numpy as np


def single_pattern() -> np.ndarray:
    return np.array([[1.0, 0.0, 0.0]], dtype=np.float32)


def grid_pattern(size: float = 1.0, resolution: float = 0.1):
    """Downward rays from a square grid of starts: ``(starts, dirs)``, each
    [R, 3]."""
    n = int(size / resolution) + 1
    xs = np.linspace(-size / 2, size / 2, n)
    ys = np.linspace(-size / 2, size / 2, n)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    dirs = np.stack([np.zeros_like(gx), np.zeros_like(gy), -np.ones_like(gx)], axis=-1)
    starts = np.stack([gx, gy, np.zeros_like(gx)], axis=-1)
    return starts.reshape(-1, 3).astype(np.float32), dirs.reshape(-1, 3).astype(np.float32)


def cone_pattern(num_rays: int = 32, ray_angle_deg: float = 60.0) -> np.ndarray:
    """A forward ray and a ring of ``num_rays - 1`` rays at half the cone's
    angle around +x."""
    angle = np.deg2rad(ray_angle_deg)
    dirs = [np.array([1.0, 0.0, 0.0])]
    n_ring = max(1, num_rays - 1)
    for k in range(n_ring):
        phi = 2 * np.pi * k / n_ring
        d = np.array([np.cos(angle / 2),
                      np.sin(angle / 2) * np.cos(phi),
                      np.sin(angle / 2) * np.sin(phi)])
        dirs.append(d / np.linalg.norm(d))
    return np.stack(dirs).astype(np.float32)


def spherical_pattern(num_azimuth: int = 8, num_elevation: int = 4) -> np.ndarray:
    """An azimuth x elevation fan over the sphere."""
    dirs = []
    for i in range(num_elevation):
        el = -np.pi / 2 + np.pi * (i + 0.5) / num_elevation
        for j in range(num_azimuth):
            az = 2 * np.pi * j / num_azimuth
            dirs.append([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
    return np.asarray(dirs, dtype=np.float32)


def spherical2_pattern(num_points: int = 32, polar_axis=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Fibonacci points on the sphere, +z turned onto ``polar_axis``."""
    i = np.arange(num_points, dtype=np.float64)
    golden = (1 + 5**0.5) / 2
    z = 1 - 2 * (i + 0.5) / num_points
    r = np.sqrt(np.clip(1 - z * z, 0, 1))
    phi = 2 * np.pi * i / golden
    dirs = np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)
    axis = np.asarray(polar_axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    zhat = np.array([0.0, 0.0, 1.0])
    v = np.cross(zhat, axis)
    c = float(zhat @ axis)
    if np.linalg.norm(v) < 1e-9:
        R = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        R = np.eye(3) + vx + vx @ vx / (1 + c)
    return (dirs @ R.T).astype(np.float32)


def make_pattern(cfg) -> np.ndarray:
    """Directions [R, 3] from a ``RaycasterCfg`` (the grid pattern, which
    carries per-ray starts, is built with :func:`grid_pattern`)."""
    p = cfg.ray_pattern
    if p == "single":
        return single_pattern()
    if p == "cone":
        return cone_pattern(cfg.num_rays, cfg.ray_angle)
    if p == "spherical":
        return spherical_pattern(cfg.spherical_num_azimuth, cfg.spherical_num_elevation)
    if p == "spherical2":
        return spherical2_pattern(cfg.spherical2_num_points, cfg.spherical2_polar_axis)
    raise ValueError(f"unknown ray pattern {p}")
