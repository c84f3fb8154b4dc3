"""Depth cameras (port of ``perception/depth_camera.py``).

``DepthCameraRaycast`` renders a pinhole grid of rays against the terrain
(``perception/raycast.py``: the heightfield, its ceiling, or the triangle
mesh where the terrain carries one) from a camera mounted on the base;
every camera shares one processing pipeline (``DepthCameraBase.process``):
clip, optional distance noise, resize, normalize (and invert) and scale, and
a ring buffer of the last ``buffer_len`` frames.

The resize matches ``jax.image.resize(..., method="linear")``: a triangle
kernel, widened by the shrink factor when the image shrinks (antialiasing),
with weights normalized over the input, which is what ``F.interpolate``'s
bilinear mode with ``antialias=True`` and ``align_corners=False`` computes.
The noise is drawn from the camera's own generator (``_draw_noise``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..terrain.heightfield import TerrainData
from ..utils.device import resolve_device
from ..utils.math import quat_mul, quat_rotate, ypr_to_quat
from .raycast import raycast


def pinhole_ray_grid(width: int, height: int, horizontal_fov_deg: float) -> np.ndarray:
    """Camera-frame unit ray directions [H, W, 3] of a W x H pinhole camera:
    +x forward, +y left, +z up."""
    hfov = np.deg2rad(horizontal_fov_deg)
    fx = (width / 2) / np.tan(hfov / 2)
    us = np.arange(width) - (width - 1) / 2
    vs = np.arange(height) - (height - 1) / 2
    uu, vv = np.meshgrid(us, vs, indexing="xy")
    dirs = np.stack([np.ones_like(uu) * fx, -uu, -vv], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dirs.astype(np.float32)


class DepthCameraBase:
    """The processing pipeline and the frame buffer."""

    def __init__(self, cfg, num_envs: int, device="cuda", seed: int = 0):
        self.cfg, self.num_envs, self.device = cfg, num_envs, resolve_device(device)
        self.W0, self.H0 = cfg.original
        self.W1, self.H1 = cfg.resized
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def init_buffer(self) -> torch.Tensor:
        return torch.zeros(self.num_envs, self.cfg.buffer_len, self.H1, self.W1,
                           device=self.device)

    def _draw_noise(self, shape) -> torch.Tensor:
        """Standard normal noise of ``shape`` (scaled by ``dis_noise``)."""
        return torch.randn(shape, generator=self.generator, device=self.device)

    def process(self, depth: torch.Tensor, noise: bool = False) -> torch.Tensor:
        """Raw depth [..., H0, W0] -> processed frames [..., H1, W1]."""
        cfg = self.cfg
        d = torch.clamp(depth, cfg.near_clip, cfg.far_clip)
        if noise and cfg.dis_noise > 0:
            d = torch.clamp(d + cfg.dis_noise * self._draw_noise(d.shape), cfg.near_clip,
                            cfg.far_clip)
        lead = d.shape[:-2]
        d = F.interpolate(d.reshape(-1, 1, *d.shape[-2:]), size=(self.H1, self.W1),
                          mode="bilinear", align_corners=False, antialias=True)
        d = d.reshape(*lead, self.H1, self.W1)
        d = (d - cfg.near_clip) / (cfg.far_clip - cfg.near_clip)
        if cfg.invert:
            d = 1.0 - d
        return d * cfg.scale

    def push(self, buffer: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
        return torch.cat([buffer[:, 1:], frame[:, None]], dim=1)


class DepthCameraFake(DepthCameraBase):
    """All-zero frames."""

    def render(self, base_pos, base_quat, noise: bool = False) -> torch.Tensor:
        return torch.zeros(base_pos.shape[0], self.H1, self.W1, device=base_pos.device)


class DepthCameraRaycast(DepthCameraBase):
    """Terrain raycasts from the camera pose: the base pose composed with
    the mount position and pitch (the mean of ``cfg.angle``), out to
    ``far_clip``."""

    def __init__(self, cfg, num_envs: int, terrain: TerrainData, device="cuda", seed: int = 0):
        super().__init__(cfg, num_envs, device, seed)
        self.terrain = terrain
        dirs = pinhole_ray_grid(self.W0, self.H0, cfg.horizontal_fov)
        self.ray_dirs = torch.as_tensor(dirs.reshape(-1, 3), device=self.device)
        self.mount_pos = torch.tensor(cfg.position, dtype=torch.float32, device=self.device)
        pitch = torch.tensor(float(np.deg2rad(np.mean(cfg.angle))), device=self.device)
        zero = torch.zeros((), device=self.device)
        self.mount_quat = ypr_to_quat(zero, pitch, zero)

    def render(self, base_pos: torch.Tensor, base_quat: torch.Tensor,
               noise: bool = False) -> torch.Tensor:
        """[B, 3], [B, 4] -> processed depth [B, H1, W1]."""
        B = base_pos.shape[0]
        cam_pos = base_pos + quat_rotate(base_quat, self.mount_pos.expand(B, 3))
        cam_quat = quat_mul(base_quat, self.mount_quat.expand(B, 4))
        origins = cam_pos[:, None, :].expand(B, self.ray_dirs.shape[0], 3)
        dirs = quat_rotate(cam_quat[:, None, :], self.ray_dirs[None])
        res = raycast(self.terrain, origins, dirs, self.cfg.far_clip)
        return self.process(res.distance.reshape(B, self.H0, self.W0), noise)


def make_depth_camera(cfg, num_envs: int, terrain: TerrainData, device="cuda", seed: int = 0):
    if cfg.camera_type in ("Warp", "Raycast"):
        return DepthCameraRaycast(cfg, num_envs, terrain, device, seed)
    if cfg.camera_type == "Fake":
        return DepthCameraFake(cfg, num_envs, device, seed)
    return None
