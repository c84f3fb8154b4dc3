"""Joint rotation and semi-implicit Euler integration (the part of
``physics/dynamics.py`` that the ABA step uses), batched over ``[B]``."""
from __future__ import annotations

import torch

from ..utils.math import quat_from_axis_angle, quat_mul, skew


def _joint_rot(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [B, 3, 3] about ``axis`` [3] by ``angle`` [B] (Rodrigues)."""
    c = torch.cos(angle)[:, None, None]
    s = torch.sin(angle)[:, None, None]
    K = skew(axis)
    return torch.eye(3, dtype=angle.dtype, device=angle.device) + s * K + (1.0 - c) * (K @ K)


def integrate(base_pos, base_quat, joint_pos, base_lin_vel, base_ang_vel, joint_vel,
              udot, dt: float, joint_vel_limit: torch.Tensor):
    """Semi-implicit Euler: velocities first, then positions with the new
    velocities.  Base velocities are clamped to ±100, joint velocities to
    ``min(joint_vel_limit, 500)`` (URDFs without a limit extract as 1e9).  The
    quaternion advances by the exp map of the world angular velocity."""
    v = torch.clamp(base_lin_vel + dt * udot[:, 0:3], -100.0, 100.0)
    w = torch.clamp(base_ang_vel + dt * udot[:, 3:6], -100.0, 100.0)
    vlim = joint_vel_limit.clamp(max=500.0)
    thd = torch.minimum(torch.maximum(joint_vel + dt * udot[:, 6:], -vlim), vlim)
    pos = base_pos + dt * v
    wn = torch.linalg.norm(w, dim=-1)
    axis = w / wn.clamp(min=1e-9)[:, None]
    quat = quat_mul(quat_from_axis_angle(axis, wn * dt), base_quat)
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True).clamp(min=1e-9)
    th = joint_pos + dt * thd
    return pos, quat, th, v, w, thd
