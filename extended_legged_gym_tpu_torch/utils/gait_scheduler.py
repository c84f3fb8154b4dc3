"""Phase-clock gait scheduling (port of ``utils/gait_scheduler.py``).

``GaitScheduler``: per-foot phase offsets, a duty ratio, a sinusoidal
swing-height target and an exp-kernel foot-height tracking reward.
``AsyncGaitScheduler``: alignment rewards without a strict clock (legs of a
group share joint angles; all legs are drawn to nominal positions).  The
schedulers hold static parameters; the time is carried by the env.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from .config import configclass
from .device import resolve_device


@configclass
class GaitSchedulerCfg:
    period: float = 1.0
    duty: float = 0.5
    foot_phases: list = [0.0, 0.5, 0.0, 0.5]
    dt: float = 0.02
    swing_height: float = 0.1
    track_sigma: float = 0.25


class GaitScheduler:
    """Clock-driven gait targets."""

    def __init__(self, cfg: GaitSchedulerCfg, device="cuda"):
        self.cfg = cfg
        self.phases = torch.tensor(cfg.foot_phases, dtype=torch.float32,
                                   device=resolve_device(device))

    def phase(self, t: torch.Tensor) -> torch.Tensor:
        """Per-foot gait phase in [0, 1): t [...] -> [..., nfeet]."""
        return torch.remainder(t[..., None] / self.cfg.period + self.phases, 1.0)

    def in_stance(self, t: torch.Tensor) -> torch.Tensor:
        return self.phase(t) < self.cfg.duty

    def foot_z_target(self, t: torch.Tensor) -> torch.Tensor:
        """0 in stance, a sine bump of ``swing_height`` over the swing phase."""
        ph = self.phase(t)
        swing = (ph - self.cfg.duty) / max(1.0 - self.cfg.duty, 1e-6)
        z = self.cfg.swing_height * torch.sin(torch.clamp(swing, 0.0, 1.0) * math.pi)
        return torch.where(ph >= self.cfg.duty, z, torch.zeros_like(z))

    def reward_foot_z_track(self, foot_z: torch.Tensor, t: torch.Tensor,
                            ground_z: Optional[torch.Tensor] = None) -> torch.Tensor:
        target = self.foot_z_target(t)
        if ground_z is not None:
            target = target + ground_z
        err = torch.sum(torch.square(foot_z - target), dim=-1)
        return torch.exp(-err / self.cfg.track_sigma)

    def reward_contact_align(self, contacts: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The share of feet in contact exactly in their stance window."""
        return torch.mean((contacts == self.in_stance(t)).to(torch.float32), dim=-1)


@configclass
class AsyncGaitSchedulerCfg(GaitSchedulerCfg):
    dof_align: float = 1.0
    dof_nominal_pos: float = 0.2
    reward_foot_z_align: float = 0.6


class AsyncGaitScheduler(GaitScheduler):
    """Legs of one group should share their joint angles (``groups`` of leg
    indices, ``joints_per_leg`` joints each, in leg order)."""

    def __init__(self, cfg: AsyncGaitSchedulerCfg, groups: Sequence[Sequence[int]],
                 joints_per_leg: int = 3, device="cuda"):
        super().__init__(cfg, device)
        self.groups = [list(g) for g in groups]
        self.jpl = joints_per_leg

    def reward_dof_align(self, dof_pos: torch.Tensor) -> torch.Tensor:
        """The joint-angle variance within each group, summed."""
        pen = 0.0
        for group in self.groups:
            legs = torch.stack([dof_pos[..., i * self.jpl:(i + 1) * self.jpl] for i in group], -2)
            pen = pen + torch.sum(torch.var(legs, dim=-2, correction=0), dim=-1)
        return pen

    def reward_dof_nominal_pos(self, dof_pos: torch.Tensor, nominal: torch.Tensor) -> torch.Tensor:
        return torch.sum(torch.square(dof_pos - nominal), dim=-1)
