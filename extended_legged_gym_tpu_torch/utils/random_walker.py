"""Random-walker command generator (port of ``utils/random_walker.py``):
per-env points that track randomly resampled targets at a bounded speed,
for smoothly wandering commands.

The state is a small dataclass of tensors advanced by plain functions.  Each
draw comes from the caller's ``torch.Generator`` or is passed in
(``init(current=, target=)``, ``step(new_targets=)``), so a test can inject
the JAX walker's draws.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from .device import resolve_device


@dataclass
class RandomWalkerState:
    current: torch.Tensor     # [B, D]
    target: torch.Tensor      # [B, D]
    timer: torch.Tensor       # [B] seconds to the next target

    def replace(self, **changes) -> "RandomWalkerState":
        return dataclasses.replace(self, **changes)


class RandomWalker:
    """``bounds`` [2, D]: (low, high) for ``"uniform"`` targets (the walk is
    clipped to them), (mean, std) for ``"normal"`` ones."""

    def __init__(self, bounds, num_envs: int, target_update_interval: float = 1.0,
                 max_track_vel: float = 0.5, distribution_type: str = "uniform", device="cuda"):
        self.device = resolve_device(device)
        self.bounds = torch.as_tensor(bounds, dtype=torch.float32, device=self.device)
        self.num_envs = num_envs
        self.interval = target_update_interval
        self.max_vel = max_track_vel
        self.dist = distribution_type

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """New targets [B, D]."""
        shape = (self.num_envs, self.bounds.shape[1])
        lo, hi = self.bounds[0], self.bounds[1]
        if self.dist == "uniform":
            u = torch.rand(shape, generator=generator, device=self.device)
            return lo + (hi - lo) * u
        return lo + hi * torch.randn(shape, generator=generator, device=self.device)

    def init(self, generator: Optional[torch.Generator] = None, current=None,
             target=None) -> RandomWalkerState:
        """A walk at a random point with a random target, ``interval`` seconds
        from the next."""
        current = self.sample(generator) if current is None else current
        target = self.sample(generator) if target is None else target
        return RandomWalkerState(current=current, target=target,
                                 timer=torch.full((self.num_envs,), float(self.interval),
                                                  device=self.device))

    def step(self, state: RandomWalkerState, dt: float,
             generator: Optional[torch.Generator] = None,
             new_targets: Optional[torch.Tensor] = None) -> RandomWalkerState:
        """Advance ``dt`` seconds: envs whose timer ran out take a new target
        (drawn every step, used where due), then every point moves toward its
        target at most ``max_track_vel``."""
        timer = state.timer - dt
        need = timer <= 0
        if new_targets is None:
            new_targets = self.sample(generator)
        target = torch.where(need[:, None], new_targets, state.target)
        timer = torch.where(need, torch.full_like(timer, float(self.interval)), timer)
        direction = target - state.current
        dist = torch.linalg.norm(direction, dim=-1, keepdim=True)
        vel = direction * torch.clamp(dist, max=self.max_vel) / (dist + 1e-6)
        current = state.current + vel * dt
        if self.dist == "uniform":
            current = torch.maximum(torch.minimum(current, self.bounds[1]), self.bounds[0])
        return RandomWalkerState(current=current, target=target, timer=timer)
