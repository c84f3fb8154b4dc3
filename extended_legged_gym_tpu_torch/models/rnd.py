"""Random Network Distillation intrinsic rewards (port of ``models/rnd.py``):
a frozen target MLP and a trained predictor MLP of the same shape; the
intrinsic reward is the distance between their outputs on the (normalized)
observation, normalized and weighted by a schedule.

The JAX package keeps the networks' parameters, the normalizers and the step
in an ``RNDState`` that its functions return anew; here the module holds
them and ``intrinsic_reward`` advances them in place.  Plain PyTorch: the
JAX module reaches no Pallas kernel.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .networks import MLP, RunningNorm


class RandomNetworkDistillation(nn.Module):
    """``target`` (frozen) and ``predictor`` are flax-named :class:`MLP`s
    (``Dense_k``, elu); ``state_norm`` and ``reward_norm`` are
    :class:`RunningNorm`s (or ``None``) and ``step`` counts the calls of
    :meth:`intrinsic_reward`.  Weight schedules (``weight_schedule``):
    ``{"mode": "constant"}``; ``{"mode": "step", "final_step", "final_value"}``
    (``weight`` until ``final_step``, then ``final_value``); ``{"mode":
    "linear", "initial_step", "final_step", "final_value"}``."""

    def __init__(self, num_states: int, num_outputs: int = 64,
                 hidden_dims: Sequence[int] = (256, 256), weight: float = 1.0,
                 weight_schedule: Optional[dict] = None, state_normalization: bool = True,
                 reward_normalization: bool = True, generator: Optional[torch.Generator] = None,
                 device="cpu"):
        super().__init__()
        self.target = MLP(num_states, hidden_dims, num_outputs, generator=generator)
        self.predictor = MLP(num_states, hidden_dims, num_outputs, generator=generator)
        self.target.requires_grad_(False)
        self.to(device)
        self.weight = float(weight)
        self.weight_schedule = weight_schedule or {"mode": "constant"}
        self.state_norm = (RunningNorm.create(num_states, device=device)
                           if state_normalization else None)
        self.reward_norm = RunningNorm.create(1, device=device) if reward_normalization else None
        self.step = torch.zeros((), dtype=torch.int64, device=device)

    def weight_at(self, step: torch.Tensor) -> torch.Tensor:
        """The intrinsic reward's weight at ``step`` (a device tensor)."""
        ws = self.weight_schedule
        mode = ws.get("mode", "constant")
        w = torch.tensor(self.weight, device=step.device)
        if mode == "step":
            w = torch.where(step >= ws["final_step"],
                            torch.tensor(float(ws["final_value"]), device=step.device), w)
        elif mode == "linear":
            t = ((step - ws["initial_step"])
                 / max(ws["final_step"] - ws["initial_step"], 1)).clamp(0.0, 1.0)
            w = self.weight + t * (ws["final_value"] - self.weight)
        return w

    @torch.no_grad()
    def intrinsic_reward(self, rnd_obs: torch.Tensor, mesh=None) -> torch.Tensor:
        """Per-env intrinsic reward ``[B]``.  Updates the state normalizer with
        ``rnd_obs`` before normalizing it, the reward normalizer with the raw
        distances before normalizing them, and advances ``step``.  With a
        ``mesh`` both normalizers take every rank's rows
        (``RunningNorm.update``), so they stay equal on every rank."""
        x = rnd_obs
        if self.state_norm is not None:
            self.state_norm = self.state_norm.update(x, mesh)
            x = self.state_norm.normalize(x)
        rew = torch.linalg.norm(self.target(x) - self.predictor(x), dim=-1)
        if self.reward_norm is not None:
            self.reward_norm = self.reward_norm.update(rew[:, None], mesh)
            rew = self.reward_norm.normalize(rew[:, None])[:, 0]
        rew = rew * self.weight_at(self.step)
        self.step = self.step + 1
        return rew

    def predictor_loss(self, rnd_obs: torch.Tensor) -> torch.Tensor:
        """Mean squared distance of the predictor to the frozen target on the
        normalized observations (no normalizer update)."""
        x = self.state_norm.normalize(rnd_obs) if self.state_norm is not None else rnd_obs
        with torch.no_grad():
            target = self.target(x)
        return torch.mean(torch.square(self.predictor(x) - target))
