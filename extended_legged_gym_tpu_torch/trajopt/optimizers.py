"""Sampling-based trajectory updates: MPPI / WBFO / AVWBFO (port of
``trajopt/optimizers.py``).

Each rule maps one env's samples ``[N, Hn+1, A]`` and per-step rewards
``[N, Hs+1]`` to a new mean ``[Hn+1, A]``; here they take a leading env axis
``[E, ...]`` instead of being vmapped.
* MPPI: one softmax weight per sample from its z-normalized total reward.
* WBFO: one softmax weight per (sample, node): each node scores the per-step
  rewards under its (non-negative part of the) interpolation basis column.
* AVWBFO: WBFO on the discounted reward-to-go.
"""
from __future__ import annotations

from typing import Callable

import torch


def _znorm(x: torch.Tensor, dim: int, eps: float = 1e-6) -> torch.Tensor:
    """Z-score over ``dim`` with the population std, as ``jnp.std``."""
    return (x - x.mean(dim=dim, keepdim=True)) / (x.std(dim=dim, keepdim=True, correction=0) + eps)


def mppi_update(mean_nodes, samples, step_rewards, temp: float):
    totals = step_rewards.sum(dim=-1)                                   # [E, N]
    weights = torch.softmax(_znorm(totals, dim=1) / temp, dim=1)
    return torch.einsum("en,enha->eha", weights, samples)


def wbfo_update(mean_nodes, samples, step_rewards, temp: float, basis: torch.Tensor):
    pos = basis.clamp(min=0.0)
    col = pos / (pos.sum(dim=0, keepdim=True) + 1e-9)                   # [D, Hn+1]
    node_scores = torch.einsum("end,dh->enh", step_rewards, col)        # [E, N, Hn+1]
    weights = torch.softmax(_znorm(node_scores, dim=1) / temp, dim=1)
    return torch.einsum("enh,enha->eha", weights, samples)


def reward_to_go(step_rewards: torch.Tensor, gamma: float) -> torch.Tensor:
    """R_t = sum_{t' >= t} gamma^(t'-t) r_t' over the last axis."""
    out = torch.empty_like(step_rewards)
    acc = torch.zeros_like(step_rewards[..., 0])
    for t in range(step_rewards.shape[-1] - 1, -1, -1):
        acc = step_rewards[..., t] + gamma * acc
        out[..., t] = acc
    return out


def avwbfo_update(mean_nodes, samples, step_rewards, temp: float, basis: torch.Tensor,
                  gamma: float):
    return wbfo_update(mean_nodes, samples, reward_to_go(step_rewards, gamma), temp, basis)


def make_update_fn(method: str, temp: float, basis: torch.Tensor, gamma: float = 1.0) -> Callable:
    """Bind an update rule: (mean_nodes, samples, step_rewards) -> new mean."""
    if method == "mppi":
        return lambda m, s, r: mppi_update(m, s, r, temp)
    if method == "wbfo":
        return lambda m, s, r: wbfo_update(m, s, r, temp, basis)
    if method == "avwbfo":
        return lambda m, s, r: avwbfo_update(m, s, r, temp, basis, gamma)
    raise ValueError(f"unknown update method {method}")
