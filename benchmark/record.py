"""Recording what the program's timed path produces, from outside it: a
wrapper put in the place of one of the program's callables for the steps
that the check follows, and taken away before the measured window."""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import torch

from .reference.physics import STATE_KEYS


@contextlib.contextmanager
def patched(obj, name: str, make: Callable):
    """Put ``make(original)`` in the place of ``obj.name`` for the block;
    afterwards ``obj.name`` is what it was (an instance attribute shadowing a
    method is removed again)."""
    had = name in getattr(obj, "__dict__", {})
    original = getattr(obj, name)
    setattr(obj, name, make(original))
    try:
        yield
    finally:
        if had:
            setattr(obj, name, original)
        else:
            delattr(obj, name)


def rows(B: int, k: int, gen: torch.Generator, device) -> torch.Tensor:
    """``min(k, B)`` distinct row indices out of ``B``, drawn from ``gen``."""
    return torch.randperm(B, generator=gen)[: min(k, B)].to(device)


def to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


class PhysicsRows:
    """Wraps the env's fused physics step ``(phys, actions, env_params) ->
    (new_phys, tau, report)``: for ``k`` rows of every call, drawn from the
    seed, keeps the inputs and the outputs."""

    def __init__(self, k: int, gen: torch.Generator):
        self.k, self.gen = k, gen
        self.records: List[Dict[str, torch.Tensor]] = []
        self.rows_before = 0            # stacked rows before the last call's
        self.last_idx = None

    def __call__(self, step):
        def wrapped(phys, actions, env_params):
            out = step(phys, actions, env_params)
            new, tau, report = out
            idx = rows(actions.shape[0], self.k, self.gen, actions.device)
            if self.records:
                self.rows_before += self.records[-1]["actions"].shape[0]
            self.last_idx = idx
            rec = {"in." + k: getattr(phys, k)[idx].clone() for k in STATE_KEYS}
            rec.update({"out." + k: getattr(new, k)[idx].clone() for k in STATE_KEYS})
            rec.update(actions=actions[idx].clone(),
                       friction=env_params.friction_scale[idx].clone(),
                       mass_delta=env_params.base_mass_delta[idx].clone(),
                       tau=tau[idx].clone(), geom_forces=report.geom_forces[idx].clone(),
                       foot_pos=report.foot_pos[idx].clone(), foot_vel=report.foot_vel[idx].clone())
            self.records.append(rec)
            return out
        return wrapped

    def stacked(self) -> Dict[str, torch.Tensor]:
        return {k: torch.cat([r[k] for r in self.records]) for k in self.records[0]}
