"""Physics state and parameter types (port of the types of
``physics/engine.py``).  The step itself is ``physics/aba.py`` (plain
version) and ``ops/physics_kernel.py`` (fused CUDA kernel)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import torch

from .contact import ContactParams, default_contact_params
from ..utils.device import resolve_device
from .model import RobotModel


@dataclass(frozen=True)
class SimParams:
    dt: float = 0.005                                     # physics dt [s]
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    contact: ContactParams = field(default_factory=default_contact_params)
    joint_damping: float = 0.0                            # implicit viscous joint damping


def default_sim_params(dt: float = 0.005, gravity=(0.0, 0.0, -9.81),
                       contact: Optional[ContactParams] = None,
                       joint_damping: float = 0.0) -> SimParams:
    return SimParams(dt=float(dt), gravity=tuple(float(g) for g in gravity),
                     contact=contact if contact is not None else default_contact_params(),
                     joint_damping=float(joint_damping))


@dataclass
class PhysState:
    """Generalized state of a batch of robots, ``[B, ...]``.

    ``contact_anchor`` holds the stiction anchors (world xy per collision
    geom), see ``contact.py``."""

    base_pos: torch.Tensor        # [B, 3]
    base_quat: torch.Tensor       # [B, 4] xyzw
    joint_pos: torch.Tensor       # [B, nj]
    base_lin_vel: torch.Tensor    # [B, 3] world
    base_ang_vel: torch.Tensor    # [B, 3] world
    joint_vel: torch.Tensor       # [B, nj]
    contact_anchor: torch.Tensor  # [B, ng, 2] world xy

    def replace(self, **changes) -> "PhysState":
        return dataclasses.replace(self, **changes)


@dataclass
class EnvPhysParams:
    """Per-env domain randomization."""

    friction_scale: torch.Tensor   # [B] multiplier on terrain friction
    base_mass_delta: torch.Tensor  # [B] added base mass [kg]


def default_env_params(B: int, device="cuda") -> EnvPhysParams:
    device = resolve_device(device)
    return EnvPhysParams(friction_scale=torch.ones(B, device=device),
                         base_mass_delta=torch.zeros(B, device=device))


class StepReport(NamedTuple):
    """Per-step quantities the env layer reads."""

    geom_forces: torch.Tensor     # [B, ng, 3] world contact force on each geom
    foot_pos: torch.Tensor        # [B, nf, 3]
    foot_vel: torch.Tensor        # [B, nf, 3]


def initial_state(model: RobotModel, B: int, pos=(0.0, 0.0, 0.6), quat=(0, 0, 0, 1),
                  device="cuda") -> PhysState:
    """``B`` robots standing still at ``pos`` in the default joint pose."""
    device = resolve_device(device)
    p = torch.tensor(pos, dtype=torch.float32, device=device).expand(B, 3).clone()
    return PhysState(
        base_pos=p,
        base_quat=torch.tensor(quat, dtype=torch.float32, device=device).expand(B, 4).clone(),
        joint_pos=model.torch(device)["default_dof_pos"].expand(B, model.nj).clone(),
        base_lin_vel=torch.zeros(B, 3, device=device),
        base_ang_vel=torch.zeros(B, 3, device=device),
        joint_vel=torch.zeros(B, model.nj, device=device),
        contact_anchor=p[:, None, :2].expand(B, model.ng, 2).clone(),
    )
