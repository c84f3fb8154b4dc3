"""The physics engine step and its types (port of ``physics/engine.py``).

:func:`physics_step` advances B envs by one sim dt with the solver that
``SimParams.solver`` names: ``"aba"``, the articulated-body step of
``physics/aba.py`` (the plain version of the fused CUDA kernel in
``ops/physics_kernel.py``; ``"pallas"``, the env's name for the kernel
route, runs it too, as in the JAX package), or ``"crba"``, the dense
joint-space solve assembled from body Jacobians (``physics/dynamics.py``),
which is the oracle the ABA step is held to.  :func:`step_batch` is the
same step under the JAX package's batched name.  :class:`EngineEnvStep` is the env's engine route:
the ABA step per substep for the scenes the fused kernel does not model (a
ceiling, contacts on a triangle mesh)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import torch

from .contact import ContactParams, default_contact_params, sphere_terrain_contact
from .dynamics import (bias_forces, body_jacobians, forward_dynamics, forward_kinematics,
                       integrate, mass_matrix, point_jacobian)
from ..utils.device import resolve_device
from ..utils.math import cross
from .model import RobotModel


@dataclass(frozen=True)
class SimParams:
    dt: float = 0.005                                     # physics dt [s]
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    contact: ContactParams = field(default_factory=default_contact_params)
    joint_damping: float = 0.0                            # implicit viscous joint damping
    solver: str = "aba"                                   # "aba" ("pallas"), or "crba" (dense; the oracle)
    # clamp joint velocities to the model's limits (capped at 500 rad/s);
    # off, to the generic +-500 rad/s
    enforce_dof_vel_limits: bool = True


def default_sim_params(dt: float = 0.005, gravity=(0.0, 0.0, -9.81),
                       contact: Optional[ContactParams] = None,
                       joint_damping: float = 0.0, solver: str = "aba",
                       enforce_dof_vel_limits: bool = True) -> SimParams:
    return SimParams(dt=float(dt), gravity=tuple(float(g) for g in gravity),
                     contact=contact if contact is not None else default_contact_params(),
                     joint_damping=float(joint_damping), solver=solver,
                     enforce_dof_vel_limits=bool(enforce_dof_vel_limits))


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
    """Per-step quantities the env layer reads, and the generalized
    acceleration where a plain step computed it (the kernel leaves it
    ``None``)."""

    geom_forces: torch.Tensor     # [B, ng, 3] world contact force on each geom
    foot_pos: torch.Tensor        # [B, nf, 3]
    foot_vel: torch.Tensor        # [B, nf, 3]
    qdd: Optional[torch.Tensor] = None   # [B, nv]


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


def physics_step(model: RobotModel, terrain, sp: SimParams, state: PhysState,
                 joint_torque: torch.Tensor, env_params: EnvPhysParams):
    """One semi-implicit Euler step of B envs with ``sp.solver`` (``"pallas"``
    steps ABA): ``(new_state, StepReport)``."""
    if sp.solver in ("aba", "pallas"):
        from .aba import aba_physics_step

        return aba_physics_step(model, terrain, sp, state, joint_torque, env_params)
    if sp.solver != "crba":
        raise ValueError(f"unknown solver {sp.solver!r}: 'aba', 'crba' or 'pallas'")
    return _physics_step_crba(model, terrain, sp, state, joint_torque, env_params)


step_batch = physics_step   # the JAX package's name for the batched step


def geom_positions(model: RobotModel, kin) -> torch.Tensor:
    """World positions [B, ng, 3] of the collision spheres, from the
    forward kinematics ``kin`` (:func:`physics.dynamics.forward_kinematics`)."""
    T = model.torch(kin.body_pos.device, kin.body_pos.dtype)
    gb = T["geom_body"]
    return kin.body_pos[:, gb] + (kin.body_rot[:, gb] @ T["geom_offset"][..., None])[..., 0]


def _physics_step_crba(model, terrain, sp, state, joint_torque, env_params):
    """The dense step: M, C and the contact Jacobians, the implicit contact
    damper dt Σ JᵀDJ added to M, one Cholesky solve."""
    ft, dev = state.base_pos.dtype, state.base_pos.device
    T = model.torch(dev, ft)
    B, nv = state.base_pos.shape[0], model.nv
    kin = forward_kinematics(model, state.base_pos, state.base_quat, state.joint_pos,
                             state.base_lin_vel, state.base_ang_vel, state.joint_vel)
    gb = T["geom_body"]
    g_pos = geom_positions(model, kin)
    g_vel = kin.v_origin[:, gb] + cross(kin.omega[:, gb], g_pos - kin.body_pos[:, gb])
    mu = sp.contact.mu * terrain.friction * env_params.friction_scale[:, None]
    contact = sphere_terrain_contact(terrain, sp.contact, g_pos, g_vel, T["geom_radius"],
                                     anchor=state.contact_anchor, mu=mu)

    mass = T["mass"].expand(B, model.nb).clone()
    mass[:, 0] += env_params.base_mass_delta
    Jv, Jw = body_jacobians(model, kin)
    M = mass_matrix(model, kin, Jv, Jw, mass=mass)
    C = bias_forces(model, kin, Jv, Jw, torch.tensor(sp.gravity, dtype=ft, device=dev), mass=mass)
    Jg = point_jacobian(model, kin, gb, g_pos)                       # [B, ng, 3, nv]
    # implicit contact damping M' = M + dt Σ JᵀDJ, D = kt I + (kd - kt) n nᵀ
    ng = Jg.shape[1]
    a = torch.einsum("bgiv,bgi->bgv", Jg, contact.n)
    J_kt = (Jg * torch.sqrt(contact.kt.clamp(min=0.0))[..., None, None]).reshape(B, 3 * ng, nv)
    JtDJ = (J_kt.transpose(1, 2) @ J_kt
            + torch.einsum("bgv,bgw->bvw", a * contact.kd_minus_kt[..., None], a))
    M_imp = M + sp.dt * JtDJ
    if model.nj:
        jd = torch.cat([torch.zeros(6, dtype=ft, device=dev),
                        torch.full((model.nj,), sp.dt * sp.joint_damping, dtype=ft, device=dev)])
        M_imp = M_imp + torch.diag_embed(jd)
    f_expl = contact.f_el - contact.apply_D(g_vel)
    tau_ext = torch.einsum("bgiv,bgi->bv", Jg, f_expl)
    tau_j = joint_torque - sp.joint_damping * state.joint_vel
    udot = forward_dynamics(model, M_imp, C, tau_j, tau_ext)

    pos, quat, th, v, w, thd = integrate(
        state.base_pos, state.base_quat, state.joint_pos, state.base_lin_vel,
        state.base_ang_vel, state.joint_vel, udot, sp.dt,
        joint_vel_limit=T["dof_vel_limits"] if sp.enforce_dof_vel_limits else None)
    new_state = PhysState(pos, quat, th, v, w, thd, contact.anchor)

    # force report with the post-step velocities (implicit-consistent)
    g_vel_new = g_vel + sp.dt * torch.einsum("bgiv,bv->bgi", Jg, udot)
    geom_forces = contact.f_el - contact.apply_D(g_vel_new)
    geom_forces = geom_forces * (contact.depth > 0.0).to(ft)[..., None]
    fb = T["foot_body"]
    f_rot = kin.body_rot[:, fb]
    foot_pos = kin.body_pos[:, fb] + (f_rot @ T["foot_offset"][..., None])[..., 0]
    foot_vel = kin.v_origin[:, fb] + cross(kin.omega[:, fb], foot_pos - kin.body_pos[:, fb])
    return new_state, StepReport(geom_forces=geom_forces, foot_pos=foot_pos, foot_vel=foot_vel,
                                 qdd=udot)


class EngineEnvStep:
    """One physics substep of B envs with the torques passed in, on the plain
    engine (:func:`physics_step`, with ``sp.solver``), for the scenes the
    fused kernel does not model: a terrain with a ceiling (the kernel has no
    ceiling branch) or with contacts on its triangle mesh (the kernel's
    tangent-plane scheme assumes mostly vertical normals), and for any scene
    whose config asks for ``sim.solver`` "aba" or "crba".  The env chooses
    it from its configuration, as the JAX env leaves its fused step for the
    XLA engine; it is never a fallback for a kernel that failed.  Called as ``(phys, tau,
    env_params) -> (new_phys, report)``; ``EngineEnvStep.engine_substeps``
    counts the substeps of all instances."""

    engine_substeps = 0

    def __init__(self, model: RobotModel, sp: SimParams, terrain):
        self.model, self.sp, self.terrain = model, sp, terrain

    def __call__(self, phys: PhysState, tau: torch.Tensor, env_params: EnvPhysParams):
        type(self).engine_substeps += 1
        return physics_step(self.model, self.terrain, self.sp, phys, tau, env_params)
