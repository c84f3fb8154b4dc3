"""Articulated-Body Algorithm physics step (port of ``physics/aba.py``),
batched over ``[B]`` envs.

This is the **plain version** of the fused CUDA kernel in
``ops/physics_kernel.py``: the CPU path of that wrapper, and the function the
kernel is held to on the card.

Formulation (Featherstone RBDA Table 7.1): body-local coordinates, spatial
vectors ``[angular; linear]``, body i's frame at its joint anchor.  Implicit
contact damping: each active contact's spatial damper
``Ds = [[rˣ D rˣᵀ, rˣ D], [−D rˣ, D]]`` times dt is added to its body's
articulated inertia before the backward sweep, and the explicit force
``f_el − D v_point`` to its bias force.  Gravity is applied as explicit
per-body forces (the base-acceleration trick would let the implicit dampers
feel a spurious ``dt·D·g``).  Revolute and prismatic joints (a prismatic
joint keeps its origin's rotation and slides the child's origin along the
axis; its motion subspace is linear).  On a fixed base
(``model.fix_base``) the base acceleration is zero and the 6x6 base solve is
skipped; the base's velocities are integrated unchanged (the env zeroes them
at reset).
"""
from __future__ import annotations

from typing import List

import torch

from ..ops.linalg import cho_solve_unrolled
from ..terrain.heightfield import TerrainData
from ..utils.math import cross as _cross, quat_to_matrix, skew
from .contact import sphere_terrain_contact
from .dynamics import _joint_rot, integrate
from .engine import EnvPhysParams, PhysState, SimParams, StepReport
from .model import RobotModel


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product [..., n, m] @ [..., m]."""
    return (M @ v[..., None])[..., 0]


def _cross_motion(v, u):
    w, l = v[..., :3], v[..., 3:]
    return torch.cat([_cross(w, u[..., :3]), _cross(w, u[..., 3:]) + _cross(l, u[..., :3])], -1)


def _cross_force(v, f):
    w, l = v[..., :3], v[..., 3:]
    return torch.cat([_cross(w, f[..., :3]) + _cross(l, f[..., 3:]), _cross(w, f[..., 3:])], -1)


def _xmot(E, r, v):
    """Motion transform parent -> child coords (child origin at r, rotation E)."""
    return torch.cat([_mv(E, v[..., :3]), _mv(E, v[..., 3:] - _cross(r, v[..., :3]))], -1)


def _xforce_T(E, r, f):
    """Force transform child -> parent coords (Xᵀ f)."""
    Et = E.transpose(-1, -2)
    fl = _mv(Et, f[..., 3:])
    return torch.cat([_mv(Et, f[..., :3]) + _cross(r, fl), fl], -1)


def _xia_T(E, r, IA):
    """Articulated-inertia transform child -> parent coords: Xᵀ IA X."""
    z = torch.zeros_like(E)
    X = torch.cat([torch.cat([E, z], -1), torch.cat([-E @ skew(r), E], -1)], -2)
    return X.transpose(-1, -2) @ IA @ X


def _spatial_inertia(inertia, com, m):
    """[B, 6, 6] spatial inertia at the body origin for masses ``m`` [B]."""
    cx = skew(com)
    m = m[:, None, None]
    eye = torch.eye(3, dtype=cx.dtype, device=cx.device)
    top = torch.cat([inertia + m * (cx @ cx.T), m * cx], -1)
    bot = torch.cat([m * cx.T, m * eye], -1)
    return torch.cat([top, bot], -2)


def foot_geoms(model: RobotModel) -> List[int]:
    """Geom index of each foot site, in sorted foot-name order (the order the
    JAX ABA step and kernel report foot states in)."""
    sites = {src: gi for gi, src in enumerate(model.geom_links) if src in model.foot_names}
    return [sites[n] for n in sorted(sites)]


def aba_physics_step(model: RobotModel, terrain: TerrainData, sp: SimParams,
                     state: PhysState, joint_torque: torch.Tensor,
                     env_params: EnvPhysParams):
    """One semi-implicit Euler step of B envs: ``(new_state, StepReport)``,
    in the floating-point type of ``state``."""
    dev, dt, ft = state.base_pos.device, sp.dt, state.base_pos.dtype
    T = model.torch(dev, ft)
    nb, nj = model.nb, model.nj
    B = state.base_pos.shape[0]
    mass = T["mass"].expand(B, nb).clone()
    mass[:, 0] += env_params.base_mass_delta
    gb = T["geom_body"]
    goff = T["geom_offset"]

    # ---------------- pass 1: kinematics + velocities ----------------
    R_w, p_w, XE, Xr, S, v, c_bias = ([None] * nb for _ in range(7))
    R0 = quat_to_matrix(state.base_quat)
    R_w[0], p_w[0] = R0, state.base_pos
    w_b = _mv(R0.transpose(-1, -2), state.base_ang_vel)
    v_b = _mv(R0.transpose(-1, -2), state.base_lin_vel)
    v[0] = torch.cat([w_b, v_b], -1)
    zeros3 = torch.zeros(3, dtype=ft, device=dev)
    for i in range(1, nb):
        par = model.parent[i]
        axis, th = T["joint_axis"][i], state.joint_pos[:, i - 1]
        if model.joint_types[i - 1] == "prismatic":
            Ej = T["joint_origin_rot"][i].expand(B, 3, 3)
            r = T["joint_origin_pos"][i] + (T["joint_origin_rot"][i] @ axis) * th[:, None]
            S[i] = torch.cat([zeros3, axis])
        else:
            Ej = T["joint_origin_rot"][i] @ _joint_rot(axis, th)
            r = T["joint_origin_pos"][i]
            S[i] = torch.cat([axis, zeros3])
        XE[i], Xr[i] = Ej.transpose(-1, -2), r
        R_w[i] = R_w[par] @ Ej
        p_w[i] = p_w[par] + _mv(R_w[par], r.expand(B, 3))
        vJ = S[i] * state.joint_vel[:, i - 1, None]
        v[i] = _xmot(XE[i], r, v[par]) + vJ
        c_bias[i] = _cross_motion(v[i], vJ)

    # ---------------- contacts (world-frame geometry) ----------------
    Rg = torch.stack(R_w, 1)[:, gb]                      # [B, ng, 3, 3]
    vg = torch.stack(v, 1)[:, gb]                        # [B, ng, 6]
    g_pos = torch.stack(p_w, 1)[:, gb] + _mv(Rg, goff.expand(B, -1, -1))
    g_vel = _mv(Rg, vg[..., 3:] + _cross(vg[..., :3], goff))
    mu = sp.contact.mu * terrain.friction * env_params.friction_scale[:, None]
    contact = sphere_terrain_contact(terrain, sp.contact, g_pos, g_vel, T["geom_radius"],
                                     anchor=state.contact_anchor, mu=mu)
    f_expl = contact.f_el - contact.apply_D(g_vel)

    # ---------------- pass 2: articulated inertias + bias forces ----------------
    IA = [_spatial_inertia(T["inertia"][i], T["com"][i], mass[:, i]) for i in range(nb)]
    pA = [_cross_force(v[i], _mv(IA[i], v[i])) for i in range(nb)]
    RgT = Rg.transpose(-1, -2)
    f_b = _mv(RgT, f_expl)
    F_sp = torch.cat([_cross(goff, f_b), f_b], -1)       # [B, ng, 6]
    n_b = _mv(RgT, contact.n)
    eye3 = torch.eye(3, dtype=ft, device=dev)
    Db = (contact.kt[..., None, None] * eye3
          + contact.kd_minus_kt[..., None, None] * n_b[..., :, None] * n_b[..., None, :])
    rx = skew(goff)                                      # [ng, 3, 3]
    rxD = rx @ Db
    Ds = torch.cat([torch.cat([rxD @ rx.transpose(-1, -2), rxD], -1),
                    torch.cat([rxD.transpose(-1, -2), Db], -1)], -2)
    F_body = torch.zeros(B, nb, 6, dtype=ft, device=dev).index_add_(1, gb, F_sp)
    Ds_body = torch.zeros(B, nb, 6, 6, dtype=ft, device=dev).index_add_(1, gb, Ds)
    g = torch.tensor(sp.gravity, dtype=ft, device=dev)
    for i in range(nb):
        f_g = mass[:, i, None] * _mv(R_w[i].transpose(-1, -2), g.expand(B, 3))
        pA[i] = pA[i] - F_body[:, i] - torch.cat([_cross(T["com"][i], f_g), f_g], -1)
        IA[i] = IA[i] + dt * Ds_body[:, i]
    tau = joint_torque - sp.joint_damping * state.joint_vel

    # ---------------- backward sweep ----------------
    U, d_inv, u = [None] * nb, [None] * nb, [None] * nb
    for i in range(nb - 1, 0, -1):
        par, r = model.parent[i], Xr[i]
        U[i] = _mv(IA[i], S[i].expand(B, 6))
        d_inv[i] = 1.0 / (U[i] @ S[i] + T["armature"][i - 1] + dt * sp.joint_damping)
        u[i] = tau[:, i - 1] - pA[i] @ S[i]
        Ia = IA[i] - U[i][:, :, None] * U[i][:, None, :] * d_inv[i][:, None, None]
        pa = pA[i] + _mv(Ia, c_bias[i]) + U[i] * (u[i] * d_inv[i])[:, None]
        IA[par] = IA[par] + _xia_T(XE[i], r, Ia)
        pA[par] = pA[par] + _xforce_T(XE[i], r, pa)

    # ---------------- base solve + forward sweep ----------------
    if model.fix_base:
        a0 = base_acc = torch.zeros(B, 6, dtype=ft, device=dev)
    else:
        a0 = cho_solve_unrolled(IA[0] + 1e-6 * torch.eye(6, dtype=ft, device=dev), -pA[0])
        a_cl = a0[:, 3:] + _cross(w_b, v_b)
        base_acc = torch.cat([_mv(R0, a_cl), _mv(R0, a0[:, :3])], -1)
    a, qdd = [a0] + [None] * (nb - 1), []
    for i in range(1, nb):
        a_i = _xmot(XE[i], Xr[i], a[model.parent[i]]) + c_bias[i]
        qdd_i = (u[i] - (U[i] * a_i).sum(-1)) * d_inv[i]
        a[i] = a_i + S[i] * qdd_i[:, None]
        qdd.append(qdd_i)
    udot = torch.cat([base_acc, torch.stack(qdd, -1)], -1)

    # ---------------- integrate + report ----------------
    pos, quat, th, vel, om, thd = integrate(
        state.base_pos, state.base_quat, state.joint_pos, state.base_lin_vel,
        state.base_ang_vel, state.joint_vel, udot, dt,
        T["dof_vel_limits"] if sp.enforce_dof_vel_limits else None)
    new_state = PhysState(pos, quat, th, vel, om, thd, contact.anchor)

    # implicit-consistent force report: post-step point velocities from the
    # true body accelerations
    ag = torch.stack(a, 1)[:, gb]
    w_g, vl_g = vg[..., :3], vg[..., 3:]
    a_pt = (ag[..., 3:] + _cross(w_g, vl_g) + _cross(ag[..., :3], goff)
            + _cross(w_g, _cross(w_g, goff)))
    g_vel_new = g_vel + dt * _mv(Rg, a_pt)
    geom_forces = contact.f_el - contact.apply_D(g_vel_new)
    geom_forces = geom_forces * (contact.depth > 0.0).to(geom_forces.dtype)[..., None]

    fg = foot_geoms(model)
    fb = gb[fg]
    Rf = torch.stack(R_w, 1)[:, fb]
    vf = torch.stack(v, 1)[:, fb]
    off = T["foot_offset"][: len(fg)]
    foot_pos = torch.stack(p_w, 1)[:, fb] + _mv(Rf, off.expand(B, -1, -1))
    foot_vel = _mv(Rf, vf[..., 3:] + _cross(vf[..., :3], off))
    return new_state, StepReport(geom_forces=geom_forces, foot_pos=foot_pos, foot_vel=foot_vel,
                                 qdd=udot)
