"""Articulated rigid-body dynamics in generalized coordinates (port of
``physics/dynamics.py``), batched over ``[B]`` envs.

World-frame Lagrangian dynamics assembled from body Jacobians, the
formulation of the CRBA engine (``physics/engine.py::physics_step`` with
``solver="crba"``), which is the oracle the ABA step is held to:

  M(q) u̇ + C(q, u) = τ + Σ J_pᵀ f_ext
  M = Σ_i mᵢ J_vᵢᵀ J_vᵢ + J_ωᵢᵀ R Iᵢ Rᵀ J_ωᵢ           (+ armature)
  C = Σ_i J_vᵢᵀ mᵢ (a_biasᵢ − g) + J_ωᵢᵀ (I α_biasᵢ + ωᵢ × I ωᵢ)

Generalized velocity layout ``u = [v_base_world(3), ω_base_world(3), θ̇(nj)]``.
Every function takes and returns ``[B, ...]`` tensors; the model's tables come
from :meth:`RobotModel.torch` in the state's device and float type.  Joints
are revolute or prismatic (a prismatic joint keeps its frame's rotation and
slides the child's origin along the world axis; its Jacobian column is the
axis itself, and it adds no angular velocity).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.linalg import cho_solve_unrolled
from ..utils.math import cross, quat_from_axis_angle, quat_mul, quat_to_matrix, skew
from .model import RobotModel


class Kinematics(NamedTuple):
    body_rot: torch.Tensor     # [B, nb, 3, 3] world rotation of each body frame
    body_pos: torch.Tensor     # [B, nb, 3] world position of each body origin
    com_w: torch.Tensor        # [B, nb, 3] world com of each body
    axis_w: torch.Tensor       # [B, nj, 3] world joint axes
    anchor_w: torch.Tensor     # [B, nj, 3] world joint anchor points
    omega: torch.Tensor        # [B, nb, 3] world angular velocity of each body
    v_origin: torch.Tensor     # [B, nb, 3] world linear velocity of each body origin
    alpha_bias: torch.Tensor   # [B, nb, 3] angular acceleration with u̇ = 0
    a_com_bias: torch.Tensor   # [B, nb, 3] com linear acceleration with u̇ = 0


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _joint_rot(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [B, 3, 3] about ``axis`` [3] by ``angle`` [B] (Rodrigues)."""
    c = torch.cos(angle)[:, None, None]
    s = torch.sin(angle)[:, None, None]
    K = skew(axis)
    return torch.eye(3, dtype=angle.dtype, device=angle.device) + s * K + (1.0 - c) * (K @ K)


def forward_kinematics(model: RobotModel, base_pos, base_quat, joint_pos, base_lin_vel,
                       base_ang_vel, joint_vel) -> Kinematics:
    """Positions, velocities and velocity-product (bias) accelerations of
    every body, walking the tree from the base."""
    nb = model.nb
    B, ft, dev = base_pos.shape[0], base_pos.dtype, base_pos.device
    T = model.torch(dev, ft)

    R, p, w, v, al, ac = ([None] * nb for _ in range(6))
    R[0] = quat_to_matrix(base_quat)
    p[0], w[0], v[0] = base_pos, base_ang_vel, base_lin_vel
    al[0] = ac[0] = torch.zeros(B, 3, dtype=ft, device=dev)
    axis_w, anchor_w = [], []
    for i in range(1, nb):
        par = model.parent[i]
        Rp, pp, wp, vp, alp, acp = R[par], p[par], w[par], v[par], al[par], ac[par]
        R_joint = Rp @ T["joint_origin_rot"][i]
        anchor = pp + _mv(Rp, T["joint_origin_pos"][i].expand(B, 3))
        a_w = _mv(R_joint, T["joint_axis"][i].expand(B, 3))
        axis_w.append(a_w)
        anchor_w.append(anchor)
        th, thd = joint_pos[:, i - 1, None], joint_vel[:, i - 1, None]
        if model.joint_types[i - 1] == "prismatic":
            # the origin slides along the axis: a point moving in the parent
            p[i] = anchor + th * a_w
            r = p[i] - pp
            R[i], w[i], al[i] = R_joint, wp, alp
            v[i] = vp + cross(wp, r) + thd * a_w
            ac[i] = (acp + cross(alp, r) + cross(wp, cross(wp, r))
                     + 2.0 * cross(wp, thd * a_w))
            continue
        r = anchor - pp
        # the anchor is a material point of the parent: its velocity and acceleration
        R[i] = R_joint @ _joint_rot(T["joint_axis"][i], joint_pos[:, i - 1])
        p[i] = anchor
        w[i] = wp + thd * a_w
        v[i] = vp + cross(wp, r)
        al[i] = alp + cross(wp, thd * a_w)
        ac[i] = acp + cross(alp, r) + cross(wp, cross(wp, r))

    body_rot, body_pos = torch.stack(R, 1), torch.stack(p, 1)
    omega, v_origin = torch.stack(w, 1), torch.stack(v, 1)
    alpha_bias, a_origin_bias = torch.stack(al, 1), torch.stack(ac, 1)
    com_w = body_pos + _mv(body_rot, T["com"].expand(B, nb, 3))
    c = com_w - body_pos
    a_com_bias = a_origin_bias + cross(alpha_bias, c) + cross(omega, cross(omega, c))
    empty = torch.zeros(B, 0, 3, dtype=ft, device=dev)
    return Kinematics(body_rot, body_pos, com_w,
                      torch.stack(axis_w, 1) if axis_w else empty,
                      torch.stack(anchor_w, 1) if anchor_w else empty,
                      omega, v_origin, alpha_bias, a_com_bias)


def _prismatic_mask(model: RobotModel, device) -> torch.Tensor:
    """[nj] bool, true at the prismatic joints."""
    return torch.tensor([t == "prismatic" for t in model.joint_types], device=device)


def point_jacobian(model: RobotModel, kin: Kinematics, body_idx, points_w: torch.Tensor) -> torch.Tensor:
    """Point Jacobians ``[B, P, 3, nv]`` (v_point = J u) of points ``points_w``
    [B, P, 3] attached to bodies ``body_idx`` [P]: the ancestor mask selects
    the joint columns acting on each point."""
    B, P = points_w.shape[:2]
    ft, dev = points_w.dtype, points_w.device
    T = model.torch(dev, ft)
    body_idx = torch.as_tensor(body_idx, dtype=torch.int64, device=dev)
    r_base = points_w - kin.body_pos[:, 0:1]
    eye = torch.eye(3, dtype=ft, device=dev).expand(B, P, 3, 3)
    cols = [eye, -skew(r_base)]
    if model.nj:
        rel = points_w[:, :, None, :] - kin.anchor_w[:, None, :, :]      # [B, P, nj, 3]
        jc = cross(kin.axis_w[:, None, :, :], rel)
        if model.has_prismatic:
            pris = _prismatic_mask(model, dev)[:, None]
            jc = torch.where(pris, kin.axis_w[:, None, :, :].expand_as(jc), jc)
        anc = T["ancestor_mask"][body_idx]                               # [P, nj]
        cols.append((jc * anc[None, :, :, None]).transpose(-1, -2))
    return torch.cat(cols, -1)


def body_jacobians(model: RobotModel, kin: Kinematics) -> Tuple[torch.Tensor, torch.Tensor]:
    """COM linear and angular Jacobians of every body: ``[B, nb, 3, nv]`` each."""
    B, nb = kin.body_pos.shape[:2]
    ft, dev = kin.body_pos.dtype, kin.body_pos.device
    Jv = point_jacobian(model, kin, torch.arange(nb, device=dev), kin.com_w)
    eye = torch.eye(3, dtype=ft, device=dev).expand(B, nb, 3, 3)
    cols = [torch.zeros(B, nb, 3, 3, dtype=ft, device=dev), eye]
    if model.nj:
        ax = kin.axis_w[:, None, :, :].expand(B, nb, model.nj, 3)
        if model.has_prismatic:
            ax = ax * ~_prismatic_mask(model, dev)[:, None]
        anc = model.torch(dev, ft)["ancestor_mask"]
        cols.append((ax * anc[None, :, :, None]).transpose(-1, -2))
    return Jv, torch.cat(cols, -1)


def _world_inertia(model: RobotModel, kin: Kinematics) -> torch.Tensor:
    I = model.torch(kin.body_rot.device, kin.body_rot.dtype)["inertia"]
    return kin.body_rot @ I @ kin.body_rot.transpose(-1, -2)


def _masses(model: RobotModel, kin: Kinematics, mass: Optional[torch.Tensor]) -> torch.Tensor:
    if mass is None:
        mass = model.torch(kin.body_rot.device, kin.body_rot.dtype)["mass"]
    return mass.expand(kin.body_pos.shape[0], model.nb)


def mass_matrix(model: RobotModel, kin: Kinematics, Jv: torch.Tensor, Jw: torch.Tensor,
                mass: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Joint-space inertia ``[B, nv, nv]`` by Jacobian assembly (CRBA-
    equivalent): (√m Jv)ᵀ(√m Jv) + Jwᵀ (Iw Jw), symmetrized, plus armature;
    ``mass`` [B, nb] or [nb] (default the model's)."""
    B, nb, _, nv = Jv.shape
    m = _masses(model, kin, mass)
    Iw = _world_inertia(model, kin)
    Jv_m = (Jv * torch.sqrt(m)[..., None, None]).reshape(B, 3 * nb, nv)
    IwJw = (Iw @ Jw).reshape(B, 3 * nb, nv)
    Jw_f = Jw.reshape(B, 3 * nb, nv)
    M = Jv_m.transpose(1, 2) @ Jv_m + Jw_f.transpose(1, 2) @ IwJw
    M = 0.5 * (M + M.transpose(1, 2))
    if model.nj:
        arm = model.torch(M.device, M.dtype)["armature"]
        M = M + torch.diag_embed(torch.cat([torch.zeros(6, dtype=M.dtype, device=M.device), arm]))
    return M


def bias_forces(model: RobotModel, kin: Kinematics, Jv: torch.Tensor, Jw: torch.Tensor,
                gravity: torch.Tensor, mass: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Generalized bias forces C(q, u) ``[B, nv]``: Coriolis, centrifugal and
    gravity."""
    m = _masses(model, kin, mass)
    Iw = _world_inertia(model, kin)
    f_lin = m[..., None] * (kin.a_com_bias - gravity)
    f_ang = _mv(Iw, kin.alpha_bias) + cross(kin.omega, _mv(Iw, kin.omega))
    return (torch.einsum("bniv,bni->bv", Jv, f_lin) + torch.einsum("bniv,bni->bv", Jw, f_ang))


def forward_dynamics(model: RobotModel, M: torch.Tensor, C: torch.Tensor,
                     tau_joint: torch.Tensor, tau_ext: torch.Tensor) -> torch.Tensor:
    """u̇ = M⁻¹ (Sτ − C + τ_ext) ``[B, nv]`` by the unrolled Cholesky, with
    1e-6 added to the diagonal; on a fixed base the base rows are zero and
    only the joint block is solved."""
    rhs = tau_ext - C
    if model.nj:
        rhs = torch.cat([rhs[:, :6], rhs[:, 6:] + tau_joint], -1)
    if model.fix_base:
        n = M.shape[-1] - 6
        Mjj = M[:, 6:, 6:] + 1e-6 * torch.eye(n, dtype=M.dtype, device=M.device)
        return torch.cat([torch.zeros_like(rhs[:, :6]), cho_solve_unrolled(Mjj, rhs[:, 6:])], -1)
    M = M + 1e-6 * torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return cho_solve_unrolled(M, rhs)


def integrate(base_pos, base_quat, joint_pos, base_lin_vel, base_ang_vel, joint_vel,
              udot, dt: float, joint_vel_limit: Optional[torch.Tensor] = None):
    """Semi-implicit Euler: velocities first, then positions with the new
    velocities.  Base velocities are clamped to ±100, joint velocities to
    ``min(joint_vel_limit, 500)`` (URDFs without a limit extract as 1e9), or
    to ±500 without a limit.  The quaternion advances by the exp map of the
    world angular velocity."""
    v = torch.clamp(base_lin_vel + dt * udot[:, 0:3], -100.0, 100.0)
    w = torch.clamp(base_ang_vel + dt * udot[:, 3:6], -100.0, 100.0)
    thd = joint_vel + dt * udot[:, 6:]
    if joint_vel_limit is None:
        thd = torch.clamp(thd, -500.0, 500.0)
    else:
        vlim = joint_vel_limit.clamp(max=500.0)
        thd = torch.minimum(torch.maximum(thd, -vlim), vlim)
    pos = base_pos + dt * v
    wn = torch.linalg.norm(w, dim=-1)
    axis = w / wn.clamp(min=1e-9)[:, None]
    quat = quat_mul(quat_from_axis_angle(axis, wn * dt), base_quat)
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True).clamp(min=1e-9)
    th = joint_pos + dt * thd
    return pos, quat, th, v, w, thd
