"""Plain reference of one control step of a legged robot: PD torques and
``decimation`` semi-implicit Euler substeps of the Articulated-Body Algorithm
(Featherstone, RBDA Table 7.1) with sphere-vs-terrain penalty contacts on a
flat plane or a bilinear heightfield.

A frozen copy, in plain PyTorch, of the equations the port's fused physics
kernels (B1 flat, B2 heightfield) compute: body-local spatial vectors
``[angular; linear]``; each active contact's spatial damper ``dt * Ds`` folded
into its body's articulated inertia (implicit damping) and the explicit force
``f_el - D v`` into its bias force; gravity as explicit per-body forces; the
6x6 base block solved by an unrolled Cholesky; velocities integrated first,
then positions, the quaternion by the exp map of the world angular velocity.

A state is a dict of ``[B, ...]`` tensors: ``base_pos``, ``base_quat``
(xyzw), ``joint_pos``, ``base_lin_vel`` and ``base_ang_vel`` (world),
``joint_vel``, ``contact_anchor`` ``[B, ng, 2]`` (stiction anchors, world xy).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from .robot import Robot

STATE_KEYS = ("base_pos", "base_quat", "joint_pos", "base_lin_vel", "base_ang_vel", "joint_vel",
              "contact_anchor")


# ----------------------------------------------------------------- math
def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b)


def skew(v):
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_mul(a, b):
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw,
                        aw * bw - ax * bx - ay * by - az * bz], dim=-1)


def quat_rotate_inverse(q, v):
    xyz, w = q[..., :3], q[..., 3:4]
    t = 2.0 * cross(xyz, v)
    return v - w * t + cross(xyz, t)


def quat_to_matrix(q):
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
                     2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
                     2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _joint_rot(axis, angle):
    c = torch.cos(angle)[:, None, None]
    s = torch.sin(angle)[:, None, None]
    K = skew(axis)
    return torch.eye(3, dtype=angle.dtype, device=angle.device) + s * K + (1.0 - c) * (K @ K)


def _cross_motion(v, u):
    w, l = v[..., :3], v[..., 3:]
    return torch.cat([cross(w, u[..., :3]), cross(w, u[..., 3:]) + cross(l, u[..., :3])], -1)


def _cross_force(v, f):
    w, l = v[..., :3], v[..., 3:]
    return torch.cat([cross(w, f[..., :3]) + cross(l, f[..., 3:]), cross(w, f[..., 3:])], -1)


def _xmot(E, r, v):
    return torch.cat([_mv(E, v[..., :3]), _mv(E, v[..., 3:] - cross(r, v[..., :3]))], -1)


def _xforce_T(E, r, f):
    Et = E.transpose(-1, -2)
    fl = _mv(Et, f[..., 3:])
    return torch.cat([_mv(Et, f[..., :3]) + cross(r, fl), fl], -1)


def _xia_T(E, r, IA):
    z = torch.zeros_like(E)
    X = torch.cat([torch.cat([E, z], -1), torch.cat([-E @ skew(r), E], -1)], -2)
    return X.transpose(-1, -2) @ IA @ X


def _spatial_inertia(inertia, com, m):
    cx = skew(com)
    m = m[:, None, None]
    eye = torch.eye(3, dtype=cx.dtype, device=cx.device)
    top = torch.cat([inertia + m * (cx @ cx.T), m * cx], -1)
    bot = torch.cat([m * cx.T, m * eye], -1)
    return torch.cat([top, bot], -2)


def _cho_solve(A, b):
    """SPD solve by a Cholesky unrolled entry by entry (pivots floored at 1e-12)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        acc = A[..., j, j]
        for k in range(j):
            acc = acc - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(acc.clamp(min=1e-12))
        for i in range(j + 1, n):
            acc = A[..., i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            L[i][j] = acc / L[j][j]
    y = []
    for i in range(n):
        acc = b[..., i]
        for k in range(i):
            acc = acc - L[i][k] * y[k]
        y.append(acc / L[i][i])
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        for k in range(i + 1, n):
            acc = acc - L[k][i] * x[k]
        x[i] = acc / L[i][i]
    return torch.stack(x, -1)


# ----------------------------------------------------------------- ground
@dataclass
class Ground:
    """A flat plane at ``height00``, or a heightfield ``height[i, j]`` at world
    ``origin + (i, j) * hscale`` (its four bilinear corners packed per cell)."""

    height: np.ndarray
    hscale: float
    origin: Tuple[float, float]
    friction: float = 1.0

    def __post_init__(self):
        h = np.ascontiguousarray(self.height, dtype=np.float32)
        self.height = h
        self.is_flat = bool(np.ptp(h) < 1e-9)
        self.height00 = float(h[0, 0])
        f32 = lambda x: float(np.float32(x))
        self.hscale = f32(self.hscale)
        self.origin = (f32(self.origin[0]), f32(self.origin[1]))
        self.friction = f32(self.friction)
        self._tex: Dict[str, torch.Tensor] = {}

    @classmethod
    def plane(cls, height: float = 0.0, friction: float = 1.0) -> "Ground":
        return cls(np.full((2, 2), height, np.float32), 1.0, (0.0, 0.0), friction)

    def texture(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._tex:
            g = self.height
            packed = np.stack([g, np.roll(g, -1, 1), np.roll(g, -1, 0),
                               np.roll(np.roll(g, -1, 0), -1, 1)], axis=-1)
            self._tex[key] = torch.as_tensor(np.ascontiguousarray(packed.reshape(-1, 4)),
                                             device=device)
        return self._tex[key]

    def height_and_normal(self, xy):
        if self.is_flat:
            h = torch.full(xy.shape[:-1], self.height00, dtype=xy.dtype, device=xy.device)
            n = torch.zeros(xy.shape[:-1] + (3,), dtype=xy.dtype, device=xy.device)
            n[..., 2] = 1.0
            return h, n
        H, W = self.height.shape
        gx = ((xy[..., 0] - self.origin[0]) / self.hscale).clamp(0.0, H - 1.001)
        gy = ((xy[..., 1] - self.origin[1]) / self.hscale).clamp(0.0, W - 1.001)
        x0, y0 = torch.floor(gx), torch.floor(gy)
        base = (x0.to(torch.int64) * W + y0.to(torch.int64)).clamp(0, H * W - 1)
        rows = self.texture(xy.device).to(xy.dtype)[base]
        h00, h10, h01, h11 = rows[..., 0], rows[..., 2], rows[..., 1], rows[..., 3]
        fx, fy = gx - x0, gy - y0
        h = h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy) + h01 * (1 - fx) * fy + h11 * fx * fy
        dhdx = ((h10 - h00) * (1 - fy) + (h11 - h01) * fy) / self.hscale
        dhdy = ((h01 - h00) * (1 - fx) + (h11 - h10) * fx) / self.hscale
        n = torch.stack([-dhdx, -dhdy, torch.ones_like(h)], dim=-1)
        return h, n / torch.linalg.norm(n, dim=-1, keepdim=True)


# ----------------------------------------------------------------- the step
@dataclass
class StepParams:
    dt: float
    gravity: Tuple[float, float, float]
    kp: float
    kd: float
    kt: float
    kt_spring: float
    mu: float
    joint_damping: float
    decimation: int
    action_scale: float
    enforce_dof_vel_limits: bool = True

    @classmethod
    def from_config(cls, c: dict) -> "StepParams":
        sim, ctl = c["sim"], c["control"]
        return cls(dt=sim["dt"], gravity=tuple(sim["gravity"]), kp=sim["contact_kp"],
                   kd=sim["contact_kd"], kt=sim["contact_kt"], kt_spring=sim["contact_kt_spring"],
                   mu=1.0, joint_damping=sim["joint_damping"], decimation=ctl["decimation"],
                   action_scale=ctl["action_scale"],
                   enforce_dof_vel_limits=sim["enforce_dof_vel_limits"])


def _contact(ground: Ground, sp: StepParams, pos, vel, radius, anchor, mu):
    xy = pos[..., :2]
    h, n = ground.height_and_normal(xy)
    depth = (h + radius) - pos[..., 2]
    active = (depth > 0.0).to(pos.dtype)
    depth_a = torch.minimum(depth.clamp(min=0.0), 2.0 * radius + 0.05)
    vn = torch.sum(vel * n, dim=-1)
    vt = vel - vn[..., None] * n
    vt_norm = torch.linalg.norm(vt, dim=-1)
    fn_el = sp.kp * depth_a
    kd_g = torch.minimum(torch.full_like(fn_el, sp.kd), fn_el / vn.clamp(min=1e-6))
    fn_est = (fn_el - kd_g * vn).clamp(min=0.0) * active
    kt_eff = torch.minimum(torch.full_like(fn_el, sp.kt), mu * fn_est / vt_norm.clamp(min=1e-3))
    d_xy = xy - anchor
    d3 = torch.cat([d_xy, torch.zeros_like(d_xy[..., :1])], dim=-1)
    d_t = d3 - torch.sum(d3 * n, dim=-1, keepdim=True) * n
    dn = torch.linalg.norm(d_t, dim=-1)
    budget = (mu * fn_est - kt_eff * vt_norm).clamp(min=0.0)
    cf = torch.clamp(budget / (sp.kt_spring * dn).clamp(min=1e-9), max=1.0)
    f_spring = -sp.kt_spring * (cf * active)[..., None] * d_t
    f_el = fn_el[..., None] * n * active[..., None] + f_spring
    new_anchor = torch.where(active[..., None] > 0.0, xy - cf[..., None] * d_xy, xy)
    kt = kt_eff * active
    kdk = (kd_g - kt_eff) * active

    def apply_D(v):
        vn_ = torch.sum(v * n, dim=-1, keepdim=True)
        return kt[..., None] * v + kdk[..., None] * vn_ * n

    return f_el, n, kt, kdk, depth, new_anchor, apply_D


def aba_substep(robot: Robot, ground: Ground, sp: StepParams, s: Dict[str, torch.Tensor],
                tau_in, friction_scale, mass_delta):
    """One ABA substep: ``(new_state, (geom_forces, foot_pos, foot_vel))``."""
    dev, dt, ft = s["base_pos"].device, sp.dt, s["base_pos"].dtype
    T = robot.tensors(dev, ft)
    nb = robot.nb
    B = s["base_pos"].shape[0]
    mass = T["mass"].expand(B, nb).clone()
    mass[:, 0] += mass_delta
    gb, goff = T["geom_body"], T["geom_offset"]

    R_w, p_w, XE, Xr, S, v, c_bias = ([None] * nb for _ in range(7))
    R0 = quat_to_matrix(s["base_quat"])
    R_w[0], p_w[0] = R0, s["base_pos"]
    w_b = _mv(R0.transpose(-1, -2), s["base_ang_vel"])
    v_b = _mv(R0.transpose(-1, -2), s["base_lin_vel"])
    v[0] = torch.cat([w_b, v_b], -1)
    zeros3 = torch.zeros(3, dtype=ft, device=dev)
    for i in range(1, nb):
        par = robot.parent[i]
        axis, th = T["joint_axis"][i], s["joint_pos"][:, i - 1]
        Ej = T["joint_origin_rot"][i] @ _joint_rot(axis, th)
        r = T["joint_origin_pos"][i]
        S[i] = torch.cat([axis, zeros3])
        XE[i], Xr[i] = Ej.transpose(-1, -2), r
        R_w[i] = R_w[par] @ Ej
        p_w[i] = p_w[par] + _mv(R_w[par], r.expand(B, 3))
        vJ = S[i] * s["joint_vel"][:, i - 1, None]
        v[i] = _xmot(XE[i], r, v[par]) + vJ
        c_bias[i] = _cross_motion(v[i], vJ)

    Rg = torch.stack(R_w, 1)[:, gb]
    vg = torch.stack(v, 1)[:, gb]
    g_pos = torch.stack(p_w, 1)[:, gb] + _mv(Rg, goff.expand(B, -1, -1))
    g_vel = _mv(Rg, vg[..., 3:] + cross(vg[..., :3], goff))
    mu = sp.mu * ground.friction * friction_scale[:, None]
    f_el, n, kt, kdk, depth, anchor, apply_D = _contact(
        ground, sp, g_pos, g_vel, T["geom_radius"], s["contact_anchor"], mu)
    f_expl = f_el - apply_D(g_vel)

    IA = [_spatial_inertia(T["inertia"][i], T["com"][i], mass[:, i]) for i in range(nb)]
    pA = [_cross_force(v[i], _mv(IA[i], v[i])) for i in range(nb)]
    RgT = Rg.transpose(-1, -2)
    f_b = _mv(RgT, f_expl)
    F_sp = torch.cat([cross(goff, f_b), f_b], -1)
    n_b = _mv(RgT, n)
    eye3 = torch.eye(3, dtype=ft, device=dev)
    Db = kt[..., None, None] * eye3 + kdk[..., None, None] * n_b[..., :, None] * n_b[..., None, :]
    rx = skew(goff)
    rxD = rx @ Db
    Ds = torch.cat([torch.cat([rxD @ rx.transpose(-1, -2), rxD], -1),
                    torch.cat([rxD.transpose(-1, -2), Db], -1)], -2)
    F_body = torch.zeros(B, nb, 6, dtype=ft, device=dev).index_add_(1, gb, F_sp)
    Ds_body = torch.zeros(B, nb, 6, 6, dtype=ft, device=dev).index_add_(1, gb, Ds)
    g = torch.tensor(sp.gravity, dtype=ft, device=dev)
    for i in range(nb):
        f_g = mass[:, i, None] * _mv(R_w[i].transpose(-1, -2), g.expand(B, 3))
        pA[i] = pA[i] - F_body[:, i] - torch.cat([cross(T["com"][i], f_g), f_g], -1)
        IA[i] = IA[i] + dt * Ds_body[:, i]
    tau = tau_in - sp.joint_damping * s["joint_vel"]

    U, d_inv, u = [None] * nb, [None] * nb, [None] * nb
    for i in range(nb - 1, 0, -1):
        par, r = robot.parent[i], Xr[i]
        U[i] = _mv(IA[i], S[i].expand(B, 6))
        d_inv[i] = 1.0 / (U[i] @ S[i] + T["armature"][i - 1] + dt * sp.joint_damping)
        u[i] = tau[:, i - 1] - pA[i] @ S[i]
        Ia = IA[i] - U[i][:, :, None] * U[i][:, None, :] * d_inv[i][:, None, None]
        pa = pA[i] + _mv(Ia, c_bias[i]) + U[i] * (u[i] * d_inv[i])[:, None]
        IA[par] = IA[par] + _xia_T(XE[i], r, Ia)
        pA[par] = pA[par] + _xforce_T(XE[i], r, pa)

    if robot.fix_base:
        a0 = base_acc = torch.zeros(B, 6, dtype=ft, device=dev)
    else:
        a0 = _cho_solve(IA[0] + 1e-6 * torch.eye(6, dtype=ft, device=dev), -pA[0])
        a_cl = a0[:, 3:] + cross(w_b, v_b)
        base_acc = torch.cat([_mv(R0, a_cl), _mv(R0, a0[:, :3])], -1)
    a, qdd = [a0] + [None] * (nb - 1), []
    for i in range(1, nb):
        a_i = _xmot(XE[i], Xr[i], a[robot.parent[i]]) + c_bias[i]
        qdd_i = (u[i] - (U[i] * a_i).sum(-1)) * d_inv[i]
        a[i] = a_i + S[i] * qdd_i[:, None]
        qdd.append(qdd_i)
    udot = torch.cat([base_acc, torch.stack(qdd, -1)], -1)

    # semi-implicit Euler
    lin = torch.clamp(s["base_lin_vel"] + dt * udot[:, 0:3], -100.0, 100.0)
    ang = torch.clamp(s["base_ang_vel"] + dt * udot[:, 3:6], -100.0, 100.0)
    thd = s["joint_vel"] + dt * udot[:, 6:]
    if sp.enforce_dof_vel_limits:
        vlim = T["dof_vel_limits"].clamp(max=500.0)
        thd = torch.minimum(torch.maximum(thd, -vlim), vlim)
    else:
        thd = torch.clamp(thd, -500.0, 500.0)
    pos = s["base_pos"] + dt * lin
    wn = torch.linalg.norm(ang, dim=-1)
    axis = ang / wn.clamp(min=1e-9)[:, None]
    half = 0.5 * (wn * dt)[..., None]
    dq = torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)
    quat = quat_mul(dq, s["base_quat"])
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True).clamp(min=1e-9)
    th = s["joint_pos"] + dt * thd
    new = dict(base_pos=pos, base_quat=quat, joint_pos=th, base_lin_vel=lin, base_ang_vel=ang,
               joint_vel=thd, contact_anchor=anchor)

    ag = torch.stack(a, 1)[:, gb]
    w_g, vl_g = vg[..., :3], vg[..., 3:]
    a_pt = (ag[..., 3:] + cross(w_g, vl_g) + cross(ag[..., :3], goff)
            + cross(w_g, cross(w_g, goff)))
    g_vel_new = g_vel + dt * _mv(Rg, a_pt)
    geom_forces = f_el - apply_D(g_vel_new)
    geom_forces = geom_forces * (depth > 0.0).to(geom_forces.dtype)[..., None]

    fg = robot.foot_geoms()
    fb = gb[fg]
    Rf = torch.stack(R_w, 1)[:, fb]
    vf = torch.stack(v, 1)[:, fb]
    off = T["foot_offset"][: len(fg)]
    foot_pos = torch.stack(p_w, 1)[:, fb] + _mv(Rf, off.expand(B, -1, -1))
    foot_vel = _mv(Rf, vf[..., 3:] + cross(vf[..., :3], off))
    return new, (geom_forces, foot_pos, foot_vel)


class ControlStep:
    """One control step of B robots under PD control: torques
    ``kp (a * scale + q0 - q) - kd qd`` clamped to the torque limits, then
    ``decimation`` substeps, the torques recomputed before each."""

    def __init__(self, robot: Robot, ground: Ground, config: dict):
        self.robot, self.ground = robot, ground
        self.sp = StepParams.from_config(config)
        ctl = config["control"]
        self.p_gains, self.d_gains = robot.gains(ctl["stiffness"], ctl["damping"])

    def __call__(self, s: Dict[str, torch.Tensor], actions, friction_scale, mass_delta):
        """``(new_state, tau_last, geom_forces, foot_pos, foot_vel)``."""
        dev, ft = actions.device, actions.dtype
        T = self.robot.tensors(dev, ft)
        p = torch.as_tensor(self.p_gains, dtype=ft, device=dev)
        d = torch.as_tensor(self.d_gains, dtype=ft, device=dev)
        scaled = actions * self.sp.action_scale
        for _ in range(self.sp.decimation):
            tau = p * (scaled + T["default_dof_pos"] - s["joint_pos"]) - d * s["joint_vel"]
            tau = torch.maximum(torch.minimum(tau, T["torque_limits"]), -T["torque_limits"])
            s, report = aba_substep(self.robot, self.ground, self.sp, s, tau, friction_scale,
                                    mass_delta)
        return (s, tau) + tuple(report)
