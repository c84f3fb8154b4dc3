"""Articulated rigid-body model (port of ``physics/model.py``).

A :class:`RobotModel` describes one robot morphology with host numpy arrays.
All environments share one model; per-env randomization (friction, added base
mass) is carried separately.  :meth:`RobotModel.torch` gives float32/int64
tensor copies on a device, cached per device.

Conventions (as in the JAX package):
* bodies are topologically sorted; body 0 is the floating base;
* body ``i > 0`` hangs from ``parent[i]`` by a revolute (or prismatic,
  ``joint_types``) joint with axis ``joint_axis[i]`` in the child frame;
  ``joint_origin_*`` place the joint frame in the parent frame;
* ``q = [pos(3), quat(4, xyzw), θ(nj)]``, ``qd = [v_world(3), ω_world(3), θ̇(nj)]``;
* collision geometry is a set of spheres attached to bodies.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

_INT_ARRAYS = ("geom_body", "foot_body", "foot_geom")


@dataclass
class RobotModel:
    # --- topology ---
    nb: int
    nj: int
    body_names: Tuple[str, ...]
    joint_names: Tuple[str, ...]
    parent: Tuple[int, ...]
    joint_types: Tuple[str, ...]
    fix_base: bool
    geom_links: Tuple[str, ...]
    foot_names: Tuple[str, ...]
    # --- kinematics ---
    joint_origin_rot: np.ndarray   # [nb, 3, 3]
    joint_origin_pos: np.ndarray   # [nb, 3]
    joint_axis: np.ndarray         # [nb, 3] (row 0 unused)
    # --- inertial ---
    mass: np.ndarray               # [nb]
    com: np.ndarray                # [nb, 3]
    inertia: np.ndarray            # [nb, 3, 3]
    armature: np.ndarray           # [nj]
    # --- joint limits ---
    dof_pos_limits: np.ndarray     # [nj, 2]
    dof_vel_limits: np.ndarray     # [nj]
    torque_limits: np.ndarray      # [nj]
    default_dof_pos: np.ndarray    # [nj]
    # --- collision spheres ---
    geom_body: np.ndarray          # [ng] int32
    geom_offset: np.ndarray        # [ng, 3]
    geom_radius: np.ndarray        # [ng]
    # --- feet ---
    foot_body: np.ndarray          # [nf] int32
    foot_offset: np.ndarray        # [nf, 3]
    foot_radius: np.ndarray        # [nf]
    foot_geom: np.ndarray          # [nf] int32
    ancestor_mask: np.ndarray      # [nb, nj]
    base_init_height: np.ndarray   # scalar
    _tensors: Dict[str, Dict[str, torch.Tensor]] = field(
        default_factory=dict, repr=False, compare=False)

    @property
    def ng(self) -> int:
        return int(self.geom_radius.shape[0])

    @property
    def has_prismatic(self) -> bool:
        return "prismatic" in self.joint_types

    @property
    def nv(self) -> int:
        return 6 + self.nj

    @property
    def nq(self) -> int:
        return 7 + self.nj

    @property
    def num_feet(self) -> int:
        return int(self.foot_body.shape[0])

    def torch(self, device, float_dtype=torch.float32) -> Dict[str, torch.Tensor]:
        """Tensor copies of the array fields on ``device`` (cached), the
        floating-point ones as ``float_dtype``."""
        key = f"{torch.device(device)}/{float_dtype}"
        if key not in self._tensors:
            out = {}
            for f in dataclasses.fields(self):
                v = getattr(self, f.name)
                if isinstance(v, np.ndarray):
                    dtype = torch.int64 if f.name in _INT_ARRAYS else float_dtype
                    out[f.name] = torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
            self._tensors[key] = out
        return self._tensors[key]


def geom_indices_matching(model: RobotModel, patterns) -> np.ndarray:
    """Geom indices whose source link name contains any pattern (the
    penalized and termination contact sets)."""
    if isinstance(patterns, str):
        patterns = [patterns]
    return np.array([i for i, n in enumerate(model.geom_links)
                     if any(p in n for p in patterns)], dtype=np.int32)


def body_indices_matching(model: RobotModel, patterns) -> np.ndarray:
    """Body indices whose name contains any pattern (the SDF query bodies)."""
    if isinstance(patterns, str):
        patterns = [patterns]
    return np.array([i for i, n in enumerate(model.body_names)
                     if any(p in n for p in patterns)], dtype=np.int64)


def _axis_angle_matrix(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues rotation matrix (host numpy)."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / max(np.linalg.norm(a), 1e-12)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def host_forward_kinematics(model: RobotModel, joint_pos=None):
    """Body poses in the base frame at a joint configuration (default: the
    default pose), in host numpy: ``(body_rot [nb, 3, 3], body_pos [nb, 3])``
    in float32, body 0 the identity."""
    q = np.asarray(model.default_dof_pos if joint_pos is None else joint_pos, dtype=np.float64)
    R = [np.eye(3)] * model.nb
    p = [np.zeros(3)] * model.nb
    for i in range(1, model.nb):
        par = model.parent[i]
        Rj = np.asarray(model.joint_origin_rot[i], dtype=np.float64)
        pj = np.asarray(model.joint_origin_pos[i], dtype=np.float64)
        axis = np.asarray(model.joint_axis[i], dtype=np.float64)
        if model.joint_types[i - 1] == "prismatic":
            Rq, pq = np.eye(3), axis * q[i - 1]
        else:
            Rq, pq = _axis_angle_matrix(axis, q[i - 1]), np.zeros(3)
        R[i] = R[par] @ Rj @ Rq
        p[i] = p[par] + R[par] @ pj + R[par] @ Rj @ pq
    return np.stack(R).astype(np.float32), np.stack(p).astype(np.float32)


def composite_rigid_body(model: RobotModel, joint_pos=None):
    """The whole robot at a fixed joint configuration lumped into one rigid
    body about the base origin: ``(total mass, composite inertia [3, 3] about
    the composite COM, COM [3], geom offsets in the base frame [ng, 3])``
    (the pose-adapt task's robot: joints frozen, gravity off)."""
    R, p = host_forward_kinematics(model, joint_pos)
    mass = np.asarray(model.mass, dtype=np.float64)
    com_b = np.asarray(model.com, dtype=np.float64)
    I_b = np.asarray(model.inertia, dtype=np.float64)
    total = float(mass.sum())
    coms_base = p + np.einsum("bij,bj->bi", R, com_b)
    com = (mass[:, None] * coms_base).sum(0) / max(total, 1e-9)
    I = np.zeros((3, 3))
    for i in range(model.nb):
        r = coms_base[i] - com
        I += R[i] @ I_b[i] @ R[i].T + mass[i] * ((r @ r) * np.eye(3) - np.outer(r, r))
    gb = np.asarray(model.geom_body)
    geom_off = p[gb] + np.einsum("gij,gj->gi", R[gb], np.asarray(model.geom_offset, np.float64))
    return total, I.astype(np.float32), com.astype(np.float32), geom_off.astype(np.float32)
