"""Articulated rigid-body model (port of ``physics/model.py``).

A :class:`RobotModel` describes one robot morphology with host numpy arrays.
All environments share one model; per-env randomization (friction, added base
mass) is carried separately.  :meth:`RobotModel.torch` gives float32/int64
tensor copies on a device, cached per device.

Conventions (as in the JAX package):
* bodies are topologically sorted; body 0 is the floating base;
* body ``i > 0`` hangs from ``parent[i]`` by a revolute joint with axis
  ``joint_axis[i]`` in the child frame; ``joint_origin_*`` place the joint
  frame in the parent frame;
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
    def nv(self) -> int:
        return 6 + self.nj

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
