"""RobotModel from the committed JSON morphologies (port of
``physics/serialize.py``).  The port reads the JSON files of the JAX package
in place (``extended_legged_gym_tpu/robots/data/*.json``)."""
from __future__ import annotations

import json

import numpy as np

from .model import RobotModel

_ARRAY_FIELDS = [
    "joint_origin_rot", "joint_origin_pos", "joint_axis", "mass", "com",
    "inertia", "armature", "dof_pos_limits", "dof_vel_limits", "torque_limits",
    "default_dof_pos", "geom_body", "geom_offset", "geom_radius", "foot_body",
    "foot_offset", "foot_radius", "foot_geom", "ancestor_mask", "base_init_height",
]
_INT_FIELDS = {"geom_body", "foot_body", "foot_geom"}
_STATIC_FIELDS = ["nb", "nj", "body_names", "joint_names", "parent", "joint_types",
                  "fix_base", "geom_links", "foot_names"]


def model_from_json(text: str) -> RobotModel:
    d = json.loads(text)
    kwargs = {}
    for f in _STATIC_FIELDS:
        v = d[f]
        kwargs[f] = tuple(v) if isinstance(v, list) else v
    for f in _ARRAY_FIELDS:
        dtype = np.int32 if f in _INT_FIELDS else np.float32
        kwargs[f] = np.asarray(np.array(d[f]), dtype=dtype)
    if kwargs["foot_offset"].size == 0:
        kwargs["foot_offset"] = np.zeros((0, 3), np.float32)
    return RobotModel(**kwargs)


def load_model(path: str) -> RobotModel:
    with open(path) as f:
        return model_from_json(f.read())
