"""Robot tables of the plain reference, read from the robot's committed JSON.

The JSON file is raw input that the program reads too; everything the
reference needs beyond it (gains, the foot order, the tensors) it works out
here itself."""
from __future__ import annotations

import json
from typing import Dict, List

import numpy as np
import torch

ARRAY_FIELDS = (
    "joint_origin_rot", "joint_origin_pos", "joint_axis", "mass", "com", "inertia", "armature",
    "dof_pos_limits", "dof_vel_limits", "torque_limits", "default_dof_pos", "geom_body",
    "geom_offset", "geom_radius", "foot_body", "foot_offset", "foot_radius", "foot_geom")
INT_FIELDS = ("geom_body", "foot_body", "foot_geom")


class Robot:
    """The tables of one articulated robot: topology, inertia, limits and
    collision spheres, as numpy arrays and as tensors per device."""

    def __init__(self, path: str):
        with open(path) as f:
            d = json.load(f)
        self.nb, self.nj = int(d["nb"]), int(d["nj"])
        self.parent: List[int] = [int(p) for p in d["parent"]]
        self.joint_types: List[str] = list(d["joint_types"])
        self.joint_names: List[str] = list(d["joint_names"])
        self.fix_base = bool(d["fix_base"])
        self.geom_links: List[str] = list(d["geom_links"])
        self.foot_names: List[str] = list(d["foot_names"])
        self.arrays = {k: np.asarray(np.array(d[k]), dtype=np.int32 if k in INT_FIELDS
                                     else np.float32) for k in ARRAY_FIELDS}
        if any(t != "revolute" for t in self.joint_types):
            raise ValueError("the reference step takes revolute joints only")
        self._cache: Dict[str, Dict[str, torch.Tensor]] = {}

    @property
    def ng(self) -> int:
        return int(self.arrays["geom_radius"].shape[0])

    def foot_geoms(self) -> List[int]:
        """The geom of each foot, in sorted foot-name order."""
        sites = {src: gi for gi, src in enumerate(self.geom_links) if src in self.foot_names}
        return [sites[n] for n in sorted(sites)]

    @property
    def nf(self) -> int:
        return len(self.foot_geoms())

    def geoms_matching(self, patterns) -> List[int]:
        return [i for i, n in enumerate(self.geom_links) if any(p in n for p in patterns)]

    def gains(self, stiffness: Dict[str, float], damping: Dict[str, float]):
        """PD gains per joint, by substring match of the joint names."""
        p = np.zeros(self.nj, np.float32)
        d = np.zeros(self.nj, np.float32)
        for i, name in enumerate(self.joint_names):
            for k, v in stiffness.items():
                if k in name:
                    p[i] = v
            for k, v in damping.items():
                if k in name:
                    d[i] = v
        return p, d

    def tensors(self, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
        key = f"{torch.device(device)}/{dtype}"
        if key not in self._cache:
            self._cache[key] = {
                k: torch.as_tensor(v, dtype=torch.int64 if k in INT_FIELDS else dtype,
                                   device=device) for k, v in self.arrays.items()}
        return self._cache[key]
