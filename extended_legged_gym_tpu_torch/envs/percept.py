"""Perception-augmented sampling-MPC environment (port of ``envs/percept.py``).

Adds ray and SDF channels to the observation and per-body SDF queries for
collision-avoidance costs: the ray channels are the normalized inverse
distances of the env's ray caster (``raycaster.enable_raycast``), the SDF
channels the clipped signed distance (over ``sdf.max_distance``) and its
gradient at each ``sdf.query_bodies`` body origin (forward kinematics).
The channels follow the base observation and the whole is cut or
zero-padded to ``env.num_observations``.  As in the JAX package, a config
with ``raycaster.attach_to_obs`` casts its rays twice per observation: once
in the base observation and once here (the second copy is usually cut).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..perception.sdf import SDFResult, query_sdf
from ..physics.dynamics import forward_kinematics
from ..physics.model import body_indices_matching
from ..utils.config import configclass
from .batch_rollout import RobotTrajGradSampling, RobotTrajGradSamplingCfg


@configclass
class SdfCfg:
    enable_sdf: bool = False
    max_distance: float = 10.0
    query_bodies: list = ["base"]
    compute_gradients: bool = True
    compute_nearest_points: bool = True
    include_in_obs: bool = True


@configclass
class RobotPerceptCfg(RobotTrajGradSamplingCfg):
    sdf: SdfCfg = SdfCfg()


class RobotBatchRolloutPercept(RobotTrajGradSampling):
    """Ray and SDF observation channels, per-body SDF queries and the
    ``sdf_clearance`` reward term."""

    def __init__(self, cfg: RobotPerceptCfg, **kw):
        super().__init__(cfg, **kw)
        bodies = (body_indices_matching(self.model, cfg.sdf.query_bodies)
                  if cfg.sdf.enable_sdf else [])
        self.sdf_bodies = torch.as_tensor(bodies, dtype=torch.int64, device=self.device)

    def raycast_obs(self, state) -> torch.Tensor:
        """Normalized inverse-distance rays [B, R] (width 0 without a caster)."""
        if self.raycaster is None:
            return torch.zeros(state.phys.base_pos.shape[0], 0, device=self.device)
        return self.raycaster.observations(state.phys.base_pos, state.phys.base_quat)

    def sdf_query_bodies(self, state) -> Optional[SDFResult]:
        """SDF, gradient and nearest point at the query bodies' origins
        [B, nq], the distance clipped to ``sdf.max_distance``; ``None``
        without query bodies."""
        if not len(self.sdf_bodies):
            return None
        p = state.phys
        kin = forward_kinematics(self.model, p.base_pos, p.base_quat, p.joint_pos,
                                 p.base_lin_vel, p.base_ang_vel, p.joint_vel)
        res = query_sdf(self.terrain, kin.body_pos[:, self.sdf_bodies])
        max_d = self.cfg.sdf.max_distance
        return res._replace(sdf=res.sdf.clamp(-max_d, max_d))

    def sdf_obs(self, state) -> torch.Tensor:
        res = self.sdf_query_bodies(state)
        if res is None:
            return torch.zeros(state.phys.base_pos.shape[0], 0, device=self.device)
        parts = [res.sdf / self.cfg.sdf.max_distance]
        if self.cfg.sdf.compute_gradients:
            parts.append(res.gradient.reshape(res.gradient.shape[0], -1))
        return torch.cat(parts, dim=-1)

    def _compute_observations(self, state) -> torch.Tensor:
        base = super()._compute_observations(state)
        extras = []
        if self.raycaster is not None:
            extras.append(self.raycast_obs(state))
        if self.cfg.sdf.enable_sdf and self.cfg.sdf.include_in_obs:
            extras.append(self.sdf_obs(state))
        if not extras:
            return base
        obs, n = torch.cat([base] + extras, dim=-1), self.num_obs
        return obs[:, :n] if obs.shape[-1] >= n else F.pad(obs, (0, n - obs.shape[-1]))

    def _reward_sdf_clearance(self, s, ctx):
        res = self.sdf_query_bodies(s)
        if res is None:
            return torch.zeros(s.phys.base_pos.shape[0], device=self.device)
        return -torch.sum((-res.sdf).clamp(0.0, 1.0), dim=-1)
