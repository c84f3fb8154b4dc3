"""Kinematic-planning trajectory optimization (port of ``envs/plan_grad.py``):
no physics.

The actions are state velocities ``[v_body(3), ω_body(3), q̇(nj)]``, clipped
to ``planning.max_*``; a rollout integrates them kinematically (Euler, or
the linear velocity turned by the half-step orientation under "rk4"; the
orientation by the exponential map) with the control step capped at
``max_integration_step``, and scores each step with a planning reward:
command tracking, base height above the terrain, joint limits and
smoothness.  The main env's step integrates the same way, so nothing on
this env's path calls a physics step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..terrain.heightfield import sample_height
from ..utils.config import configclass
from ..utils.math import quat_integrate, quat_rotate
from .batch_rollout import RobotTrajGradSampling, RobotTrajGradSamplingCfg


@configclass
class PlanningCfg:
    state_vel_dim: int = 18          # 3 lin + 3 ang + num_dof
    integration_method: str = "euler"  # euler | rk4
    max_lin_vel: float = 1.5
    max_ang_vel: float = 2.0
    max_joint_vel: float = 6.0
    max_integration_step: float = 0.05


@configclass
class RobotPlanGradSamplingCfg(RobotTrajGradSamplingCfg):
    planning: PlanningCfg = PlanningCfg()


class RobotPlanGradSampling(RobotTrajGradSampling):
    """State-velocity planning: kinematic rollouts and a kinematic main
    step."""

    def _clip_velocities(self, u: torch.Tensor) -> torch.Tensor:
        p = self.cfg.planning
        return torch.cat([u[..., 0:3].clamp(-p.max_lin_vel, p.max_lin_vel),
                          u[..., 3:6].clamp(-p.max_ang_vel, p.max_ang_vel),
                          u[..., 6:].clamp(-p.max_joint_vel, p.max_joint_vel)], dim=-1)

    def _integrate(self, pos, quat, joint_pos, u, dt):
        """One kinematic step with base-frame velocities ``u``."""
        u = self._clip_velocities(u)
        v_w = quat_rotate(quat, u[..., 0:3])
        w_w = quat_rotate(quat, u[..., 3:6])
        if self.cfg.planning.integration_method == "rk4":
            v_w = quat_rotate(quat_integrate(quat, w_w, dt / 2), u[..., 0:3])
        return pos + v_w * dt, quat_integrate(quat, w_w, dt), joint_pos + u[..., 6:] * dt

    def rollout_batch(self, state, all_us: torch.Tensor) -> torch.Tensor:
        """Per-step planning rewards [E, S, H+1] of the state-velocity
        sequences ``all_us`` [E, S, H+1, 6+nj]."""
        E, S, H1, D = all_us.shape
        dt = min(self.dt, self.cfg.planning.max_integration_step)
        rep = lambda x: x.repeat_interleave(S, dim=0)
        p = state.phys
        pos, quat, jp = rep(p.base_pos), rep(p.base_quat), rep(p.joint_pos)
        cmd = rep(state.commands)
        us = all_us.reshape(E * S, H1, D)
        rews = []
        for t in range(H1):
            pos, quat, jp = self._integrate(pos, quat, jp, us[:, t], dt)
            rews.append(self._plan_reward(pos, quat, jp, us[:, t], cmd))
        return torch.stack(rews, dim=1).reshape(E, S, H1)

    def _plan_reward(self, pos, quat, joint_pos, u, commands) -> torch.Tensor:
        u = self._clip_velocities(u)
        rew = -torch.sum(torch.square(u[:, 0:2] - commands[:, 0:2]), dim=-1)
        rew = rew - torch.square(u[:, 5] - commands[:, 2])
        ground = sample_height(self.terrain, pos[:, :2])
        rew = rew - 2.0 * torch.square(pos[:, 2] - ground - self.cfg.rewards.base_height_target)
        lo = (joint_pos - self.dof_pos_soft_limits[:, 0]).clamp(max=0.0)
        hi = (joint_pos - self.dof_pos_soft_limits[:, 1]).clamp(min=0.0)
        rew = rew - torch.sum(torch.square(lo) + torch.square(hi), dim=-1)
        return rew - 0.01 * torch.sum(torch.square(u), dim=-1)

    def apply_plan_step(self, state, u: torch.Tensor):
        """Advance the main envs kinematically by one control step."""
        p = state.phys
        pos, quat, jp = self._integrate(p.base_pos, p.base_quat, p.joint_pos, u, self.dt)
        state = state.replace(phys=p.replace(base_pos=pos, base_quat=quat, joint_pos=jp),
                              episode_length=state.episode_length + 1)
        return self._refresh_derived(state)

    def step(self, state, actions: torch.Tensor):
        """The main step is kinematic too: the actions are state velocities."""
        state = self.apply_plan_step(state, actions)
        p = state.phys
        rew = self._plan_reward(p.base_pos, p.base_quat, p.joint_pos, actions, state.commands)
        clip = self.cfg.normalization.clip_observations
        return state.replace(rew=rew, actions=actions,
                             obs=self._compute_observations(state).clamp(-clip, clip))

    def _compute_observations(self, state) -> torch.Tensor:
        """Pose, joints, commands and projected gravity, cut or zero-padded
        to ``env.num_observations``."""
        p = state.phys
        obs = torch.cat([p.base_pos, p.base_quat, p.joint_pos - self.default_dof_pos,
                         state.commands[:, :3], state.projected_gravity], dim=-1)
        n = self.num_obs
        return obs[:, :n] if obs.shape[-1] >= n else F.pad(obs, (0, n - obs.shape[-1]))
