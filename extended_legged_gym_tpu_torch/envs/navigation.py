"""Goal-navigation environment (port of ``envs/navigation.py``).

Every main env starts at ``navi_opt.start_pos`` (plus its origin's xy) at
rest in the default pose, and its commands come from a goal-seeking
P-controller instead of random resampling: the world-frame velocity
``kp_pos·(goal - pos)`` clipped to ``max_lin_vel`` and turned into the base
frame, a yaw rate toward the goal clipped to ``max_ang_vel``, zero inside
``tolerance_rad`` of the goal, smoothed against the previous command by
``cmd_smooth_factor``.
"""
from __future__ import annotations

import torch

from ..physics.engine import PhysState
from ..utils.config import configclass
from ..utils.math import quat_yaw, wrap_to_pi
from .batch_rollout import RobotTrajGradSampling, RobotTrajGradSamplingCfg


@configclass
class NaviOptCfg:
    start_pos: list = [0.0, 0.0, 0.5]
    start_quat: list = [0.0, 0.0, 0.0, 1.0]
    goal_pos: list = [5.0, 0.0, 0.5]
    tolerance_rad: float = 0.5
    kp_pos: float = 1.0
    kp_yaw: float = 1.0
    max_lin_vel: float = 1.0
    max_ang_vel: float = 1.0
    cmd_smooth_factor: float = 0.9


@configclass
class RobotNavCfg(RobotTrajGradSamplingCfg):
    navi_opt: NaviOptCfg = NaviOptCfg()


class RobotBatchRolloutNav(RobotTrajGradSampling):
    """The sampling-MPC env with goal-seeking commands."""

    def __init__(self, cfg: RobotNavCfg, **kw):
        super().__init__(cfg, **kw)
        nav = cfg.navi_opt
        t = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)
        self.goal_pos, self.start_pos, self.start_quat = (
            t(nav.goal_pos), t(nav.start_pos), t(nav.start_quat))
        self._xy = t([1.0, 1.0, 0.0])

    def _sample_init_phys(self, env_origins) -> PhysState:
        """The fixed start pose at rest (the base draws are made and
        overridden; the contact anchors stay where the base draw put
        them)."""
        phys = super()._sample_init_phys(env_origins)
        B = self.num_envs
        return phys.replace(base_pos=self.start_pos + env_origins * self._xy,
                            base_quat=self.start_quat.expand(B, 4).clone(),
                            base_lin_vel=torch.zeros_like(phys.base_lin_vel),
                            base_ang_vel=torch.zeros_like(phys.base_ang_vel),
                            joint_pos=self.default_dof_pos.expand_as(phys.joint_pos).clone(),
                            joint_vel=torch.zeros_like(phys.joint_vel))

    def _goal(self, state) -> torch.Tensor:
        return self.goal_pos + state.env_origins * self._xy

    def nav_commands(self, state) -> torch.Tensor:
        """Goal-seeking commands [B, 4] (vx, vy, yaw rate, 0), smoothed."""
        nav = self.cfg.navi_opt
        delta = self._goal(state)[:, :2] - state.phys.base_pos[:, :2]
        yaw = quat_yaw(state.phys.base_quat)
        v_des = nav.kp_pos * delta
        speed = torch.linalg.norm(v_des, dim=-1, keepdim=True).clamp(min=1e-6)
        v_des = v_des / speed * speed.clamp(max=nav.max_lin_vel)
        c, s = torch.cos(-yaw), torch.sin(-yaw)
        vx = c * v_des[:, 0] - s * v_des[:, 1]
        vy = s * v_des[:, 0] + c * v_des[:, 1]
        target_yaw = torch.atan2(delta[:, 1], delta[:, 0])
        wz = (nav.kp_yaw * wrap_to_pi(target_yaw - yaw)).clamp(-nav.max_ang_vel, nav.max_ang_vel)
        new = torch.stack([vx, vy, wz, torch.zeros_like(vx)], dim=-1)
        new = new * (~self.goal_reached(state))[:, None]
        a = nav.cmd_smooth_factor
        return a * state.commands + (1 - a) * new

    def goal_reached(self, state) -> torch.Tensor:
        dist = torch.linalg.norm(self._goal(state)[:, :2] - state.phys.base_pos[:, :2], dim=-1)
        return dist < self.cfg.navi_opt.tolerance_rad

    def step(self, state, actions: torch.Tensor):
        return super().step(state.replace(commands=self.nav_commands(state)), actions)
