"""Franka Panda arm: end-effector pose tracking on a fixed base (port of
``robots/franka.py``).  8 bodies, 7 revolute joints, one collision sphere on
the base, no feet; ``asset.fix_base_link`` makes every physics step run the
fixed-base regime of the fused kernel (zero base acceleration, no base
solve).  The robot model is read in place from the JAX package's committed
JSON.  Every env supports ``rollout_batch`` (``RobotBatchRollout``)."""
from __future__ import annotations

import os

import numpy as np
import torch

from ..envs.batch_rollout import RobotBatchRollout, RobotTrajGradSamplingCfg
from ..envs.legged_robot_config import LeggedRobotCfg, LeggedRobotCfgPPO
from ..physics.dynamics import forward_kinematics
from ..utils.math import matrix_to_quat
from .anymal_c import _DATA

FRANKA_DEFAULT_ANGLES = {
    "panda_joint1": 0.0, "panda_joint2": -0.785, "panda_joint3": 0.0,
    "panda_joint4": -2.356, "panda_joint5": 0.0, "panda_joint6": 1.571,
    "panda_joint7": 0.785,
}
# the reachable box the position targets are drawn from, and the target
# orientation (pointing down)
EE_TARGET_LO, EE_TARGET_HI = (0.3, -0.4, 0.2), (0.7, 0.4, 0.8)
EE_TARGET_QUAT = (0.0, 1.0, 0.0, 0.0)


class Franka(RobotBatchRollout):
    """Fixed-base arm: commands are end-effector pose targets [pos(3),
    quat(4)]; the end effector is the last body of the chain."""

    def _ee_state(self, phys):
        """End-effector world position, orientation (xyzw), linear and
        angular velocity, each ``[B, .]``."""
        kin = forward_kinematics(self.model, phys.base_pos, phys.base_quat, phys.joint_pos,
                                 phys.base_lin_vel, phys.base_ang_vel, phys.joint_vel)
        ee = self.model.nb - 1
        return (kin.body_pos[:, ee], matrix_to_quat(kin.body_rot[:, ee]),
                kin.v_origin[:, ee], kin.omega[:, ee])

    def _contact_context(self, s):
        """The base context and the end-effector state under ``"ee"``, so the
        three ``ee_*`` terms share one kinematics pass."""
        return dict(super()._contact_context(s), ee=self._ee_state(s.phys))

    def _draw_ee_targets(self) -> torch.Tensor:
        """Position targets [B, 3], uniform in the reachable box."""
        lo = torch.tensor(EE_TARGET_LO, device=self.device)
        hi = torch.tensor(EE_TARGET_HI, device=self.device)
        return self._uniform((self.num_envs, 3), lo, hi)

    def _sample_commands(self, commands, mask):
        """Pose targets for the masked envs (in place of the velocity
        commands of the locomotion base class)."""
        quat = torch.tensor(EE_TARGET_QUAT, device=self.device).expand(self.num_envs, 4)
        new = torch.cat([self._draw_ee_targets(), quat], dim=-1)
        if commands.shape[-1] != 7:
            commands = torch.zeros_like(new)
        return torch.where(mask[:, None], new, commands)

    def _compute_observations(self, state) -> torch.Tensor:
        os_ = self.cfg.normalization.obs_scales
        ee_pos, ee_quat, _, _ = self._ee_state(state.phys)
        obs = torch.cat([(state.phys.joint_pos - self.default_dof_pos) * os_.dof_pos,
                         state.phys.joint_vel * os_.dof_vel, ee_pos, ee_quat,
                         state.commands, state.actions], dim=-1)
        n = self.num_obs
        if obs.shape[-1] < n:
            obs = torch.nn.functional.pad(obs, (0, n - obs.shape[-1]))
        return obs[:, :n]

    def _make_noise_scale_vec(self):
        """No observation noise, as in the JAX env, whose observation ignores
        the noise key."""
        return np.zeros(self.num_obs, np.float32)

    # ---- arm rewards ----
    def _reward_ee_position_tracking(self, s, ctx):
        ee_pos, _, _, _ = ctx["ee"]
        err = torch.linalg.norm(ee_pos - s.commands[:, :3], dim=1)
        return torch.exp(-err / self.cfg.rewards.tracking_sigma)

    def _reward_ee_orientation_tracking(self, s, ctx):
        _, ee_quat, _, _ = ctx["ee"]
        err = torch.linalg.norm(ee_quat - s.commands[:, 3:7], dim=1)
        return torch.exp(-err / self.cfg.rewards.tracking_sigma)

    def _reward_ee_velocity(self, s, ctx):
        _, _, v, w = ctx["ee"]
        return torch.sum(torch.square(v), dim=1) + torch.sum(torch.square(w), dim=1)


def franka_cfg() -> LeggedRobotCfg:
    """1024 arms on a plane, P control with the Panda's gains, a fixed base,
    pose targets resampled every 4 s, the locomotion terms zeroed."""
    cfg = RobotTrajGradSamplingCfg()
    cfg.env.num_envs = 1024
    cfg.env.num_actions = 7
    cfg.env.num_observations = 7 + 7 + 7 + 7 + 7     # qpos qvel ee cmd actions
    cfg.env.episode_length_s = 8.0
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.measure_heights = False
    cfg.terrain.curriculum = False
    cfg.commands.num_commands = 7
    cfg.commands.resampling_time = 4.0
    cfg.init_state.pos = [0.0, 0.0, 0.0]
    cfg.init_state.default_joint_angles = dict(FRANKA_DEFAULT_ANGLES)
    cfg.control.stiffness = {"panda_joint1": 100.0, "panda_joint2": 100.0,
                             "panda_joint3": 100.0, "panda_joint4": 100.0,
                             "panda_joint5": 40.0, "panda_joint6": 40.0,
                             "panda_joint7": 40.0}
    cfg.control.damping = {"panda_joint1": 10.0, "panda_joint2": 10.0,
                           "panda_joint3": 10.0, "panda_joint4": 10.0,
                           "panda_joint5": 4.0, "panda_joint6": 4.0,
                           "panda_joint7": 4.0}
    cfg.control.action_scale = 0.5
    cfg.asset.file = os.path.join(_DATA, "franka.json")
    cfg.asset.name = "franka"
    cfg.asset.fix_base_link = True
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.randomize_friction = False
    cfg.rewards.only_positive_rewards = False
    sc = cfg.rewards.scales
    # the locomotion terms off
    sc.tracking_lin_vel = 0.0
    sc.tracking_ang_vel = 0.0
    sc.lin_vel_z = 0.0
    sc.ang_vel_xy = 0.0
    sc.feet_air_time = 0.0
    sc.collision = 0.0
    sc.dof_acc = -2.5e-7
    sc.action_rate = -0.01
    sc.torques = -1e-5
    sc.ee_position_tracking = 2.0
    sc.ee_orientation_tracking = 0.5
    sc.ee_velocity = -0.01
    return cfg


def franka_ppo_cfg() -> LeggedRobotCfgPPO:
    t = LeggedRobotCfgPPO()
    t.runner.experiment_name = "franka"
    return t
