"""ANYmal-C task variants (port of ``robots/anymal_c_variants.py``): load
adaptation, pose tracking, bipedal standing and the observation-history
student.

* :class:`LoadAdaptAnymal`: the orientation term aligns the base with the
  total (gravity + inertial) acceleration; the env keeps the EMA-filtered
  base-frame accelerations (factor 0.9, from the world root velocity's
  change over each control step) in the state.
* :class:`PoseAnymal`: 8-dim commands [vx, vy, wz, heading, base height,
  roll, pitch, 0]; the base env's 4 are widened with three more draws
  (``_draw_pose_commands``) and the terms track the commanded height and
  the orientation (commanded roll and pitch at the current yaw).
* :class:`StandAnymal`: hind feet grounded, front feet up, base pitched.
* :class:`AnymalStudent`: the actor reads the last 5 proprioceptive frames
  (5 x 48, noise on the newest only), shifted each step from the previous
  observation; the critic reads the 235-dim privileged observation, which
  is the base env's: the noise-free observation cut to 235, here the
  history shifted once more (as in the JAX env).
"""
from __future__ import annotations

import numpy as np
import torch

from ..envs.legged_robot import LeggedRobot
from ..envs.legged_robot_config import LeggedRobotCfg
from ..utils.math import quat_rotate_inverse, quat_yaw, ypr_to_quat
from .anymal_c import anymal_c_flat_cfg, anymal_c_rough_cfg


class LoadAdaptAnymal(LeggedRobot):
    """Load adaptation: the base should align with the total acceleration."""

    acc_ema = 0.9

    def reset_all(self, seed=None):
        state = super().reset_all(seed)
        z = lambda n: torch.zeros(self.num_envs, n, device=self.device)
        return state.replace(base_lin_acc=z(3), base_ang_acc=z(3), last_root_vel=z(6))

    def _post_physics_step(self, state):
        """The accelerations' EMA from the root velocity's change since the
        last step, before the step's rewards; the root velocity kept after
        the resets."""
        dv = (state.phys.base_lin_vel - state.last_root_vel[:, :3]) / self.dt
        dw = (state.phys.base_ang_vel - state.last_root_vel[:, 3:]) / self.dt
        q, a = state.phys.base_quat, self.acc_ema
        state = state.replace(
            base_lin_acc=state.base_lin_acc * a + (1 - a) * quat_rotate_inverse(q, dv),
            base_ang_acc=state.base_ang_acc * a + (1 - a) * quat_rotate_inverse(q, dw))
        state = super()._post_physics_step(state)
        return state.replace(last_root_vel=torch.cat([state.phys.base_lin_vel,
                                                      state.phys.base_ang_vel], dim=-1))

    def _reward_orientation(self, s, ctx):
        """The xy share of the total acceleration's direction in the base
        frame."""
        g = torch.tensor([0.0, 0.0, 9.81], device=self.device).expand_as(s.base_lin_acc)
        acc = s.base_lin_acc + quat_rotate_inverse(s.phys.base_quat, g)
        dirn = acc / torch.linalg.norm(acc, dim=-1, keepdim=True).clamp(min=1e-6)
        return torch.sum(torch.square(dirn[:, :2]), dim=1)


class PoseAnymal(LeggedRobot):
    """Pose tracking with 8-dim commands."""

    def _draw_pose_commands(self):
        """Base height in [0.35, 0.6), roll and pitch in [-0.3, 0.3): [B] each."""
        B = self.num_envs
        return (self._uniform((B,), 0.35, 0.6), self._uniform((B,), -0.3, 0.3),
                self._uniform((B,), -0.3, 0.3))

    def _sample_commands(self, commands, mask, lin_vel_x_range=None):
        base = super()._sample_commands(commands[:, :4], mask, lin_vel_x_range)
        h, roll, pitch = self._draw_pose_commands()
        new = torch.cat([base, torch.stack([h, roll, pitch, torch.zeros_like(h)], dim=-1)], dim=-1)
        if commands.shape[-1] != 8:
            return new
        return torch.where(mask[:, None], new, commands)

    def expected_quat(self, s):
        """The commanded orientation: roll and pitch from the commands at the
        base's current yaw."""
        return ypr_to_quat(quat_yaw(s.phys.base_quat), s.commands[:, 6], s.commands[:, 5])

    def _reward_pose_orientation(self, s, ctx):
        dot = torch.sum(self.expected_quat(s) * s.phys.base_quat, dim=-1).abs()
        return torch.square(dot.clamp(0.0, 1.0))

    def _reward_pose_height(self, s, ctx):
        return torch.exp(-torch.square(s.phys.base_pos[:, 2] - s.commands[:, 4]) / 0.02)


class StandAnymal(LeggedRobot):
    """Bipedal standing.  Foot order LF, LH, RF, RH: the hind feet are 1 and 3."""

    hind_feet = (1, 3)
    front_feet = (0, 2)

    def _reward_stand_pitch(self, s, ctx):
        """Gravity along -x in the base frame when standing up."""
        target = torch.tensor([-1.0, 0.0, 0.0], device=self.device)
        return -torch.sum(torch.square(s.projected_gravity - target), dim=1)

    def _reward_hind_contact(self, s, ctx):
        contact = s.geom_forces[:, self.feet_geoms, 2] > 1.0
        return contact[:, list(self.hind_feet)].to(torch.float32).sum(dim=1) / 2.0

    def _reward_front_up(self, s, ctx):
        fz = s.foot_positions[:, list(self.front_feet), 2]
        return torch.sum(torch.clamp(fz - 0.3, max=0.4), dim=1)


class AnymalStudent(LeggedRobot):
    """The observation-history student."""

    history_len = 5
    single_obs_dim = 48

    def __init__(self, cfg, **kw):
        super().__init__(cfg, **kw)
        if self.num_obs != self.single_obs_dim * self.history_len:
            raise ValueError(f"num_observations {self.num_obs}: the student reads "
                             f"{self.history_len} frames of {self.single_obs_dim}")

    def _compute_observations(self, state) -> torch.Tensor:
        """[h1 ... h5] -> [h2 ... h5 new]."""
        return torch.cat([state.obs[:, self.single_obs_dim:], self._proprio_obs(state)], dim=-1)

    def _make_noise_scale_vec(self) -> np.ndarray:
        """The base env's proprioceptive noise on the newest frame only
        (older frames carry the noise they had)."""
        vec = np.zeros(self.num_obs, np.float32)
        vec[-self.single_obs_dim:] = super()._make_noise_scale_vec()[:self.single_obs_dim]
        return vec


def anymal_c_student_cfg() -> LeggedRobotCfg:
    cfg = anymal_c_rough_cfg()
    cfg.env.num_observations = 48 * AnymalStudent.history_len
    cfg.env.num_privileged_obs = 235
    return cfg


def load_adapt_anymal_cfg() -> LeggedRobotCfg:
    """The flat task single-stage (each staged scale at its last value),
    orientation -5."""
    cfg = anymal_c_flat_cfg()
    cfg.rewards.multi_stage_rewards = False
    cfg.rewards.scales.orientation = -5.0
    return cfg


def pose_anymal_cfg() -> LeggedRobotCfg:
    cfg = anymal_c_flat_cfg()
    cfg.rewards.multi_stage_rewards = False
    cfg.commands.num_commands = 8
    sc = cfg.rewards.scales
    sc.pose_orientation = 1.0
    sc.pose_height = 1.0
    sc.tracking_ang_vel = 0.3
    return cfg


def stand_anymal_cfg() -> LeggedRobotCfg:
    cfg = anymal_c_flat_cfg()
    cfg.rewards.multi_stage_rewards = False
    cfg.rewards.only_positive_rewards = False
    sc = cfg.rewards.scales
    sc.tracking_lin_vel = 0.0
    sc.tracking_ang_vel = 0.0
    sc.feet_air_time = 0.0
    sc.orientation = 0.0
    sc.stand_pitch = 1.5
    sc.hind_contact = 1.0
    sc.front_up = 1.0
    return cfg
