"""CyberDog2 bipedal-walk task family (port of ``robots/cyberdog2_walk.py``):
``cyber2_walk``, ``cyber2_hop`` and ``cyber2_bounce`` stand up on the rear
legs from a quadruped stance and walk, on the stand-dance env's rewards.

* a contact-target gait clock (per-foot phases, offsets and bounds,
  stance-duration warping, sinusoidal clock inputs for the policy, and
  desired contact states smoothed by normal-CDF windows);
* an observation of ``num_state_history`` stacked 47-dim frames, shifted by
  one frame per step (the newest last; noise only on the newest);
* random resets: joints within ±0.1 rad of the default, joint velocities
  and the root twist within ±0.1;
* no contact termination (time-outs only).

The three tasks share one config; the gait is the clock's row of the trot,
pronk or bound.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..envs.legged_robot_config import LeggedRobotCfg, LeggedRobotCfgPPO
from ..physics.engine import PhysState
from ..utils.math import quat_rotate_inverse
from .cyberdog2 import cyberdog2_walk_cfg
from .cyberdog2_standdance import CyberStandDanceEnv


def _normal_cdf(x: torch.Tensor, scale: float) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / (scale * math.sqrt(2.0))))


def contact_clock(t: torch.Tensor, freq: float, phases: float, offsets: float, bounds: float,
                  duration: float = 0.5, kappa: float = 0.07):
    """The gait clock at times ``t`` [B]: ``(foot_indices [B, 4] raw phases,
    clock_inputs [B, 4], desired_contact [B, 4])``, feet FL, FR, RL, RR.
    Raw phases [g + phases + offsets + bounds, g + offsets, g + bounds, g +
    phases]; stance warps to [0, 0.5], swing to [0.5, 1]; the desired contact
    is the product of normal-CDF windows."""
    g = torch.remainder(t * freq, 1.0)[:, None]
    offs = torch.tensor([phases + offsets + bounds, offsets, bounds, phases],
                        dtype=torch.float32, device=t.device)
    idx = torch.remainder(g + offs, 1.0)
    warped = torch.where(idx < duration, idx * (0.5 / duration),
                         0.5 + (idx - duration) * (0.5 / (1.0 - duration)))
    clock = torch.sin(2.0 * np.pi * warped)
    cdf = lambda x: _normal_cdf(x, kappa)
    desired = (cdf(warped) * (1.0 - cdf(warped - 0.5))
               + cdf(warped - 1.0) * (1.0 - cdf(warped - 1.5)))
    return idx, clock, desired


class CyberWalkEnv(CyberStandDanceEnv):
    """Bipedal walk from a standing quadruped pose (the trot clock)."""

    allow_contact_steps = 50
    clock_phases = 0.5
    clock_offsets = 0.0
    clock_bounds = 0.0
    kappa_gait_probs = 0.07
    num_state_history = 3
    single_obs_dim = 47         # gravity 3 + forward 3 + commands 3 + q 12 + qd 12 + a 12 + clock 2

    def _clock(self, s):
        t = s.episode_length.to(torch.float32) * self.dt
        return contact_clock(t, self.gait_freq, self.clock_phases, self.clock_offsets,
                             self.clock_bounds, kappa=self.kappa_gait_probs)

    def _rear_phases(self, s):
        """The clock's raw rear-feet phases."""
        return self._clock(s)[0][:, 2:]

    def _reward_feet_clearance_cmd_linear(self, s, ctx):
        """Rear-feet swing-height tracking weighted by the smoothed desired
        swing (1 - desired contact)."""
        idx, _, desired = self._clock(s)
        return self._clearance(s, idx[:, 2:], 1.0 - desired[:, 2:])

    # ---- observations: stacked frames ----
    def _single_obs(self, s):
        """The 47-dim frame: projected gravity and forward axis, the commands
        with x and y swapped and yaw zeroed, joints, actions and the rear
        feet's clock inputs."""
        os_ = self.cfg.normalization.obs_scales
        B = s.phys.base_pos.shape[0]
        x = torch.tensor([1.0, 0.0, 0.0], device=self.device).expand(B, 3)
        fwd = quat_rotate_inverse(s.phys.base_quat, x)
        cmd = torch.stack([s.commands[:, 1], s.commands[:, 0], torch.zeros_like(s.commands[:, 0])],
                          dim=-1)
        cmd_scale = torch.tensor([os_.lin_vel, os_.lin_vel, os_.ang_vel], device=self.device)
        clock = self._clock(s)[1]
        return torch.cat([s.projected_gravity, fwd, cmd * cmd_scale,
                          (s.phys.joint_pos - self.default_dof_pos) * os_.dof_pos,
                          s.phys.joint_vel * os_.dof_vel, s.actions, clock[:, 2:]], dim=-1)

    def _compute_observations(self, state) -> torch.Tensor:
        return torch.cat([state.obs[:, self.single_obs_dim:], self._single_obs(state)], dim=-1)

    def _make_noise_scale_vec(self) -> np.ndarray:
        """Uniform noise of ±0.01 on the newest frame (older frames carry the
        noise they had)."""
        vec = np.zeros(self.num_obs, np.float32)
        vec[-self.single_obs_dim:] = 0.01
        return vec

    # ---- termination: time-outs only ----
    def _check_termination(self, state):
        _, time_out = super()._check_termination(state)
        return time_out, time_out

    # ---- random resets ----
    def _sample_init_phys(self, env_origins) -> PhysState:
        B, init = self.num_envs, self.base_init_state
        pos = env_origins + init[0:3]
        quat = init[3:7].repeat(B, 1)
        dof_pos = self.default_dof_pos + self._uniform((B, self.num_dof), -0.1, 0.1)
        dof_vel = self._uniform((B, self.num_dof), -0.1, 0.1)
        twist = self._uniform((B, 6), -0.1, 0.1)
        anchor = pos[:, None, :2].expand(B, self.model.ng, 2).clone()
        return PhysState(base_pos=pos, base_quat=quat, joint_pos=dof_pos,
                         base_lin_vel=twist[:, :3], base_ang_vel=twist[:, 3:],
                         joint_vel=dof_vel, contact_anchor=anchor)


class CyberHopEnv(CyberWalkEnv):
    """cyber2_hop: the pronking clock (all feet in phase)."""
    clock_phases = 0.0
    clock_offsets = 0.0
    clock_bounds = 0.0


class CyberBounceEnv(CyberWalkEnv):
    """cyber2_bounce: the bounding clock (front and rear pairs anti-phased)."""
    clock_phases = 0.0
    clock_offsets = 0.0
    clock_bounds = 0.5


def cyberdog2_c2walk_cfg() -> LeggedRobotCfg:
    """The walk config (the stand initial pose; 3 x 47-dim observations)."""
    cfg = cyberdog2_walk_cfg()
    cfg.env.num_observations = CyberWalkEnv.single_obs_dim * CyberWalkEnv.num_state_history
    cfg.env.episode_length_s = 20.0
    cfg.init_state.pos = [0.0, 0.0, 0.25]
    cfg.init_state.default_joint_angles = {
        "FL_hip_joint": 0.0, "RL_hip_joint": 0.0,
        "FR_hip_joint": 0.0, "RR_hip_joint": 0.0,
        "FL_thigh_joint": -45 / 57.3, "RL_thigh_joint": -45 / 57.3,
        "FR_thigh_joint": -45 / 57.3, "RR_thigh_joint": -45 / 57.3,
        "FL_calf_joint": 70 / 57.3, "RL_calf_joint": 70 / 57.3,
        "FR_calf_joint": 70 / 57.3, "RR_calf_joint": 70 / 57.3,
    }
    cfg.control.stiffness = {"joint": 30.0}
    cfg.control.damping = {"joint": 3.0}
    cfg.asset.terminate_after_contacts_on = []
    cfg.asset.penalize_contacts_on = ["base", "head", "FR_thigh", "FL_thigh",
                                      "FR_calf", "FL_calf", "RL_thigh", "RR_thigh"]
    cfg.commands.ranges.lin_vel_x = [-0.3, 0.5]
    cfg.commands.ranges.lin_vel_y = [-0.3, 0.3]
    cfg.commands.ranges.ang_vel_yaw = [-0.5, 0.5]
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.randomize_friction = True
    cfg.domain_rand.friction_range = [0.25, 1.75]
    cfg.rewards.only_positive_rewards = False
    sc = cfg.rewards.scales
    sc.tracking_lin_vel = 0.6
    sc.tracking_ang_vel = 0.25
    sc.lin_vel_z = 0.0
    sc.ang_vel_xy = 0.0
    sc.orientation = 0.0
    sc.base_height = 0.0
    sc.feet_air_time = 0.0
    sc.upright = 1.0
    sc.lift_up_linear = 0.5
    sc.feet_clearance_cmd_linear = -300.0
    sc.rear_air = -0.5
    sc.feet_slip = -0.4
    sc.foot_shift = -50.0
    sc.action_rate = -0.03
    sc.dof_vel = -1e-4
    sc.dof_acc = -2.5e-7
    sc.dof_pos_limits = -10.0
    sc.torques = 0.0
    sc.collision = -2.0
    return cfg


def cyberdog2_c2walk_ppo_cfg() -> LeggedRobotCfgPPO:
    t = LeggedRobotCfgPPO()
    t.runner.experiment_name = "walk_cyber"
    t.policy.actor_hidden_dims = [512, 256, 128]
    t.policy.critic_hidden_dims = [512, 256, 128]
    return t
