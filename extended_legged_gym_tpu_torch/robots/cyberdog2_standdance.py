"""CyberDog2 stand-dance task (port of ``robots/cyberdog2_standdance.py``):
stand up on the rear legs and track velocity commands while bipedal.

Lift-up rewards toward ``liftup_target`` base height over the rear feet;
velocity and heading tracking gated by standing and scaled by the height;
rear-feet swing-height tracking against a gait clock; rear-air, slip and
foot-shift penalties; a contact-mercy termination (front contacts allowed
for the first ``allow_contact_steps`` control steps after a reset) and a
joint-limit protection; negative scales ramped 0.6x -> 0.8x -> 1.0x over
three reward stages.

Foot order (alphabetical): 0 FL, 1 FR, 2 RL, 3 RR -> front feet (0, 1), rear
feet (2, 3).
"""
from __future__ import annotations

import numpy as np
import torch

from ..envs.legged_robot import LeggedRobot
from ..envs.legged_robot_config import LeggedRobotCfg, LeggedRobotCfgPPO
from ..physics.dynamics import forward_kinematics
from ..terrain.heightfield import sample_height
from ..utils.config import class_to_dict
from ..utils.math import quat_apply_yaw, quat_rotate, wrap_to_pi
from .cyberdog2 import cyberdog2_walk_cfg


class CyberStandDanceEnv(LeggedRobot):
    front_feet = (0, 1)
    rear_feet = (2, 3)

    liftup_target = 0.42
    lift_up_threshold = (0.15, 0.42)
    scale_factor_low = 0.25
    scale_factor_high = 0.35
    foot_target = 0.05
    tracking_sigma = 0.05
    tracking_liftup_sigma = 0.03
    allow_contact_steps = 30
    gait_freq = 2.5
    upright_vec = (0.2, 0.0, 1.0)

    def __init__(self, cfg: LeggedRobotCfg, **kw):
        super().__init__(cfg, **kw)
        self.hip_joints = torch.as_tensor(
            [i for i, n in enumerate(self.model.joint_names) if "hip" in n], device=self.device)
        # the feet in the base frame at the default pose (the foot-shift term)
        z = torch.zeros(1, 3, device=self.device)
        kin = forward_kinematics(self.model, z, torch.tensor([[0.0, 0.0, 0.0, 1.0]],
                                                             device=self.device),
                                 self.default_dof_pos[None], z, z,
                                 torch.zeros(1, self.model.nj, device=self.device))
        T = self.model.torch(self.device)
        fb = T["foot_body"]
        self.default_foot_offsets = (kin.body_pos[0, fb]
                                     + (kin.body_rot[0, fb] @ T["foot_offset"][..., None])[..., 0])
        lim = T["dof_pos_limits"]
        margin = 5.0 / 180.0 * np.pi
        self.protect_lo, self.protect_hi = lim[:, 0] + margin, lim[:, 1] - margin

    # ---- helpers ----
    def _ground_under(self, s, pts_xy):
        """Terrain height under [B, k, 2] points."""
        return sample_height(self.terrain, pts_xy)

    def _rear_ground(self, s):
        return self._ground_under(s, s.foot_positions[:, self.rear_feet, :2])

    def _lift_height(self, s):
        """Base height over the mean rear-foot ground."""
        return s.phys.base_pos[:, 2] - torch.mean(self._rear_ground(s), dim=1)

    def _forward(self, s):
        x = torch.tensor([1.0, 0.0, 0.0], device=self.device).expand_as(s.phys.base_pos)
        return quat_rotate(s.phys.base_quat, x)

    def _is_stand(self, s):
        """The forward axis aligned with the yaw-rotated upright vector."""
        up = quat_apply_yaw(s.phys.base_quat,
                            torch.tensor(self.upright_vec, device=self.device).expand_as(
                                s.phys.base_pos))
        cos = torch.sum(self._forward(s) * up, dim=-1) / torch.linalg.norm(up, dim=-1)
        return cos > 0.9, cos

    def _height_scale(self, s):
        """0 -> 1 ramp of the lift height across [scale_factor_low, high]."""
        lo, hi = self.scale_factor_low, self.scale_factor_high
        return (self._lift_height(s).clamp(lo, hi) - lo) / (hi - lo)

    def _in_mercy(self, s):
        return s.episode_length <= self.allow_contact_steps

    def _rear_phases(self, s):
        """Rear-feet gait clock phases, anti-phased."""
        t = s.episode_length.to(torch.float32) * self.dt
        offs = torch.tensor([0.0, 0.5], device=self.device)
        return torch.remainder(t[:, None] * self.gait_freq + offs, 1.0)

    # ---- termination ----
    def _check_termination(self, state):
        reset, time_out = super()._check_termination(state)
        # contact terminations are ignored in the mercy window after a reset
        q = state.phys.joint_pos
        pos_protect = (state.episode_length > 3) & torch.any(
            (q < self.protect_lo) | (q > self.protect_hi), dim=-1)
        return torch.where(self._in_mercy(state), time_out, reset) | pos_protect, time_out

    # ---- rewards ----
    def _reward_upright(self, s, ctx):
        _, cos = self._is_stand(s)
        return torch.square(0.5 * cos + 0.5)

    def _reward_lift_up(self, s, ctx):
        err = torch.square(self._lift_height(s) - self.liftup_target)
        return torch.exp(-err / self.tracking_liftup_sigma)

    def _reward_lift_up_linear(self, s, ctx):
        lo, hi = self.lift_up_threshold
        return ((self._lift_height(s) - lo) / (hi - lo)).clamp(0.0, 1.0)

    def _reward_tracking_lin_vel(self, s, ctx):
        err = torch.sum(torch.square(s.commands[:, :2] - s.base_lin_vel[:, :2]), dim=1)
        stand, _ = self._is_stand(s)
        return torch.exp(-err / self.tracking_sigma) * stand * self._height_scale(s)

    def _reward_tracking_ang_vel(self, s, ctx):
        """Heading tracking: the commanded heading (commands[:, 3]) against
        the forward axis's."""
        fwd = self._forward(s)
        heading = torch.atan2(fwd[:, 1], fwd[:, 0])
        target = (s.commands[:, 3] if s.commands.shape[-1] > 3
                  else torch.zeros_like(heading))
        err = torch.square(wrap_to_pi(target - heading) / np.pi)
        stand, _ = self._is_stand(s)
        return torch.exp(-err / self.tracking_sigma) * stand * self._height_scale(s)

    def _clearance(self, s, ph, swing):
        """Rear-feet swing-height error against the clock's target height,
        weighted by ``swing`` [B, 2], outside the mercy window."""
        phases = 1.0 - torch.abs(1.0 - (ph * 2.0 - 1.0).clamp(0.0, 1.0) * 2.0)
        target = self.foot_target * phases + self._rear_ground(s) + 0.02
        rew = torch.square(target - s.foot_positions[:, self.rear_feet, 2]) * swing
        return torch.sum(rew, dim=1) * ~self._in_mercy(s)

    def _reward_feet_clearance_cmd_linear(self, s, ctx):
        ph = self._rear_phases(s)
        return self._clearance(s, ph, 1.0 - (ph < 0.5).to(torch.float32))

    def _reward_rear_air(self, s, ctx):
        """Both rear feet airborne."""
        no_contact = s.geom_forces[:, self.feet_geoms, 2][:, self.rear_feet] < 1.0
        return torch.all(no_contact, dim=1).to(torch.float32)

    def _reward_stand_air(self, s, ctx):
        """Rear feet off the ground in the mercy window while not upright."""
        air = torch.any(s.foot_positions[:, self.rear_feet, 2] - self._rear_ground(s) > 0.03, dim=1)
        return (self._in_mercy(s) & (self._forward(s)[:, 2] < 0.9) & air).to(torch.float32)

    def _reward_foot_twist(self, s, ctx):
        """xy foot speed near the ground."""
        vxy = torch.linalg.norm(s.foot_velocities[:, :, :2], dim=-1)
        near = (s.foot_positions[:, :, 2] - self._ground_under(s, s.foot_positions[:, :, :2])) < 0.025
        return torch.mean(vxy * near, dim=1)

    def _reward_feet_slip(self, s, ctx):
        near = (s.foot_positions[:, :, 2] - self._ground_under(s, s.foot_positions[:, :, :2])) < 0.03
        v2 = torch.square(torch.linalg.norm(s.foot_velocities[:, :, :2], dim=-1))
        return torch.sum(near * v2, dim=1)

    def _desired_feet(self, s, feet):
        """The default-stance spots of ``feet`` under the base's yaw, on the
        base's ground position."""
        B = s.phys.base_pos.shape[0]
        off = self.default_foot_offsets[list(feet)].expand(B, len(feet), 3)
        flat = s.phys.base_pos * torch.tensor([1.0, 1.0, 0.0], device=self.device)
        return quat_apply_yaw(s.phys.base_quat[:, None, :], off) + flat[:, None, :]

    def _reward_foot_shift(self, s, ctx):
        """In the mercy window: rear feet near their default spots on the
        ground; front feet not drifting backward or sideways."""
        desired_rear = self._desired_feet(s, self.rear_feet)
        desired_rear = torch.cat([desired_rear[..., :2], (self._rear_ground(s) + 0.02)[..., None]],
                                 dim=-1)
        rear_shift = torch.linalg.norm(s.foot_positions[:, self.rear_feet] - desired_rear,
                                       dim=-1).mean(dim=1)
        d = self._desired_feet(s, self.front_feet) - s.foot_positions[:, self.front_feet]
        front_shift = torch.linalg.norm(
            torch.stack([d[..., 0].clamp(min=0.0), torch.abs(d[..., 1])], dim=-1),
            dim=-1).mean(dim=1)
        return (front_shift + rear_shift) * self._in_mercy(s)

    def _reward_front_contact_force(self, s, ctx):
        f = s.geom_forces[:, self.feet_geoms][:, self.front_feet]
        return torch.linalg.norm(f, dim=-1).mean(dim=1)

    def _reward_hip_still(self, s, ctx):
        move = torch.abs(s.phys.joint_pos[:, self.hip_joints]).mean(dim=1)
        return move * self._in_mercy(s)

    def _reward_action_q_diff(self, s, ctx):
        """Action targets far from the current joint positions."""
        target = self.cfg.control.action_scale * s.actions + self.default_dof_pos
        return torch.sum(torch.square(target - s.phys.joint_pos), dim=1)

    def _reward_dof_vel(self, s, ctx):
        return torch.sum(torch.square(s.phys.joint_vel), dim=1)


def cyberdog2_standdance_cfg() -> LeggedRobotCfg:
    """The stand-dance config (the sit initial pose), its negative scales
    ramped 0.6x, 0.8x, 1.0x over reward stages 0-2 (advanced past a mean
    episode return of 0.2)."""
    cfg = cyberdog2_walk_cfg()
    cfg.env.num_observations = 48
    cfg.env.episode_length_s = 10.0
    cfg.init_state.pos = [0.0, 0.0, 0.11]
    cfg.init_state.default_joint_angles = {
        "FL_hip_joint": 0.0, "RL_hip_joint": 0.0,
        "FR_hip_joint": 0.0, "RR_hip_joint": 0.0,
        "FL_thigh_joint": -80 / 57.3, "RL_thigh_joint": -80 / 57.3,
        "FR_thigh_joint": -80 / 57.3, "RR_thigh_joint": -80 / 57.3,
        "FL_calf_joint": 135 / 57.3, "RL_calf_joint": 135 / 57.3,
        "FR_calf_joint": 135 / 57.3, "RR_calf_joint": 135 / 57.3,
    }
    cfg.control.stiffness = {"joint": 30.0}
    cfg.control.damping = {"joint": 3.0}
    cfg.asset.terminate_after_contacts_on = ["base", "head", "FR_thigh",
                                             "FL_thigh", "FR_calf", "FL_calf"]
    cfg.asset.penalize_contacts_on = ["thigh", "calf"]
    cfg.commands.ranges.lin_vel_x = [0.2, 0.2]
    cfg.commands.ranges.lin_vel_y = [0.0, 0.0]
    cfg.commands.ranges.ang_vel_yaw = [-0.3, 0.3]
    cfg.domain_rand.push_robots = False
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
    sc.lift_up = 0.0
    sc.feet_clearance_cmd_linear = -300.0
    sc.rear_air = -0.5
    sc.stand_air = 0.0
    sc.foot_twist = 0.0
    sc.feet_slip = -0.4
    sc.foot_shift = -50.0
    sc.front_contact_force = 0.0
    sc.hip_still = 0.0
    sc.action_q_diff = -1.0
    sc.action_rate = -0.03
    sc.dof_vel = -1e-4
    sc.dof_acc = -2.5e-7
    sc.dof_pos_limits = -10.0
    sc.torques = 0.0
    sc.collision = -2.0
    # the reward curriculum: negative scales start at 0.6x and step by 0.2x
    # each time the mean episode return passes 0.2
    cfg.rewards.multi_stage_rewards = True
    cfg.rewards.reward_min_stage = 0
    cfg.rewards.reward_max_stage = 2
    cfg.rewards.reward_stage_threshold = 0.2
    for name, v in class_to_dict(sc).items():
        if isinstance(v, (int, float)) and v < 0:
            setattr(sc, name, [0.6 * v, 0.8 * v, 1.0 * v])
    return cfg


def cyberdog2_standdance_ppo_cfg() -> LeggedRobotCfgPPO:
    t = LeggedRobotCfgPPO()
    t.runner.experiment_name = "stand_dance_cyber"
    t.policy.actor_hidden_dims = [512, 256, 128]
    t.policy.critic_hidden_dims = [512, 256, 128]
    return t
