"""ANYmal-C sampling-MPC task (port of ``robots/anymal_c_traj.py``).

The robot model is read in place from the JAX package's committed JSON."""
from __future__ import annotations

import math
import os

import torch

from ..envs.batch_rollout import RobotTrajGradSampling, RobotTrajGradSamplingCfg

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                     "extended_legged_gym_tpu", "robots", "data")

# Gait tables in reference foot order FL, FR, RL, RR; the model's foot order
# (alphabetical) is LF, LH, RF, RH = FL, RL, FR, RR, i.e. permutation [0, 2, 1, 3].
_P = [0, 2, 1, 3]
GAIT_PHASES = {
    "stand":  [0.0, 0.0, 0.0, 0.0],
    "walk":   [0.0, 0.5, 0.75, 0.25],
    "trot":   [0.0, 0.5, 0.5, 0.0],
    "canter": [0.0, 0.33, 0.33, 0.66],
    "gallop": [0.0, 0.05, 0.4, 0.35],
}
GAIT_PARAMS = {  # duty ratio, cadence, amplitude
    "stand":  [1.0, 1.0, 0.0],
    "walk":   [0.75, 1.0, 0.08],
    "trot":   [0.45, 2.0, 0.08],
    "canter": [0.4, 4.0, 0.06],
    "gallop": [0.3, 3.5, 0.10],
}


def get_foot_step(duty_ratio, cadence, amplitude, phases: torch.Tensor, time: torch.Tensor):
    """Target swing foot heights from the gait clock."""
    gait_phase = torch.remainder(time[..., None] * cadence + phases, 1.0)
    swing = gait_phase >= duty_ratio
    swing_norm = (gait_phase - duty_ratio) / max(1.0 - duty_ratio, 1e-6)
    return torch.where(swing, amplitude * torch.sin(swing_norm * math.pi),
                       torch.zeros_like(gait_phase))


class AnymalCTrajGradSampling(RobotTrajGradSampling):
    """ANYmal-C MPC env with the DIAL-MPC-style task reward terms.  The
    committed config scales none of them; a config may switch them on."""

    gait = "trot"
    foot_perm = tuple(_P)

    def _gait_tables(self):
        phases = torch.tensor([GAIT_PHASES[self.gait][i] for i in self.foot_perm],
                              device=self.device)
        duty, cadence, amp = GAIT_PARAMS[self.gait]
        return duty, cadence, amp, phases

    def _reward_gaits(self, s, ctx):
        duty, cadence, amp, phases = self._gait_tables()
        radius = self.model.torch(self.device)["foot_radius"]
        z_feet = s.foot_positions[:, :, 2] - radius[None, :]
        t = getattr(s, "t", None)
        if t is None:
            t = s.episode_length.to(torch.float32) * self.dt
        z_tar = get_foot_step(duty, cadence, amp, phases, t)
        return -torch.sum(torch.square((z_tar - z_feet) / 0.05), dim=1)

    def _reward_air_time(self, s, ctx):
        return torch.sum((ctx["feet_air_time"] - 0.1) * ctx["first_contact"], dim=1)

    def _reward_upright(self, s, ctx):
        up = torch.tensor([0.0, 0.0, -1.0], device=self.device)
        return -torch.sum(torch.square(s.projected_gravity - up), dim=1)

    def _reward_yaw(self, s, ctx):
        from ..utils.math import quat_apply_yaw

        fwd = quat_apply_yaw(s.phys.base_quat, torch.tensor(
            [1.0, 0.0, 0.0], device=self.device).expand_as(s.phys.base_pos))
        yaw = torch.atan2(fwd[:, 1], fwd[:, 0])
        diff = torch.atan2(torch.sin(yaw), torch.cos(yaw))   # heading target 0
        return -torch.square(diff)

    def _reward_vel(self, s, ctx):
        return -torch.sum(torch.square(s.base_lin_vel[:, :2] - s.commands[:, :2]), dim=1)

    def _reward_ang_vel(self, s, ctx):
        return -torch.square(s.base_ang_vel[:, 2] - s.commands[:, 2])

    def _reward_height(self, s, ctx):
        return -torch.square(s.phys.base_pos[:, 2] - self.cfg.rewards.base_height_target)

    def _reward_energy(self, s, ctx):
        power = torch.clamp(s.torques * s.phys.joint_vel, min=0.0)
        return -torch.sum(torch.square(power / 160.0), dim=1)

    def _reward_alive(self, s, ctx):
        return 1.0 - s.reset_buf.to(torch.float32)


def anymal_c_traj_sampling_cfg(num_main_envs: int = 1) -> RobotTrajGradSamplingCfg:
    cfg = RobotTrajGradSamplingCfg()
    cfg.env.num_envs = num_main_envs
    cfg.env.num_actions = 12
    cfg.env.num_observations = 48
    cfg.env.episode_length_s = 20.0

    cfg.terrain.mesh_type = "plane"
    cfg.terrain.measure_heights = False
    cfg.terrain.curriculum = False

    cfg.init_state.pos = [0.0, 0.0, 0.5]
    cfg.init_state.default_joint_angles = {       # deeper knee bend than the RL configs
        "LF_HAA": 0.0, "LF_HFE": 0.4, "LF_KFE": -1.1,
        "RF_HAA": 0.0, "RF_HFE": 0.4, "RF_KFE": -1.1,
        "LH_HAA": 0.0, "LH_HFE": -0.4, "LH_KFE": 1.1,
        "RH_HAA": 0.0, "RH_HFE": -0.4, "RH_KFE": 1.1,
    }
    cfg.control.stiffness = {"HAA": 80.0, "HFE": 80.0, "KFE": 80.0}
    cfg.control.damping = {"HAA": 2.0, "HFE": 2.0, "KFE": 2.0}
    cfg.control.action_scale = 0.5
    cfg.control.decimation = 4

    cfg.asset.file = os.path.join(_DATA, "anymal_c.json")
    cfg.asset.foot_name = "FOOT"
    cfg.asset.penalize_contacts_on = ["SHANK", "THIGH"]
    cfg.asset.terminate_after_contacts_on = ["base"]

    cfg.commands.resampling_time = 4.0
    cfg.commands.ranges.lin_vel_x = [-1.5, 1.5]

    cfg.rewards.only_positive_rewards = False
    cfg.rewards.base_height_target = 0.5
    cfg.rewards.max_contact_force = 500.0
    sc = cfg.rewards.scales
    sc.tracking_lin_vel = 5.0
    sc.tracking_ang_vel = 0.5
    sc.lin_vel_z = -1.0
    sc.ang_vel_xy = -0.5
    sc.orientation = -2.0
    sc.torques = -0.00001
    sc.dof_acc = -2.5e-7
    sc.feet_air_time = 1.0
    sc.collision = -2.0
    sc.action_rate = -0.001

    cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.randomize_friction = False
    cfg.domain_rand.push_robots = False
    cfg.noise.add_noise = False

    to = cfg.trajectory_opt
    to.num_diffuse_steps = 2
    to.num_diffuse_steps_init = 6
    to.num_samples = 127
    to.temp_sample = 0.1
    to.horizon_samples = 16
    to.horizon_nodes = 4
    to.horizon_diffuse_factor = 0.9
    to.traj_diffuse_factor = 0.5
    to.noise_scaling = 1.5
    to.update_method = "avwbfo"
    to.gamma = 1.0
    to.interp_method = "spline"
    to.polish_iters = 2
    to.polish_method = "fd"
    to.polish_lr = 0.05
    to.polish_fd_eps = 0.05
    return cfg
