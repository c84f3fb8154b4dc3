"""CyberDog2 task config and leg kinematics (port of ``robots/cyberdog2.py``):
13 bodies, 12 joints, 37 collision spheres, 4 feet, on B1.  The robot model
is read in place from the JAX package's committed JSON."""
from __future__ import annotations

import os

import torch

from ..envs.legged_robot_config import LeggedRobotCfg, LeggedRobotCfgPPO
from .anymal_c import _DATA

CYBERDOG2_DEFAULT_ANGLES = {
    "FL_hip_joint": 0.0, "RL_hip_joint": 0.0, "FR_hip_joint": -0.0, "RR_hip_joint": -0.0,
    "FL_thigh_joint": 0.8, "RL_thigh_joint": 1.0, "FR_thigh_joint": 0.8, "RR_thigh_joint": 1.0,
    "FL_calf_joint": -1.5, "RL_calf_joint": -1.5, "FR_calf_joint": -1.5, "RR_calf_joint": -1.5,
}

# leg geometry [m]
HIP_OFFSET = 0.094
THIGH_LEN = 0.12
CALF_LEN = 0.21


def foot_position_in_hip_frame(angles: torch.Tensor, l_hip_sign: float = 1.0) -> torch.Tensor:
    """Forward kinematics: leg joint angles [..., 3] (hip, thigh, calf) ->
    foot position [..., 3] in the hip frame."""
    theta_ab, theta_hip, theta_knee = angles[..., 0], angles[..., 1], angles[..., 2]
    l_up, l_low = THIGH_LEN, CALF_LEN
    l_hip = HIP_OFFSET * l_hip_sign
    leg_distance = torch.sqrt(l_up ** 2 + l_low ** 2 + 2 * l_up * l_low * torch.cos(theta_knee))
    eff_swing = theta_hip + theta_knee / 2
    off_x = -leg_distance * torch.sin(eff_swing)
    off_z = -leg_distance * torch.cos(eff_swing)
    y = torch.cos(theta_ab) * l_hip - torch.sin(theta_ab) * off_z
    z = torch.sin(theta_ab) * l_hip + torch.cos(theta_ab) * off_z
    return torch.stack([off_x, y, z], dim=-1)


def foot_ik_in_hip_frame(foot_pos: torch.Tensor, l_hip_sign: float = 1.0) -> torch.Tensor:
    """Inverse kinematics: foot position in the hip frame [..., 3] -> (hip,
    thigh, calf) angles [..., 3]."""
    x, y, z = foot_pos[..., 0], foot_pos[..., 1], foot_pos[..., 2]
    l_up, l_low = THIGH_LEN, CALF_LEN
    l_hip = HIP_OFFSET * l_hip_sign
    d2 = x ** 2 + y ** 2 + z ** 2 - l_hip ** 2
    leg_distance = torch.sqrt(d2.clamp(min=1e-6))
    cos_knee = (leg_distance ** 2 - l_up ** 2 - l_low ** 2) / (2 * l_up * l_low)
    theta_knee = -torch.arccos(cos_knee.clamp(-1.0, 1.0))
    eff_swing = torch.arcsin((x / leg_distance).clamp(-1.0, 1.0))
    theta_hip = -eff_swing - theta_knee / 2
    r = torch.sqrt((y ** 2 + z ** 2 - l_hip ** 2).clamp(min=1e-6))
    c1 = l_hip * y - r * z
    s1 = r * y + l_hip * z
    theta_ab = torch.atan2(s1, c1)
    return torch.stack([theta_ab, theta_hip, -theta_knee], dim=-1)


def cyberdog2_walk_cfg() -> LeggedRobotCfg:
    """The quadruped walk on a plane (4096 envs, 48-dim observations)."""
    cfg = LeggedRobotCfg()
    cfg.env.num_envs = 4096
    cfg.env.num_observations = 48
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.measure_heights = False
    cfg.terrain.curriculum = False
    cfg.init_state.pos = [0.0, 0.0, 0.35]
    cfg.init_state.default_joint_angles = dict(CYBERDOG2_DEFAULT_ANGLES)
    cfg.control.stiffness = {"joint": 25.0}
    cfg.control.damping = {"joint": 0.6}
    cfg.control.action_scale = 0.25
    cfg.asset.file = os.path.join(_DATA, "cyberdog2.json")
    cfg.asset.name = "cyberdog2"
    cfg.asset.foot_name = "foot"
    cfg.asset.penalize_contacts_on = ["thigh", "calf"]
    cfg.asset.terminate_after_contacts_on = ["base"]
    cfg.rewards.base_height_target = 0.3
    cfg.rewards.scales.torques = -0.0002
    cfg.rewards.scales.dof_pos_limits = -10.0
    return cfg


def cyberdog2_ppo_cfg() -> LeggedRobotCfgPPO:
    t = LeggedRobotCfgPPO()
    t.runner.experiment_name = "cyberdog2_walk"
    return t
