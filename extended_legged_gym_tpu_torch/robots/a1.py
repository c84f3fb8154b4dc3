"""Unitree A1 task configs (port of ``robots/a1.py``): rough and flat PPO
on the base reward set, P control at 20 / 0.5, torque and joint-limit
penalties.  The model (13 bodies, 12 joints, 4 feet) is read in place from
the JAX package's committed JSON, whose default joint angles the env uses:
hips +-0.1, thighs 0.8 front and 1.0 rear, calves -1.5."""
from __future__ import annotations

import os

from ..envs.legged_robot_config import LeggedRobotCfg, LeggedRobotCfgPPO
from .anymal_c import _DATA

A1_DEFAULT_ANGLES = {
    "FL_hip_joint": 0.1, "RL_hip_joint": 0.1, "FR_hip_joint": -0.1, "RR_hip_joint": -0.1,
    "FL_thigh_joint": 0.8, "RL_thigh_joint": 1.0, "FR_thigh_joint": 0.8, "RR_thigh_joint": 1.0,
    "FL_calf_joint": -1.5, "RL_calf_joint": -1.5, "FR_calf_joint": -1.5, "RR_calf_joint": -1.5,
}


def a1_rough_cfg() -> LeggedRobotCfg:
    """A1 on the generated curriculum grid (contacts on its heightfield)
    with the 187-point height scan: 235-dim observations, 4096 envs."""
    cfg = LeggedRobotCfg()
    cfg.env.num_envs = 4096
    cfg.env.num_observations = 48 + 187
    cfg.terrain.mesh_type = "trimesh"
    cfg.init_state.pos = [0.0, 0.0, 0.42]
    cfg.init_state.default_joint_angles = dict(A1_DEFAULT_ANGLES)
    cfg.control.control_type = "P"
    cfg.control.stiffness = {"joint": 20.0}
    cfg.control.damping = {"joint": 0.5}
    cfg.control.action_scale = 0.25
    cfg.control.decimation = 4
    cfg.asset.file = os.path.join(_DATA, "a1.json")
    cfg.asset.name = "a1"
    cfg.asset.foot_name = "foot"
    cfg.asset.penalize_contacts_on = ["thigh", "calf"]
    cfg.asset.terminate_after_contacts_on = ["base"]
    cfg.rewards.soft_dof_pos_limit = 0.9
    cfg.rewards.base_height_target = 0.25
    cfg.rewards.scales.torques = -0.0002
    cfg.rewards.scales.dof_pos_limits = -10.0
    return cfg


def a1_flat_cfg() -> LeggedRobotCfg:
    """The flat task: 48-dim observations, no height scan."""
    cfg = a1_rough_cfg()
    cfg.env.num_observations = 48
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.measure_heights = False
    cfg.terrain.curriculum = False
    return cfg


def a1_ppo_cfg() -> LeggedRobotCfgPPO:
    """The base [512, 256, 128] actor and critic."""
    t = LeggedRobotCfgPPO()
    t.runner.experiment_name = "rough_a1"
    return t
