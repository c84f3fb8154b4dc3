"""Unitree Go2 task configs (port of ``robots/go2.py``): rough and flat PPO
at P 30 / 0.8, and the DIAL-MPC flat tuning (``go2_dialmpc_flat_cfg``: 32
main envs, P 55 / 0.8; its task is not registered yet).  The model (4 feet,
termination on the base and the head) is read in place from the JAX
package's committed JSON, whose default joint angles the env uses."""
from __future__ import annotations

import os

from ..envs.batch_rollout import RobotTrajGradSamplingCfg
from ..envs.legged_robot_config import LeggedRobotCfg, LeggedRobotCfgPPO
from .anymal_c import _DATA

GO2_DEFAULT_ANGLES = {
    "FL_hip_joint": 0.1, "RL_hip_joint": 0.1, "FR_hip_joint": -0.1, "RR_hip_joint": -0.1,
    "FL_thigh_joint": 0.8, "RL_thigh_joint": 1.0, "FR_thigh_joint": 0.8, "RR_thigh_joint": 1.0,
    "FL_calf_joint": -1.5, "RL_calf_joint": -1.5, "FR_calf_joint": -1.5, "RR_calf_joint": -1.5,
}


def _go2_base(cfg):
    cfg.init_state.pos = [0.0, 0.0, 0.33]
    cfg.init_state.default_joint_angles = dict(GO2_DEFAULT_ANGLES)
    cfg.control.stiffness = {"joint": 30.0}
    cfg.control.damping = {"joint": 0.8}
    cfg.control.action_scale = 0.3
    cfg.asset.file = os.path.join(_DATA, "go2.json")
    cfg.asset.name = "go2"
    cfg.asset.foot_name = "foot"
    cfg.asset.penalize_contacts_on = ["thigh", "calf"]
    cfg.asset.terminate_after_contacts_on = ["base", "Head_upper"]
    cfg.rewards.soft_dof_pos_limit = 0.9
    cfg.rewards.base_height_target = 0.25
    cfg.rewards.max_contact_force = 350.0
    return cfg


def go2_rough_cfg() -> LeggedRobotCfg:
    """Go2 on the generated curriculum grid with the height scan (235-dim
    observations)."""
    cfg = _go2_base(LeggedRobotCfg())
    cfg.env.num_observations = 48 + 187
    cfg.terrain.mesh_type = "trimesh"
    return cfg


def go2_flat_cfg() -> LeggedRobotCfg:
    cfg = go2_rough_cfg()
    cfg.env.num_observations = 48
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.measure_heights = False
    cfg.terrain.curriculum = False
    return cfg


def go2_dialmpc_flat_cfg(num_main_envs: int = 32) -> RobotTrajGradSamplingCfg:
    """The DIAL-MPC tuning: 32 main envs, P 55 / 0.8, no randomization or
    noise, tracking-heavy scales."""
    cfg = _go2_base(RobotTrajGradSamplingCfg())
    cfg.env.num_envs = num_main_envs
    cfg.env.num_observations = 48
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.measure_heights = False
    cfg.terrain.curriculum = False
    cfg.control.stiffness = {"joint": 55.0}
    cfg.control.damping = {"joint": 0.8}
    cfg.control.action_scale = 0.5
    cfg.domain_rand.randomize_friction = False
    cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.push_robots = False
    cfg.noise.add_noise = False
    cfg.rewards.only_positive_rewards = False
    sc = cfg.rewards.scales
    sc.tracking_lin_vel = 5.0
    sc.tracking_ang_vel = 0.5
    sc.lin_vel_z = -1.0
    sc.ang_vel_xy = -0.5
    sc.orientation = -2.0
    sc.feet_air_time = 1.0
    sc.collision = -2.0
    sc.action_rate = -0.001
    return cfg


def go2_ppo_cfg() -> LeggedRobotCfgPPO:
    t = LeggedRobotCfgPPO()
    t.runner.experiment_name = "rough_go2"
    return t
