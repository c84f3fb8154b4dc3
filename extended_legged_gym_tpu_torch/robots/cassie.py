"""Cassie biped task config (port of ``robots/cassie.py``): 12 actuated
joints, 2 feet (``toe``), an 11 x 11 height scan (169-dim observations),
termination on pelvis contact with a -200 termination reward, and the
``no_fly`` term.  The model is read in place from the JAX package's
committed JSON, whose default joint angles the env uses."""
from __future__ import annotations

import os

from ..envs.legged_robot_config import LeggedRobotCfg, LeggedRobotCfgPPO
from .anymal_c import _DATA

_SCAN = [-0.5, -0.4, -0.3, -0.2, -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5]


def cassie_rough_cfg() -> LeggedRobotCfg:
    cfg = LeggedRobotCfg()
    cfg.env.num_envs = 4096
    cfg.env.num_observations = 169
    cfg.env.num_actions = 12
    cfg.terrain.mesh_type = "trimesh"
    cfg.terrain.measured_points_x = list(_SCAN)
    cfg.terrain.measured_points_y = list(_SCAN)
    cfg.init_state.pos = [0.0, 0.0, 1.0]
    cfg.init_state.default_joint_angles = {
        "hip_abduction_left": 0.1, "hip_rotation_left": 0.0, "hip_flexion_left": 1.0,
        "thigh_joint_left": -1.8, "ankle_joint_left": 1.57, "toe_joint_left": -1.57,
        "hip_abduction_right": -0.1, "hip_rotation_right": 0.0, "hip_flexion_right": 1.0,
        "thigh_joint_right": -1.8, "ankle_joint_right": 1.57, "toe_joint_right": -1.57,
    }
    cfg.control.stiffness = {"hip_abduction": 100.0, "hip_rotation": 100.0,
                             "hip_flexion": 200.0, "thigh_joint": 200.0,
                             "ankle_joint": 200.0, "toe_joint": 40.0}
    cfg.control.damping = {"hip_abduction": 3.0, "hip_rotation": 3.0,
                           "hip_flexion": 6.0, "thigh_joint": 6.0,
                           "ankle_joint": 6.0, "toe_joint": 1.0}
    cfg.control.action_scale = 0.5
    cfg.control.decimation = 4
    cfg.asset.file = os.path.join(_DATA, "cassie.json")
    cfg.asset.name = "cassie"
    cfg.asset.foot_name = "toe"
    cfg.asset.terminate_after_contacts_on = ["pelvis"]
    cfg.rewards.soft_dof_pos_limit = 0.95
    cfg.rewards.soft_dof_vel_limit = 0.9
    cfg.rewards.soft_torque_limit = 0.9
    cfg.rewards.max_contact_force = 300.0
    cfg.rewards.only_positive_rewards = False
    sc = cfg.rewards.scales
    sc.termination = -200.0
    sc.tracking_ang_vel = 1.0
    sc.torques = -5.0e-6
    sc.dof_acc = -2.0e-7
    sc.lin_vel_z = -0.5
    sc.feet_air_time = 5.0
    sc.dof_pos_limits = -1.0
    sc.no_fly = 0.25
    return cfg


def cassie_ppo_cfg() -> LeggedRobotCfgPPO:
    t = LeggedRobotCfgPPO()
    t.runner.experiment_name = "rough_cassie"
    t.policy.actor_hidden_dims = [256, 256, 128]
    return t
