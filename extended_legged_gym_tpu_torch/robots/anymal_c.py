"""ANYmal-C task configs (port of the rough, ray-observation rough, flat and
SEA-actuated flat configs of ``robots/anymal_c.py``).

The robot model is read in place from the JAX package's committed JSON."""
from __future__ import annotations

import json
import os

from ..envs.legged_robot_config import LeggedRobotCfg, LeggedRobotCfgPPO

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                     "extended_legged_gym_tpu", "robots", "data")

ANYMAL_C_DEFAULT_ANGLES = {
    "LF_HAA": 0.0, "LH_HAA": 0.0, "RF_HAA": -0.0, "RH_HAA": -0.0,
    "LF_HFE": 0.4, "LH_HFE": -0.4, "RF_HFE": 0.4, "RH_HFE": -0.4,
    "LF_KFE": -0.8, "LH_KFE": 0.8, "RF_KFE": -0.8, "RH_KFE": 0.8,
}


def anymal_c_rough_cfg() -> LeggedRobotCfg:
    """ANYmal-C on the 8 x 8 curriculum grid (5 m subterrains at 0.1 m, 25 m
    border: a 900 x 900 heightfield) with the 187-point height scan
    (235-dim observations), 4096 envs, staged reward scales.  The env
    stands the robot in the model JSON's default pose, as the JAX env does;
    ``default_joint_angles`` records the published one."""
    cfg = LeggedRobotCfg()
    cfg.env.num_envs = 4096
    cfg.env.num_actions = 12
    cfg.env.num_observations = 235
    cfg.terrain.mesh_type = "trimesh"
    cfg.init_state.pos = [0.0, 0.0, 0.6]
    cfg.init_state.default_joint_angles = dict(ANYMAL_C_DEFAULT_ANGLES)
    cfg.control.stiffness = {"HAA": 80.0, "HFE": 80.0, "KFE": 80.0}
    cfg.control.damping = {"HAA": 2.0, "HFE": 2.0, "KFE": 2.0}
    cfg.control.action_scale = 0.5
    cfg.control.decimation = 4
    cfg.asset.file = os.path.join(_DATA, "anymal_c.json")
    cfg.asset.name = "anymal_c"
    cfg.asset.foot_name = "FOOT"
    cfg.asset.penalize_contacts_on = ["SHANK", "THIGH"]
    cfg.asset.terminate_after_contacts_on = ["base"]
    cfg.domain_rand.randomize_base_mass = True
    cfg.domain_rand.added_mass_range = [-5.0, 5.0]
    cfg.rewards.base_height_target = 0.5
    cfg.rewards.max_contact_force = 500.0
    cfg.rewards.only_positive_rewards = True
    # stage 0 runs the penalties at 25% until the mean episode reward crosses
    # the threshold, then the reference scales apply
    cfg.rewards.multi_stage_rewards = True
    cfg.rewards.reward_max_stage = 1
    cfg.rewards.reward_stage_threshold = 3.0
    s = cfg.rewards.scales
    s.lin_vel_z = [-0.5, -2.0]
    s.ang_vel_xy = [-0.0125, -0.05]
    s.torques = [-2.5e-6, -1.0e-5]
    s.dof_acc = [-6.25e-8, -2.5e-7]
    s.action_rate = [-0.0025, -0.01]
    s.collision = [-0.25, -1.0]
    return cfg


def anymal_c_flat_cfg() -> LeggedRobotCfg:
    """The flat-terrain task: 48-dim observations, no height scan, the
    orientation and torque penalties on.  The JAX package departs from the
    reference flat settings (command resampling every 10 s, yaw rate in
    [-1, 1], friction in [0.5, 1.25]) because its PD-actuated engine trains
    stably with them; the port keeps its values, the staged penalties (25%
    until the mean episode reward passes 3.0) and the base-height calibration
    ([-10, -40], target 0.5 m) included."""
    cfg = anymal_c_rough_cfg()
    cfg.env.num_observations = 48
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.measure_heights = False
    cfg.terrain.curriculum = False
    cfg.rewards.scales.orientation = -5.0
    cfg.rewards.scales.torques = -2.5e-5
    cfg.rewards.scales.feet_air_time = 2.0
    cfg.rewards.max_contact_force = 350.0
    cfg.commands.resampling_time = 10.0
    cfg.commands.ranges.ang_vel_yaw = [-1.0, 1.0]
    cfg.domain_rand.friction_range = [0.5, 1.25]
    cfg.rewards.multi_stage_rewards = True
    cfg.rewards.reward_max_stage = 1
    cfg.rewards.reward_stage_threshold = 3.0
    s = cfg.rewards.scales
    s.lin_vel_z = [-0.5, -2.0]
    s.ang_vel_xy = [-0.0125, -0.05]
    s.orientation = [-1.25, -5.0]
    s.torques = [-6.25e-6, -2.5e-5]
    s.dof_acc = [-6.25e-8, -2.5e-7]
    s.action_rate = [-0.0025, -0.01]
    s.collision = [-0.25, -1.0]
    s.base_height = [-10.0, -40.0]
    return cfg


def anymal_c_flat_sea_cfg() -> LeggedRobotCfg:
    """The flat task actuated through the ANYdrive v3 SEA LSTM (the
    reference's training actuation): each substep's torques come from the
    actuator network, each substep one launch of the torques-in B1 route."""
    cfg = anymal_c_flat_cfg()
    cfg.control.use_actuator_network = True
    cfg.control.actuator_net_file = os.path.join(_DATA, "anydrive_v3_lstm.json")
    return cfg


def anymal_c_flat_obstacles_cfg() -> LeggedRobotCfg:
    """The flat task with 4-8 passive stones per robot, dropped 1-4 m
    around it."""
    cfg = anymal_c_flat_cfg()
    cfg.obstacle_gen.enable_obstacles = True
    cfg.obstacle_gen.min_obstacles = 4
    cfg.obstacle_gen.max_obstacles = 8
    cfg.obstacle_gen.spawn_radius_range = [1.0, 4.0]
    return cfg


def anymal_c_rough_raycast_cfg() -> LeggedRobotCfg:
    """The perceptive rough task: the 235-dim rough observation plus 32
    forward cone rays (60 degrees, 10 m, mounted 0.5 m ahead of the base) as
    normalized inverse distances, 267 in all."""
    cfg = anymal_c_rough_cfg()
    cfg.raycaster.enable_raycast = True
    cfg.raycaster.attach_to_obs = True
    cfg.raycaster.ray_pattern = "cone"
    cfg.raycaster.num_rays = 32
    cfg.raycaster.ray_angle = 60.0
    cfg.raycaster.max_distance = 10.0
    cfg.raycaster.offset_pos = [0.5, 0.0, 0.0]
    cfg.env.num_observations = 235 + 32
    return cfg


def anymal_c_ppo_cfg(experiment: str = "flat_anymal_c") -> LeggedRobotCfgPPO:
    """Flat-task PPO settings: the [128, 64, 32] actor and critic."""
    train = LeggedRobotCfgPPO()
    train.runner.experiment_name = experiment
    train.runner.max_iterations = 300
    train.policy.actor_hidden_dims = [128, 64, 32]
    train.policy.critic_hidden_dims = [128, 64, 32]
    return train


def anymal_c_rough_ppo_cfg(experiment: str = "rough_anymal_c") -> LeggedRobotCfgPPO:
    """Rough-terrain policy settings: the reference-size [512, 256, 128] actor
    and critic (the base defaults; the flat task's [128, 64, 32] must not
    leak here)."""
    train = LeggedRobotCfgPPO()
    train.runner.experiment_name = experiment
    train.runner.max_iterations = 1500
    return train


def anymal_c_symmetry_cfg(coef: float = 0.5) -> dict:
    """A ``symmetry_cfg`` for the flat task: the mirror in the sagittal plane
    (y -> -y) of its 48-dim observation and 12 actions.  Base linear
    velocity and gravity flip y, angular velocity flips x and z, the command
    flips its lateral speed and yaw rate; each joint takes its mirror leg's
    value (L <-> R), the hip abduction (HAA) sign flipped."""
    with open(os.path.join(_DATA, "anymal_c.json")) as f:
        joints = json.load(f)["joint_names"]
    mirror = {"L": "R", "R": "L"}
    jperm = [joints.index(mirror[n[0]] + n[1:]) for n in joints]
    jsign = [-1.0 if n.endswith("HAA") else 1.0 for n in joints]
    base_signs = [1.0, -1.0, 1.0, -1.0, 1.0, -1.0, 1.0, -1.0, 1.0, 1.0, -1.0, -1.0]
    obs_perm = list(range(12)) + [o + p for o in (12, 24, 36) for p in jperm]
    return dict(obs_perm=obs_perm, obs_signs=base_signs + jsign * 3, act_perm=jperm,
                act_signs=jsign, coef=coef)
