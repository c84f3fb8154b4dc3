"""Legged-robot environment configuration tree (port of
``envs/legged_robot_config.py``).

Field names and defaults match the JAX package.  Only the groups and fields
that the flat sampling-MPC slice reads are here; the env raises on the
settings this slice does not implement (those fields stay so it can).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..utils.config import configclass


@configclass
class EnvCfg:
    num_envs: int = 4096
    num_observations: int = 235
    num_privileged_obs: Optional[int] = None
    num_actions: int = 12
    env_spacing: float = 3.0
    episode_length_s: float = 20.0


@configclass
class TerrainCfg:
    mesh_type: str = "trimesh"   # the port runs "plane" / "none" only
    curriculum: bool = True
    static_friction: float = 1.0
    measure_heights: bool = True


@configclass
class CommandRangesCfg:
    lin_vel_x: List[float] = [-1.0, 1.0]
    lin_vel_y: List[float] = [-1.0, 1.0]
    ang_vel_yaw: List[float] = [-1.0, 1.0]
    heading: List[float] = [-3.14, 3.14]


@configclass
class CommandsCfg:
    curriculum: bool = False
    num_commands: int = 4
    resampling_time: float = 10.0
    heading_command: bool = False
    ranges: CommandRangesCfg = CommandRangesCfg()


@configclass
class InitStateCfg:
    pos: List[float] = [0.0, 0.0, 1.0]
    rot: List[float] = [0.0, 0.0, 0.0, 1.0]  # xyzw
    lin_vel: List[float] = [0.0, 0.0, 0.0]
    ang_vel: List[float] = [0.0, 0.0, 0.0]
    # default joint angles come from the robot model JSON (default_dof_pos),
    # as in the JAX env


@configclass
class ControlCfg:
    control_type: str = "P"  # P / T
    stiffness: Dict[str, float] = {}
    damping: Dict[str, float] = {}
    action_scale: float = 0.5
    decimation: int = 4


@configclass
class AssetCfg:
    file: str = ""                  # robot model JSON
    name: str = "legged_robot"
    foot_name: str = "None"
    penalize_contacts_on: List[str] = []
    terminate_after_contacts_on: List[str] = []


@configclass
class DomainRandCfg:
    randomize_friction: bool = True
    randomize_base_mass: bool = False
    push_robots: bool = True


@configclass
class RewardScalesCfg:
    termination: float = -0.0
    tracking_lin_vel: float = 1.0
    tracking_ang_vel: float = 0.5
    lin_vel_z: float = -2.0
    ang_vel_xy: float = -0.05
    orientation: float = -0.0
    torques: float = -0.00001
    dof_vel: float = -0.0
    dof_acc: float = -2.5e-7
    base_height: float = -0.0
    feet_air_time: float = 1.0
    collision: float = -1.0
    feet_stumble: float = -0.0
    action_rate: float = -0.01
    stand_still: float = -0.0


@configclass
class RewardsCfg:
    scales: RewardScalesCfg = RewardScalesCfg()
    only_positive_rewards: bool = True
    tracking_sigma: float = 0.25
    base_height_target: float = 1.0
    max_contact_force: float = 100.0


@configclass
class ObsScalesCfg:
    lin_vel: float = 2.0
    ang_vel: float = 0.25
    dof_pos: float = 1.0
    dof_vel: float = 0.05


@configclass
class NormalizationCfg:
    obs_scales: ObsScalesCfg = ObsScalesCfg()
    clip_observations: float = 100.0
    clip_actions: float = 100.0


@configclass
class NoiseCfg:
    add_noise: bool = True


@configclass
class SimCfg:
    dt: float = 0.005
    gravity: List[float] = [0.0, 0.0, -9.81]
    contact_kp: float = 3.0e4
    contact_kd: float = 1.5e3
    contact_kt: float = 1.0e4
    contact_kt_spring: float = 3.0e4
    joint_damping: float = 0.0


@configclass
class LeggedRobotCfg:
    seed: int = 1
    env: EnvCfg = EnvCfg()
    terrain: TerrainCfg = TerrainCfg()
    commands: CommandsCfg = CommandsCfg()
    init_state: InitStateCfg = InitStateCfg()
    control: ControlCfg = ControlCfg()
    asset: AssetCfg = AssetCfg()
    domain_rand: DomainRandCfg = DomainRandCfg()
    rewards: RewardsCfg = RewardsCfg()
    normalization: NormalizationCfg = NormalizationCfg()
    noise: NoiseCfg = NoiseCfg()
    sim: SimCfg = SimCfg()
