"""Legged-robot environment configuration tree (port of
``envs/legged_robot_config.py``).

Every group and field of the JAX package is here, with its default.  The
fields in ``UNREAD_ENV_FIELDS`` and ``UNREAD_TRAIN_FIELDS`` are read by
neither package's env or runner; the env and ``OnPolicyRunner`` refuse any
other value than the default there (:func:`refuse_unread`), so setting one
fails instead of doing nothing.  ``init_state.default_joint_angles`` and
``runner.multi_stage_rewards`` are records the robots set, as in the JAX
package: the env stands in the model JSON's ``default_dof_pos`` and keeps
the reward stage itself (``rewards.multi_stage_rewards``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..utils.config import configclass

# fields kept with the JAX package's defaults that nothing reads
UNREAD_ENV_FIELDS: Tuple[str, ...] = (
    "env.send_timeouts", "asset.disable_gravity", "asset.self_collisions",
    "terrain.dynamic_friction", "terrain.restitution", "terrain.slope_treshold",
    "terrain.random_origins", "terrain.origins_x_range", "terrain.origins_y_range",
    "terrain.height_clearance_factor", "viewer.ref_env", "viewer.pos", "viewer.lookat")
UNREAD_TRAIN_FIELDS: Tuple[str, ...] = (
    "runner_class_name", "runner.algorithm_class_name", "runner.logger", "runner.resume_path")


def refuse_unread(cfg, paths) -> None:
    """Raise ``ValueError`` naming every dotted field of ``paths`` under
    ``cfg`` whose value differs from its class default."""
    bad = []
    for path in paths:
        *groups, name = path.split(".")
        owner = cfg
        for g in groups:
            owner = getattr(owner, g)
        value = getattr(owner, name)
        if value != getattr(type(owner)(), name):
            bad.append(f"{path}={value!r}")
    if bad:
        hint = " (ELG_LOGGER chooses the metrics sink)" if any(
            b.startswith("runner.logger") for b in bad) else ""
        raise ValueError(f"read by neither the env nor the runner, so only the default is "
                         f"accepted: {', '.join(bad)}{hint}")


@configclass
class EnvCfg:
    num_envs: int = 4096
    num_observations: int = 235
    num_privileged_obs: Optional[int] = None
    num_actions: int = 12
    env_spacing: float = 3.0
    send_timeouts: bool = True
    episode_length_s: float = 20.0


@configclass
class TerrainCfg:
    # none/plane, heightfield, trimesh (contacts on the generated heightfield),
    # confined_trimesh / confined_heightfield (terrain/confined.py), obj
    mesh_type: str = "trimesh"
    terrain_file: Optional[str] = None   # the .obj of mesh_type "obj"
    horizontal_scale: float = 0.1
    vertical_scale: float = 0.005
    border_size: float = 25.0
    curriculum: bool = True
    static_friction: float = 1.0
    dynamic_friction: float = 1.0
    restitution: float = 0.0
    measure_heights: bool = True
    measured_points_x: List[float] = [-0.8, -0.7, -0.6, -0.5, -0.4, -0.3, -0.2, -0.1,
                                      0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8]
    measured_points_y: List[float] = [-0.5, -0.4, -0.3, -0.2, -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5]
    selected: bool = False
    terrain_kwargs: Optional[dict] = None
    max_init_terrain_level: int = 5
    # pin every env to its spawn row while keeping the curriculum grid (the
    # evaluation protocol); curriculum=False would regenerate the grid in
    # randomized mode instead
    freeze_terrain_levels: bool = False
    terrain_length: float = 5.0
    terrain_width: float = 5.0
    num_rows: int = 8   # curriculum levels
    num_cols: int = 8   # terrain types
    # [smooth slope, rough slope, stairs up, stairs down, discrete]
    terrain_proportions: List[float] = [0.1, 0.1, 0.35, 0.25, 0.2]
    # confined: cumulative [tunnel, barrier, timber_piles, confined_gap(,
    # column_obstacles, wall_with_gap)]
    confined_terrain_proportions: List[float] = [0.25, 0.5, 0.75, 1.0]
    slope_treshold: float = 0.75
    # physics contacts on the terrain's triangle mesh (sphere-vs-mesh SDF);
    # needs a terrain that carries one, and steps the plain ABA engine
    trimesh_contacts: bool = False
    # random-origin generation of confined maps
    random_origins: bool = False
    origins_x_range: List[float] = [0.0, 0.0]
    origins_y_range: List[float] = [0.0, 0.0]
    height_clearance_factor: float = 1.0


@configclass
class CommandRangesCfg:
    lin_vel_x: List[float] = [-1.0, 1.0]
    lin_vel_y: List[float] = [-1.0, 1.0]
    ang_vel_yaw: List[float] = [-1.0, 1.0]
    heading: List[float] = [-3.14, 3.14]


@configclass
class CommandsCfg:
    curriculum: bool = False
    max_curriculum: float = 1.0
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
    # the robots' published default pose; the env reads the model JSON's
    # default_dof_pos instead, as the JAX env does
    default_joint_angles: Dict[str, float] = {}


@configclass
class ControlCfg:
    control_type: str = "P"  # P / V / T
    stiffness: Dict[str, float] = {}
    damping: Dict[str, float] = {}
    action_scale: float = 0.5
    decimation: int = 4
    # the ANYdrive SEA LSTM in place of the PD law (the control type is then
    # ignored); its weights are a JSON of models/actuator_net.py
    use_actuator_network: bool = False
    actuator_net_file: Optional[str] = None


@configclass
class AssetCfg:
    file: str = ""                  # robot model JSON
    name: str = "legged_robot"
    foot_name: str = "None"
    penalize_contacts_on: List[str] = []
    terminate_after_contacts_on: List[str] = []
    disable_gravity: bool = False
    fix_base_link: bool = False     # the base is welded to the world (an arm)
    self_collisions: int = 0
    # every joint's rotor armature when non-zero (replaces the model's)
    armature: float = 0.0


@configclass
class DomainRandCfg:
    randomize_friction: bool = True
    friction_range: List[float] = [0.5, 1.25]
    randomize_base_mass: bool = False
    added_mass_range: List[float] = [-1.0, 1.0]
    push_robots: bool = True
    push_interval_s: float = 15.0
    max_push_vel_xy: float = 1.0


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
    feet_stumble_liftup: float = 0.0
    jump_air: float = -0.0
    four_footup: float = 0.0
    action_rate: float = -0.01
    stand_still: float = -0.0


@configclass
class RewardsCfg:
    scales: RewardScalesCfg = RewardScalesCfg()
    only_positive_rewards: bool = True
    tracking_sigma: float = 0.25
    soft_dof_pos_limit: float = 1.0
    soft_dof_vel_limit: float = 1.0
    soft_torque_limit: float = 1.0
    base_height_target: float = 1.0
    max_contact_force: float = 100.0
    # staged scales: a scale may be a list, one value per stage; the env's
    # state carries the stage (a single-stage env takes each list's last value)
    multi_stage_rewards: bool = False
    reward_stage_threshold: float = 6.0
    reward_min_stage: int = 0
    reward_max_stage: int = 0


@configclass
class ObsScalesCfg:
    lin_vel: float = 2.0
    ang_vel: float = 0.25
    dof_pos: float = 1.0
    dof_vel: float = 0.05
    height_measurements: float = 5.0


@configclass
class NormalizationCfg:
    obs_scales: ObsScalesCfg = ObsScalesCfg()
    clip_observations: float = 100.0
    clip_actions: float = 100.0


@configclass
class NoiseScalesCfg:
    dof_pos: float = 0.01
    dof_vel: float = 1.5
    lin_vel: float = 0.1
    ang_vel: float = 0.2
    gravity: float = 0.05
    height_measurements: float = 0.1


@configclass
class NoiseCfg:
    add_noise: bool = True
    noise_level: float = 1.0
    noise_scales: NoiseScalesCfg = NoiseScalesCfg()


@configclass
class SimCfg:
    dt: float = 0.005
    gravity: List[float] = [0.0, 0.0, -9.81]
    contact_kp: float = 3.0e4
    contact_kd: float = 1.5e3
    contact_kt: float = 1.0e4
    contact_kt_spring: float = 3.0e4
    joint_damping: float = 0.0
    # "pallas": the fused kernel on the card (its plain version on the CPU)
    # where the scene allows it, else the plain ABA engine; "aba" or "crba":
    # the plain engine with that solver on any device
    solver: str = "pallas"
    # clamp joint velocities to the model's limits (else to +-500 rad/s)
    enforce_dof_vel_limits: bool = True


@configclass
class RaycasterCfg:
    enable_raycast: bool = False
    # append the normalized inverse-distance ray channels to the policy obs
    # (perceptive PPO tasks, e.g. anymal_c_rough_raycast); enable_raycast
    # alone builds the caster without widening the observation
    attach_to_obs: bool = False
    ray_pattern: str = "cone"    # single, grid, cone, spherical, spherical2
    spherical_num_azimuth: int = 8
    spherical_num_elevation: int = 4
    num_rays: int = 32
    ray_angle: float = 60.0
    max_distance: float = 10.0
    attach_yaw_only: bool = False
    offset_pos: List[float] = [0.5, 0.0, 0.0]
    terrain_file: Optional[str] = None
    spherical2_num_points: int = 32
    spherical2_polar_axis: List[float] = [0.0, 0.0, 1.0]


@configclass
class DepthCfg:
    camera_type: Optional[str] = None   # None, "Warp" / "Raycast" (heightfield raycast), "Fake"
    position: List[float] = [0.5, 0.0, 0.03]
    angle: List[float] = [30.0, 30.0]
    update_interval: int = 1
    original: List[int] = [60, 30]
    resized: List[int] = [56, 28]
    horizontal_fov: float = 100.0
    buffer_len: int = 2
    encoder: str = "cnn"
    near_clip: float = 0.0
    far_clip: float = 2.0
    dis_noise: float = 0.0
    scale: float = 1.0
    invert: bool = True


@configclass
class ViewerCfg:
    ref_env: int = 0
    pos: List[float] = [10.0, 0.0, 6.0]
    lookat: List[float] = [11.0, 5.0, 3.0]


@configclass
class ObstacleGenCfg:
    """Passive stone obstacles dropped around each robot
    (terrain/dynamic_obstacles.py)."""

    enable_obstacles: bool = False
    min_obstacles: int = 5
    max_obstacles: int = 15
    spawn_height_range: List[float] = [0.3, 1.0]
    spawn_radius_range: List[float] = [1.5, 6.0]
    stone_density_range: List[float] = [800.0, 2000.0]
    stone_friction_range: List[float] = [0.3, 0.9]
    stone_restitution_range: List[float] = [0.1, 0.4]
    cluster_probability: float = 0.3


@configclass
class LeggedRobotCfg:
    seed: int = 1
    env: EnvCfg = EnvCfg()
    obstacle_gen: ObstacleGenCfg = ObstacleGenCfg()
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
    raycaster: RaycasterCfg = RaycasterCfg()
    depth: DepthCfg = DepthCfg()
    viewer: ViewerCfg = ViewerCfg()


# ---------------------------------------------------------------------------
# PPO / training config
# ---------------------------------------------------------------------------

@configclass
class PolicyCfg:
    init_noise_std: float = 1.0
    actor_hidden_dims: List[int] = [512, 256, 128]
    critic_hidden_dims: List[int] = [512, 256, 128]
    activation: str = "elu"
    # ActorCriticRecurrent: one LSTM or GRU layer before each MLP
    rnn_type: str = "lstm"
    rnn_hidden_size: int = 512
    rnn_num_layers: int = 1


@configclass
class AlgorithmCfg:
    value_loss_coef: float = 1.0
    use_clipped_value_loss: bool = True
    clip_param: float = 0.2
    entropy_coef: float = 0.01
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    learning_rate: float = 1.0e-3
    schedule: str = "adaptive"
    gamma: float = 0.99
    lam: float = 0.95
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0
    normalize_advantage_per_mini_batch: bool = False
    # distillation
    gradient_length: int = 15
    # RND intrinsic rewards (models/rnd.py) and left-right symmetry
    # augmentation (rl/ppo.py::make_mirror_fns), as the JAX runner reads them
    rnd_cfg: Optional[dict] = None
    symmetry_cfg: Optional[dict] = None


@configclass
class RunnerCfg:
    policy_class_name: str = "ActorCritic"
    algorithm_class_name: str = "PPO"
    num_steps_per_env: int = 24
    max_iterations: int = 1500
    save_interval: int = 50
    experiment_name: str = "test"
    run_name: str = ""
    resume: bool = False
    load_run: int = -1
    checkpoint: int = -1
    resume_path: Optional[str] = None
    multi_stage_rewards: bool = False
    empirical_normalization: bool = False
    logger: str = "tensorboard"


@configclass
class LeggedRobotCfgPPO:
    seed: int = 1
    runner_class_name: str = "OnPolicyRunner"
    policy: PolicyCfg = PolicyCfg()
    algorithm: AlgorithmCfg = AlgorithmCfg()
    runner: RunnerCfg = RunnerCfg()
