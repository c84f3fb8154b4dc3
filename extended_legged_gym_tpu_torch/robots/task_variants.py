"""Task variants built from other tasks' config sections and envs (the
ported part of ``robots/task_variants.py``): the Franka batch rollout, the
ANYmal-C rough teacher, the Go2 pose, load and stand variants, the ElSpider
pose variant, the hanging (fixed-base) ElSpider foot tracking, the ElSpider
planning and ray-perception tasks and the navigation tasks (open ground,
and the confined barrier and timber-pile arenas with mesh contacts)."""
from __future__ import annotations

from ..envs.batch_rollout import RobotBatchRolloutCfg, RobotTrajGradSamplingCfg
from ..envs.legged_robot_config import LeggedRobotCfg
from ..envs.navigation import RobotNavCfg
from ..envs.percept import RobotPerceptCfg
from ..envs.plan_grad import RobotPlanGradSamplingCfg
from . import anymal_c, elspider_air, go2
from . import franka as franka_mod
from .anymal_c_traj import anymal_c_traj_sampling_cfg
from .anymal_c_variants import LoadAdaptAnymal, PoseAnymal, StandAnymal


def _copy_sections(dst, src, extra=(), skip=()):
    """Overlay the robot sections of ``src`` onto the variant config ``dst``
    (all but ``skip``)."""
    for f in ("env", "terrain", "commands", "init_state", "control", "asset",
              "domain_rand", "rewards", "normalization", "noise", "sim") + tuple(extra):
        if hasattr(src, f) and f not in skip:
            setattr(dst, f, getattr(src, f))
    return dst


def franka_batch_rollout_cfg(num_main_envs: int = 8) -> RobotBatchRolloutCfg:
    """The Franka task's sections on a batch-rollout config with
    ``num_main_envs`` main envs."""
    cfg = _copy_sections(RobotBatchRolloutCfg(), franka_mod.franka_cfg())
    cfg.env.num_envs = num_main_envs
    return cfg


def anymal_c_rough_teacher_cfg() -> LeggedRobotCfg:
    """The rough task with the 235-dim privileged observation for the
    critic."""
    cfg = anymal_c.anymal_c_rough_cfg()
    cfg.env.num_privileged_obs = 235
    return cfg


# --- Go2 variants: the ANYmal-C variants' machinery on Go2 ---

class PoseGo2(PoseAnymal):
    pass


class LoadAdaptGo2(LoadAdaptAnymal):
    pass


class StandGo2(StandAnymal):
    """Go2's foot order (alphabetical) is FL, FR, RL, RR: the hind feet are
    2 and 3."""
    hind_feet = (2, 3)
    front_feet = (0, 1)


def pose_go2_flat_cfg() -> LeggedRobotCfg:
    cfg = go2.go2_flat_cfg()
    cfg.commands.num_commands = 8
    sc = cfg.rewards.scales
    sc.pose_orientation = 1.0
    sc.pose_height = 1.0
    sc.tracking_ang_vel = 0.3
    return cfg


def load_adapt_go2_flat_cfg() -> LeggedRobotCfg:
    cfg = go2.go2_flat_cfg()
    cfg.rewards.scales.orientation = -5.0
    return cfg


def stand_go2_flat_cfg() -> LeggedRobotCfg:
    cfg = go2.go2_flat_cfg()
    cfg.rewards.only_positive_rewards = False
    sc = cfg.rewards.scales
    sc.tracking_lin_vel = 0.0
    sc.tracking_ang_vel = 0.0
    sc.feet_air_time = 0.0
    sc.orientation = 0.0
    sc.stand_pitch = 1.5
    sc.hind_contact = 1.0
    sc.front_up = 1.0
    return cfg


# --- ElSpider variants ---

class PoseElSpider(PoseAnymal, elspider_air.ElSpider):
    """8-dim pose commands on the hexapod."""


def pose_elspider_air_flat_cfg() -> LeggedRobotCfg:
    cfg = elspider_air.elspider_air_flat_cfg()
    cfg.commands.num_commands = 8
    cfg.rewards.multi_stage_rewards = False
    sc = cfg.rewards.scales
    sc.feet_slip = -0.1
    sc.pose_orientation = 1.0
    sc.pose_height = 1.0
    sc.tracking_ang_vel = 0.3
    return cfg


def foot_track_elspider_air_hang_cfg() -> LeggedRobotCfg:
    """Foothold tracking with the base welded at 0.28 m (the feet at the
    default pose hang clear of the ground) and only positive rewards: the
    fixed-base regime on the hexapod."""
    cfg = elspider_air.foot_track_elspider_air_flat_cfg()
    cfg.asset.fix_base_link = True
    cfg.init_state.pos = [0.0, 0.0, 0.28]
    cfg.rewards.only_positive_rewards = True
    return cfg


# --- ElSpider planning and perception, navigation ---

def _elspider_traj_base(num_main_envs: int) -> RobotTrajGradSamplingCfg:
    """The flat ElSpider task, single-stage, on a sampling-MPC config:
    feet_slip -0.1, no randomization, pushes or noise, rewards may go
    negative."""
    cfg = _copy_sections(RobotTrajGradSamplingCfg(), elspider_air.elspider_air_flat_cfg())
    cfg.env.num_envs = num_main_envs
    cfg.rewards.multi_stage_rewards = False
    cfg.rewards.scales.feet_slip = -0.1
    cfg.domain_rand.randomize_friction = False
    cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.push_robots = False
    cfg.noise.add_noise = False
    cfg.rewards.only_positive_rewards = False
    return cfg


def elspider_air_plan_grad_sampling_cfg(num_main_envs: int = 4) -> RobotPlanGradSamplingCfg:
    """State-velocity planning for the hexapod (6 base + 18 joint
    velocities)."""
    cfg = _copy_sections(RobotPlanGradSamplingCfg(), _elspider_traj_base(num_main_envs),
                         extra=("trajectory_opt",))
    cfg.env.num_actions = 24
    return cfg


def elspider_air_rough_raycast_cfg() -> RobotPerceptCfg:
    """The rough ElSpider task with 16 x 8 spherical rays in place of the
    height scan: 66 + 128 observations."""
    cfg = _copy_sections(RobotPerceptCfg(), elspider_air.elspider_air_rough_cfg())
    cfg.raycaster.enable_raycast = True
    cfg.raycaster.attach_to_obs = True
    cfg.raycaster.ray_pattern = "spherical"
    cfg.raycaster.spherical_num_azimuth = 16
    cfg.raycaster.spherical_num_elevation = 8
    cfg.terrain.measure_heights = False
    cfg.env.num_observations = 66 + 128
    return cfg


def _light_confined(tc):
    """A 3 x 3 grid of 6 m confined subterrains with a 3 m border, no
    curriculum (the nav arenas)."""
    tc.num_rows = 3
    tc.num_cols = 3
    tc.terrain_length = 6.0
    tc.terrain_width = 6.0
    tc.border_size = 3.0
    tc.curriculum = False
    return tc


def _nav_cfg_from(src_cfg, start, goal, skip=()) -> RobotNavCfg:
    cfg = _copy_sections(RobotNavCfg(), src_cfg, extra=("trajectory_opt",), skip=skip)
    cfg.commands.resampling_time = 1e6
    cfg.navi_opt.start_pos = list(start)
    cfg.navi_opt.goal_pos = list(goal)
    return cfg


def _confined_nav(cfg: RobotNavCfg, proportions) -> RobotNavCfg:
    """``cfg`` on a light confined arena of one subterrain type, colliding
    with the arena's triangle mesh."""
    cfg.terrain.mesh_type = "confined_trimesh"
    cfg.terrain.confined_terrain_proportions = list(proportions)
    _light_confined(cfg.terrain)
    cfg.terrain.trimesh_contacts = True
    return cfg


def elspider_air_nav_cfg(num_main_envs: int = 4) -> RobotNavCfg:
    return _nav_cfg_from(_elspider_traj_base(num_main_envs), [1.0, 0.0, 0.4], [5.0, 0.0, 0.4])


def elair_nav_barrier_cfg(num_main_envs: int = 4) -> RobotNavCfg:
    """ElSpider navigation over barriers (cumulative proportions: barrier
    only)."""
    return _confined_nav(elspider_air_nav_cfg(num_main_envs), [0.0, 1.0, 1.0, 1.0])


def elair_nav_timberpile_cfg(num_main_envs: int = 4) -> RobotNavCfg:
    """ElSpider navigation through timber piles."""
    return _confined_nav(elspider_air_nav_cfg(num_main_envs), [0.0, 0.0, 1.0, 1.0])


def anymal_c_nav_cfg(num_main_envs: int = 4) -> RobotNavCfg:
    return _nav_cfg_from(anymal_c_traj_sampling_cfg(num_main_envs), [1.0, 0.0, 0.5],
                         [5.0, 0.0, 0.5])


def anymal_c_nav_timberpile_cfg(num_main_envs: int = 4) -> RobotNavCfg:
    """ANYmal-C navigation through timber piles."""
    return _confined_nav(anymal_c_nav_cfg(num_main_envs), [0.0, 0.0, 1.0, 1.0])


def anymal_c_nav_barrier_cfg() -> RobotNavCfg:
    """ANYmal-C "barrier" navigation: the MPC task's sections except its
    terrain, so, as in the JAX package, it runs on the nav config's default
    terrain (the generated rough grid), not on barriers."""
    return _nav_cfg_from(anymal_c_traj_sampling_cfg(num_main_envs=4), [1.0, 0.0, 0.5],
                         [5.0, 0.0, 0.5], skip=("terrain",))


def anymal_c_plan_cfg() -> RobotPlanGradSamplingCfg:
    """State-velocity planning for ANYmal-C (6 base + 12 joint velocities)."""
    cfg = _copy_sections(RobotPlanGradSamplingCfg(), anymal_c_traj_sampling_cfg(num_main_envs=4),
                         extra=("trajectory_opt",))
    cfg.env.num_actions = 18
    return cfg


def anymal_c_percept_cfg() -> RobotPerceptCfg:
    """The ANYmal-C MPC task with 16 x 8 spherical rays: 48 + 128
    observations."""
    src = anymal_c_traj_sampling_cfg(num_main_envs=4)
    cfg = _copy_sections(RobotPerceptCfg(), src, extra=("trajectory_opt", "raycaster"))
    cfg.raycaster.enable_raycast = True
    cfg.raycaster.attach_to_obs = True
    cfg.raycaster.ray_pattern = "spherical"
    cfg.raycaster.spherical_num_azimuth = 16
    cfg.raycaster.spherical_num_elevation = 8
    cfg.env.num_observations = 48 + 128
    return cfg
