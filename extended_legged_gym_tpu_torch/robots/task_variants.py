"""Task variants built from other tasks' config sections and envs (port of
``robots/task_variants.py``): the Franka batch rollout, the ANYmal-C rough
teacher, the Go2 pose, load and stand variants, the ElSpider pose variant,
the hanging (fixed-base) ElSpider foot tracking, the ElSpider planning and
ray-perception tasks, the navigation tasks (open ground, and the confined
barrier and timber-pile arenas with mesh contacts), the batch-rollout and
sampling-MPC tasks of Go2, Cassie, ANYmal-C and ElSpider Air (its gait
scheduler rewards), and base-pose adaptation in a confined arena."""
from __future__ import annotations

import os

import torch

from ..envs.batch_rollout import (RobotBatchRolloutCfg, RobotTrajGradSampling,
                                  RobotTrajGradSamplingCfg)
from ..envs.legged_robot_config import LeggedRobotCfg, LeggedRobotCfgPPO, TerrainCfg
from ..envs.navigation import RobotNavCfg
from ..envs.percept import RobotPerceptCfg
from ..envs.plan_grad import RobotPlanGradSamplingCfg
from ..envs.pose_adapt import BasePoseAdapt, BasePoseAdaptCfg
from ..terrain.confined import TerrainConfined
from ..utils.gait_scheduler import (AsyncGaitScheduler, AsyncGaitSchedulerCfg, GaitScheduler,
                                    GaitSchedulerCfg)
from . import anymal_c, cassie as cassie_mod, elspider_air, go2
from . import franka as franka_mod
from .anymal_c import _DATA
from .anymal_c_traj import AnymalCTrajGradSampling, anymal_c_traj_sampling_cfg
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


# --- batch-rollout and sampling-MPC tasks ---

class Go2TrajGradSampling(AnymalCTrajGradSampling):
    """The DIAL-MPC gait rewards with Go2's foot order FL, FR, RL, RR (the
    identity permutation of the gait tables)."""
    foot_perm = (0, 1, 2, 3)


def go2_batch_rollout_cfg(num_main_envs: int = 16) -> RobotBatchRolloutCfg:
    """The rough Go2 task's sections with ``num_main_envs`` main envs."""
    cfg = _copy_sections(RobotBatchRolloutCfg(), go2.go2_rough_cfg())
    cfg.env.num_envs = num_main_envs
    return cfg


def go2_batch_rollout_flat_cfg(num_main_envs: int = 16) -> RobotBatchRolloutCfg:
    cfg = _copy_sections(RobotBatchRolloutCfg(), go2.go2_flat_cfg())
    cfg.env.num_envs = num_main_envs
    return cfg


def go2_traj_grad_sampling_cfg(num_main_envs: int = 1) -> RobotTrajGradSamplingCfg:
    """Go2's DIAL-MPC tuning with the gait, upright, height, velocity,
    energy and alive terms switched on."""
    cfg = go2.go2_dialmpc_flat_cfg(num_main_envs)
    sc = cfg.rewards.scales
    sc.gaits = 0.1
    sc.upright = 0.5
    sc.height = 1.0
    sc.vel = 1.0
    sc.ang_vel = 0.5
    sc.energy = -0.0001
    sc.alive = 1.0
    return cfg


def cassie_traj_grad_sampling_cfg(num_main_envs: int = 1) -> RobotTrajGradSamplingCfg:
    """The rough Cassie task's sections on a plane, without the 11 x 11
    height scan in the observation (48 of its 169), no randomization, pushes
    or noise, rewards allowed negative."""
    cfg = _copy_sections(RobotTrajGradSamplingCfg(), cassie_mod.cassie_rough_cfg())
    cfg.env.num_envs = num_main_envs
    cfg.env.num_observations = 48
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.measure_heights = False
    cfg.terrain.curriculum = False
    cfg.domain_rand.randomize_friction = False
    cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.push_robots = False
    cfg.noise.add_noise = False
    cfg.rewards.only_positive_rewards = False
    return cfg


class ElSpiderAirTrajGradSampling(elspider_air.ElSpider, RobotTrajGradSampling):
    """The hexapod's sampling-MPC env: gait-scheduler tracking rewards and a
    termination when upside down."""

    def __init__(self, cfg, **kw):
        super().__init__(cfg, **kw)
        gcfg = GaitSchedulerCfg()
        gcfg.dt = self.dt
        gcfg.period = 1.4
        gcfg.swing_height = 0.07
        # tripod phases in the model's foot order LB, LF, LM, RB, RF, RM
        gcfg.foot_phases = [0.0, 0.0, 0.5, 0.5, 0.5, 0.0]
        self.gait_scheduler = GaitScheduler(gcfg, device=self.device)
        acfg = AsyncGaitSchedulerCfg()
        acfg.dt = self.dt
        # tripod groups (LB, LF, RM) and (LM, RB, RF)
        self.async_gait_scheduler = AsyncGaitScheduler(acfg, [(0, 1, 5), (2, 3, 4)],
                                                       device=self.device)

    def _check_termination(self, state):
        reset, time_out = super()._check_termination(state)
        return reset | (state.projected_gravity[:, 2] > 0), time_out

    def _gait_time(self, s):
        t = getattr(s, "t", None)
        return s.episode_length.to(torch.float32) * self.dt if t is None else t

    def _reward_gait_scheduler(self, s, ctx):
        """Foot heights against the scheduler's clock."""
        z = s.foot_positions[:, :, 2] - self.model.torch(self.device)["foot_radius"][None, :]
        return self.gait_scheduler.reward_foot_z_track(z, self._gait_time(s))

    def _reward_async_gait_scheduler(self, s, ctx):
        """Weighted joint-alignment and nominal-position penalties."""
        a = self.async_gait_scheduler
        return -(a.reward_dof_align(s.phys.joint_pos) * a.cfg.dof_align
                 + a.reward_dof_nominal_pos(s.phys.joint_pos, self.default_dof_pos)
                 * a.cfg.dof_nominal_pos)


def elspider_air_batch_rollout_cfg(num_main_envs: int = 16) -> RobotBatchRolloutCfg:
    """The rough ElSpider task's sections with ``num_main_envs`` main envs."""
    cfg = _copy_sections(RobotBatchRolloutCfg(), elspider_air.elspider_air_rough_cfg())
    cfg.env.num_envs = num_main_envs
    return cfg


def elspider_air_batch_rollout_flat_cfg(num_main_envs: int = 16) -> RobotBatchRolloutCfg:
    cfg = _copy_sections(RobotBatchRolloutCfg(), elspider_air.elspider_air_flat_cfg())
    cfg.env.num_envs = num_main_envs
    cfg.rewards.multi_stage_rewards = False
    cfg.rewards.scales.feet_slip = -0.1
    return cfg


def elspider_air_traj_grad_sampling_cfg(num_main_envs: int = 1) -> RobotTrajGradSamplingCfg:
    """The flat sampling-MPC base with the gait-scheduler rewards in place of
    the tripod synchronization term."""
    cfg = _elspider_traj_base(num_main_envs)
    sc = cfg.rewards.scales
    sc.gait_2_step = 0.0
    sc.gait_scheduler = 1.0
    sc.async_gait_scheduler = 0.5
    return cfg


def elspider_air_dialmpc_cfg(num_main_envs: int = 4) -> RobotTrajGradSamplingCfg:
    """The same on the rough task's generated terrain, with its height scan
    (66 + 187 observations)."""
    cfg = elspider_air_traj_grad_sampling_cfg(num_main_envs)
    cfg.terrain = elspider_air.elspider_air_rough_cfg().terrain
    cfg.env.num_observations = 66 + 187
    return cfg


def elspider_air_dialmpc_flat_cfg(num_main_envs: int = 32) -> RobotTrajGradSamplingCfg:
    """32 main envs of 127 + 1 samples each."""
    cfg = elspider_air_traj_grad_sampling_cfg(num_main_envs)
    cfg.trajectory_opt.num_samples = 127
    return cfg


def anymal_c_batch_rollout_cfg(num_main_envs: int = 16) -> RobotBatchRolloutCfg:
    """The rough ANYmal-C task's sections, its staged reward lists resolved
    to their final scales (no runner advances the stage here)."""
    cfg = _copy_sections(RobotBatchRolloutCfg(), anymal_c.anymal_c_rough_cfg())
    cfg.env.num_envs = num_main_envs
    cfg.rewards.multi_stage_rewards = False
    return cfg


def anymal_c_batch_rollout_flat_cfg(num_main_envs: int = 16) -> RobotBatchRolloutCfg:
    cfg = _copy_sections(RobotBatchRolloutCfg(), anymal_c.anymal_c_flat_cfg())
    cfg.env.num_envs = num_main_envs
    cfg.rewards.multi_stage_rewards = False
    return cfg


def anymal_c_dialmpc_flat_cfg(num_main_envs: int = 32) -> RobotTrajGradSamplingCfg:
    """The ANYmal-C MPC task at 32 main envs with the DIAL-MPC terms."""
    cfg = anymal_c_traj_sampling_cfg(num_main_envs)
    sc = cfg.rewards.scales
    sc.gaits = 0.1
    sc.upright = 0.5
    sc.height = 1.0
    sc.vel = 1.0
    sc.ang_vel = 0.5
    sc.energy = -0.0001
    sc.alive = 1.0
    return cfg


# --- base-pose adaptation in a confined arena ---

def _confined_terrain(num_envs: int, seed: int = 0):
    """A 3 x 3 grid of 6 m confined subterrains with a 3 m border and its
    triangle mesh."""
    tc = TerrainCfg()
    tc.num_rows = 3
    tc.num_cols = 3
    tc.terrain_length = 6.0
    tc.terrain_width = 6.0
    tc.border_size = 3.0
    return TerrainConfined(tc, num_envs, seed=seed).to_device()


class _RegisteredPoseAdapt(BasePoseAdapt):
    """The registry's constructor: builds the confined terrain, with contacts
    on its triangle mesh where ``cfg.sim.trimesh_contacts``."""

    def __init__(self, cfg: BasePoseAdaptCfg, terrain=None, device="cuda", **kw):
        if terrain is None:
            terrain = _confined_terrain(cfg.env.num_envs, getattr(cfg, "seed", 0))
        if getattr(cfg.sim, "trimesh_contacts", False) and terrain.trimesh is not None:
            terrain = terrain.replace(contact_trimesh=True)
        super().__init__(cfg, terrain, device=device, **kw)


class AnymalCBasePoseAdapt(_RegisteredPoseAdapt):
    pass


class AnymalCBasePoseCtrl(_RegisteredPoseAdapt):
    """Pose control with the weight on velocity tracking."""


class ElMiniBasePoseAdapt(_RegisteredPoseAdapt):
    pass


class ElMiniBasePoseCtrl(_RegisteredPoseAdapt):
    pass


def anymal_c_base_pose_adapt_cfg() -> BasePoseAdaptCfg:
    """The full ANYmal-C body (composite mass and inertia, its collision
    spheres) steered by the base wrench, on mesh contacts."""
    cfg = BasePoseAdaptCfg()
    cfg.asset.robot_model = os.path.join(_DATA, "anymal_c.json")
    cfg.asset.nominal_height = 0.5
    cfg.sim.trimesh_contacts = True
    return cfg


def anymal_c_base_pose_ctrl_cfg() -> BasePoseAdaptCfg:
    cfg = anymal_c_base_pose_adapt_cfg()
    cfg.rewards.lin_vel_tracking = 1.5
    cfg.rewards.ang_vel_tracking = 1.0
    cfg.rewards.terrain_conformity_penalty = 0.3
    return cfg


def el_mini_base_pose_adapt_cfg() -> BasePoseAdaptCfg:
    """The same with the hexapod's body."""
    cfg = BasePoseAdaptCfg()
    cfg.asset.robot_model = os.path.join(_DATA, "elspider_air.json")
    cfg.asset.nominal_height = 0.25
    cfg.sim.trimesh_contacts = True
    return cfg


def el_mini_base_pose_ctrl_cfg() -> BasePoseAdaptCfg:
    cfg = el_mini_base_pose_adapt_cfg()
    cfg.rewards.lin_vel_tracking = 1.5
    cfg.rewards.ang_vel_tracking = 1.0
    cfg.rewards.terrain_conformity_penalty = 0.3
    return cfg


def pose_adapt_train_cfg() -> LeggedRobotCfgPPO:
    """[128, 64, 32] actor and critic, 24 steps per env, 1500 iterations."""
    cfg = LeggedRobotCfgPPO()
    cfg.policy.actor_hidden_dims = [128, 64, 32]
    cfg.policy.critic_hidden_dims = [128, 64, 32]
    cfg.runner.num_steps_per_env = 24
    cfg.runner.max_iterations = 1500
    cfg.runner.experiment_name = "base_pose_adapt"
    return cfg
