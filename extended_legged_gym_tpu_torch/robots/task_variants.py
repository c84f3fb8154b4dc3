"""Task variants built from other tasks' config sections and envs (the
ported part of ``robots/task_variants.py``): the Franka batch rollout, the
ANYmal-C rough teacher, the Go2 pose, load and stand variants, the ElSpider
pose variant and the hanging (fixed-base) ElSpider foot tracking."""
from __future__ import annotations

from ..envs.batch_rollout import RobotBatchRolloutCfg
from ..envs.legged_robot_config import LeggedRobotCfg
from . import anymal_c, elspider_air, go2
from . import franka as franka_mod
from .anymal_c_variants import LoadAdaptAnymal, PoseAnymal, StandAnymal


def _copy_sections(dst, src, extra=()):
    """Overlay the robot sections of ``src`` onto the variant config ``dst``."""
    for f in ("env", "terrain", "commands", "init_state", "control", "asset",
              "domain_rand", "rewards", "normalization", "noise", "sim") + tuple(extra):
        if hasattr(src, f):
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
