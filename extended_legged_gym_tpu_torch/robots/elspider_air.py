"""ElSpider Air hexapod task configs and env (port of the rough base and
flat configs of ``robots/elspider_air.py``): 19 bodies, 18 joints, 46
collision spheres, 6 feet.  The robot model is read in place from the JAX
package's committed JSON, whose default joint angles the env uses."""
from __future__ import annotations

import os

from ..envs.legged_robot import LeggedRobot
from ..envs.legged_robot_config import LeggedRobotCfg, LeggedRobotCfgPPO
from .anymal_c import _DATA

# foot order of the model (alphabetical): 0 LB, 1 LF, 2 LM, 3 RB, 4 RF, 5 RM;
# tripod groups (LB, LF, RM) and (LM, RB, RF), in phase within a group and
# in antiphase across
TRIPODS = ((0, 1, 5), (2, 3, 4))

class ElSpider(LeggedRobot):
    """The hexapod with the tripod-gait synchronization term."""

    def _reward_gait_2_step(self, s, ctx):
        sync = sum(self._sync_rew(ctx, g[a], g[b]) for g in TRIPODS
                   for a, b in ((0, 1), (0, 2), (1, 2))) / 6
        async_ = sum(self._async_rew(ctx, a, b) for a in TRIPODS[0] for b in TRIPODS[1]) / 9
        return (sync + async_) * self._gait_active(s)

def elspider_air_rough_cfg() -> LeggedRobotCfg:
    """The rough base the flat task builds on.  Its ``trimesh`` terrain
    without ``trimesh_contacts`` is the generated heightfield that B2
    contacts, as ``anymal_c_rough``'s; the rough task is not registered
    yet."""
    cfg = LeggedRobotCfg()
    cfg.env.num_envs = 4096
    cfg.env.num_actions = 18
    cfg.env.num_observations = 66 + 187
    cfg.terrain.mesh_type = "trimesh"
    cfg.terrain.terrain_length = 8.0
    cfg.terrain.terrain_width = 8.0
    cfg.terrain.num_rows = 10
    cfg.terrain.num_cols = 10
    cfg.terrain.max_init_terrain_level = 0
    cfg.terrain.terrain_proportions = [0.1, 0.1, 0.3, 0.3, 0.2]
    cfg.init_state.pos = [0.0, 0.0, 0.4]
    cfg.control.stiffness = {"HAA": 80.0, "HFE": 80.0, "KFE": 80.0}
    cfg.control.damping = {"HAA": 2.0, "HFE": 2.0, "KFE": 2.0}
    cfg.control.action_scale = 0.5
    cfg.asset.file = os.path.join(_DATA, "elspider_air.json")
    cfg.asset.name = "elspider_air"
    cfg.asset.foot_name = "FOOT"
    cfg.asset.penalize_contacts_on = ["SHANK", "THIGH"]
    cfg.asset.terminate_after_contacts_on = ["base"]
    cfg.rewards.base_height_target = 0.28
    cfg.rewards.max_contact_force = 500.0
    return cfg

def elspider_air_flat_cfg() -> LeggedRobotCfg:
    """The flat task (66-dim observations) with staged scales: every penalty
    at 25% until the mean episode return passes 8.0, then the reference
    scales, feet_slip only from stage 1."""
    cfg = elspider_air_rough_cfg()
    cfg.env.num_observations = 66
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.measure_heights = False
    cfg.terrain.curriculum = False
    cfg.rewards.multi_stage_rewards = True
    cfg.rewards.reward_stage_threshold = 8.0
    cfg.rewards.reward_max_stage = 1
    sc = cfg.rewards.scales
    sc.tracking_lin_vel = 1.0
    sc.tracking_ang_vel = 0.5
    sc.lin_vel_z = [-0.5, -2.0]
    sc.ang_vel_xy = [-0.0125, -0.05]
    sc.orientation = [-1.25, -5.0]
    sc.torques = [-2.5e-6, -0.00001]
    sc.dof_acc = [-1.25e-8, -5e-8]
    sc.base_height = [-2.0, -8.0]
    sc.feet_slip = [-0.0, -0.4]
    sc.feet_air_time = 0.8
    sc.collision = [-0.25, -1.0]
    sc.action_rate = [-0.00025, -0.001]
    sc.dof_pos_limits = [-0.25, -1.0]
    sc.gait_2_step = [-1.25, -5.0]
    return cfg

def elspider_air_ppo_cfg() -> LeggedRobotCfgPPO:
    """The base [512, 256, 128] actor and critic."""
    t = LeggedRobotCfgPPO()
    t.runner.experiment_name = "flat_elspider_air"
    return t
