"""Task registrations (port of ``robots/__init__.py``): the JAX registry's 59
tasks."""
from __future__ import annotations

from ..envs.batch_rollout import RobotBatchRollout, RobotTrajGradSampling
from ..envs.legged_robot import LeggedRobot
from ..envs.navigation import RobotBatchRolloutNav, RobotNavCfg  # noqa: F401
from ..envs.percept import RobotBatchRolloutPercept, RobotPerceptCfg  # noqa: F401
from ..envs.plan_grad import RobotPlanGradSampling, RobotPlanGradSamplingCfg  # noqa: F401
from ..utils.task_registry import task_registry
from . import (a1, anymal_b, anymal_c, anymal_c_traj, anymal_c_variants, cassie, cyberdog2,
               cyberdog2_standdance, cyberdog2_walk, elspider_air, franka, go2, task_variants)

task_registry.register("anymal_c_rough", LeggedRobot, anymal_c.anymal_c_rough_cfg,
                       anymal_c.anymal_c_rough_ppo_cfg)
task_registry.register("anymal_c_rough_raycast", LeggedRobot, anymal_c.anymal_c_rough_raycast_cfg,
                       lambda: anymal_c.anymal_c_rough_ppo_cfg("rough_raycast_anymal_c"))
task_registry.register("anymal_c_flat", LeggedRobot, anymal_c.anymal_c_flat_cfg,
                       lambda: anymal_c.anymal_c_ppo_cfg("flat_anymal_c"))
task_registry.register("anymal_c_flat_sea", LeggedRobot, anymal_c.anymal_c_flat_sea_cfg,
                       lambda: anymal_c.anymal_c_ppo_cfg("flat_sea_anymal_c"))
task_registry.register("anymal_c_flat_obstacles", LeggedRobot,
                       anymal_c.anymal_c_flat_obstacles_cfg,
                       lambda: anymal_c.anymal_c_ppo_cfg("flat_obstacles_anymal_c"))
task_registry.register("anymal_c_traj_grad_sampling", anymal_c_traj.AnymalCTrajGradSampling,
                       anymal_c_traj.anymal_c_traj_sampling_cfg, None)
task_registry.register("anymal_b", LeggedRobot, anymal_b.anymal_b_rough_cfg,
                       anymal_b.anymal_b_ppo_cfg)
task_registry.register("a1", LeggedRobot, a1.a1_rough_cfg, a1.a1_ppo_cfg)
task_registry.register("a1_flat", LeggedRobot, a1.a1_flat_cfg, a1.a1_ppo_cfg)
task_registry.register("go2_rough", LeggedRobot, go2.go2_rough_cfg, go2.go2_ppo_cfg)
task_registry.register("go2_flat", LeggedRobot, go2.go2_flat_cfg, go2.go2_ppo_cfg)
task_registry.register("cassie", LeggedRobot, cassie.cassie_rough_cfg, cassie.cassie_ppo_cfg)
task_registry.register("cyberdog2_walk", LeggedRobot, cyberdog2.cyberdog2_walk_cfg,
                       cyberdog2.cyberdog2_ppo_cfg)
task_registry.register("elspider_air_rough", elspider_air.ElSpider,
                       elspider_air.elspider_air_rough_cfg, elspider_air.elspider_air_ppo_cfg)
task_registry.register("elspider_air_flat", elspider_air.ElSpider,
                       elspider_air.elspider_air_flat_cfg, elspider_air.elspider_air_ppo_cfg)
task_registry.register("franka", franka.Franka, franka.franka_cfg, franka.franka_ppo_cfg)

# ANYmal-C variants
for _name, _cls, _cfg in (
        ("load_adapt_anymal_c", anymal_c_variants.LoadAdaptAnymal,
         anymal_c_variants.load_adapt_anymal_cfg),
        ("pose_anymal_c", anymal_c_variants.PoseAnymal, anymal_c_variants.pose_anymal_cfg),
        ("stand_anymal_c", anymal_c_variants.StandAnymal, anymal_c_variants.stand_anymal_cfg),
        ("anymal_c_student", anymal_c_variants.AnymalStudent,
         anymal_c_variants.anymal_c_student_cfg)):
    task_registry.register(_name, _cls, _cfg,
                           lambda _exp=_name: anymal_c.anymal_c_ppo_cfg(_exp))
task_registry.register("foot_track_elspider_air_flat", elspider_air.FootTrackElSpider,
                       elspider_air.foot_track_elspider_air_flat_cfg,
                       elspider_air.elspider_air_ppo_cfg)

# Go2 variants
task_registry.register("pose_go2_flat", task_variants.PoseGo2, task_variants.pose_go2_flat_cfg,
                       go2.go2_ppo_cfg)
task_registry.register("load_adapt_go2_flat", task_variants.LoadAdaptGo2,
                       task_variants.load_adapt_go2_flat_cfg, go2.go2_ppo_cfg)
task_registry.register("stand_go2_flat", task_variants.StandGo2, task_variants.stand_go2_flat_cfg,
                       go2.go2_ppo_cfg)

# the ANYmal-C rough teacher, the ElSpider pose and hanging foot-tracking tasks
task_registry.register("anymal_c_rough_teacher", LeggedRobot,
                       task_variants.anymal_c_rough_teacher_cfg,
                       lambda: anymal_c.anymal_c_ppo_cfg("anymal_c_rough_teacher"))
task_registry.register("pose_elspider_air_flat", task_variants.PoseElSpider,
                       task_variants.pose_elspider_air_flat_cfg, elspider_air.elspider_air_ppo_cfg)
task_registry.register("foot_track_elspider_air_hang", elspider_air.FootTrackElSpider,
                       task_variants.foot_track_elspider_air_hang_cfg,
                       elspider_air.elspider_air_ppo_cfg)

# CyberDog2
task_registry.register("cyber2_stand", cyberdog2_standdance.CyberStandDanceEnv,
                       cyberdog2_standdance.cyberdog2_standdance_cfg,
                       cyberdog2_standdance.cyberdog2_standdance_ppo_cfg)
for _name, _cls in (("cyber2_walk", cyberdog2_walk.CyberWalkEnv),
                    ("cyber2_hop", cyberdog2_walk.CyberHopEnv),
                    ("cyber2_bounce", cyberdog2_walk.CyberBounceEnv)):
    task_registry.register(_name, _cls, cyberdog2_walk.cyberdog2_c2walk_cfg,
                           cyberdog2_walk.cyberdog2_c2walk_ppo_cfg)

# Franka batch rollout
task_registry.register("franka_batch_rollout", franka.Franka,
                       task_variants.franka_batch_rollout_cfg, franka.franka_ppo_cfg)

# planning, perception and navigation (confined arenas on the engine route)
task_registry.register("anymal_c_plan_grad_sampling", RobotPlanGradSampling,
                       task_variants.anymal_c_plan_cfg, None)
task_registry.register("elspider_air_plan_grad_sampling", RobotPlanGradSampling,
                       task_variants.elspider_air_plan_grad_sampling_cfg, None)
task_registry.register("anymal_c_percept", RobotBatchRolloutPercept,
                       task_variants.anymal_c_percept_cfg, None)
task_registry.register("elspider_air_rough_raycast", RobotBatchRolloutPercept,
                       task_variants.elspider_air_rough_raycast_cfg,
                       elspider_air.elspider_air_ppo_cfg)
for _name, _cfg in (("anymal_c_nav", task_variants.anymal_c_nav_cfg),
                    ("anymal_c_nav_barrier", task_variants.anymal_c_nav_barrier_cfg),
                    ("anymal_c_timberpile_nav", task_variants.anymal_c_nav_timberpile_cfg),
                    ("elspider_air_nav", task_variants.elspider_air_nav_cfg),
                    ("elair_barrier_nav", task_variants.elair_nav_barrier_cfg),
                    ("elair_timberpile_nav", task_variants.elair_nav_timberpile_cfg)):
    task_registry.register(_name, RobotBatchRolloutNav, _cfg, None)

# batch rollouts, sampling MPC and base-pose adaptation
task_registry.register("go2_dialmpc_flat", RobotTrajGradSampling, go2.go2_dialmpc_flat_cfg, None)
task_registry.register("go2_batch_rollout", RobotBatchRollout, task_variants.go2_batch_rollout_cfg,
                       go2.go2_ppo_cfg)
task_registry.register("go2_batch_rollout_flat", RobotBatchRollout,
                       task_variants.go2_batch_rollout_flat_cfg, go2.go2_ppo_cfg)
task_registry.register("go2_traj_grad_sampling", task_variants.Go2TrajGradSampling,
                       task_variants.go2_traj_grad_sampling_cfg, None)
task_registry.register("cassie_traj_grad_sampling", RobotTrajGradSampling,
                       task_variants.cassie_traj_grad_sampling_cfg, None)
for _name, _cfg in (("anymal_c_batch_rollout", task_variants.anymal_c_batch_rollout_cfg),
                    ("anymal_c_batch_rollout_flat", task_variants.anymal_c_batch_rollout_flat_cfg)):
    task_registry.register(_name, RobotBatchRollout, _cfg,
                           lambda _exp=_name: anymal_c.anymal_c_ppo_cfg(_exp))
task_registry.register("anymal_c_dialmpc_flat", anymal_c_traj.AnymalCTrajGradSampling,
                       task_variants.anymal_c_dialmpc_flat_cfg, None)
for _name, _cfg in (("elspider_air_batch_rollout", task_variants.elspider_air_batch_rollout_cfg),
                    ("elspider_air_batch_rollout_flat",
                     task_variants.elspider_air_batch_rollout_flat_cfg)):
    task_registry.register(_name, elspider_air.ElSpider, _cfg, elspider_air.elspider_air_ppo_cfg)
for _name, _cfg in (("elspider_air_traj_grad_sampling",
                     task_variants.elspider_air_traj_grad_sampling_cfg),
                    ("elspider_air_dialmpc", task_variants.elspider_air_dialmpc_cfg),
                    ("elspider_air_dialmpc_flat", task_variants.elspider_air_dialmpc_flat_cfg)):
    task_registry.register(_name, task_variants.ElSpiderAirTrajGradSampling, _cfg, None)
for _name, _cls, _cfg in (
        ("anymal_c_base_pose_adapt", task_variants.AnymalCBasePoseAdapt,
         task_variants.anymal_c_base_pose_adapt_cfg),
        ("anymal_c_base_pose_ctrl", task_variants.AnymalCBasePoseCtrl,
         task_variants.anymal_c_base_pose_ctrl_cfg),
        ("el_mini_base_pose_adapt", task_variants.ElMiniBasePoseAdapt,
         task_variants.el_mini_base_pose_adapt_cfg),
        ("el_mini_base_pose_ctrl", task_variants.ElMiniBasePoseCtrl,
         task_variants.el_mini_base_pose_ctrl_cfg)):
    task_registry.register(_name, _cls, _cfg, task_variants.pose_adapt_train_cfg)
