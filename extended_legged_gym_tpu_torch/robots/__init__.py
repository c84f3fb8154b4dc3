"""Task registrations (the ported subset of ``robots/__init__.py``)."""
from __future__ import annotations

from ..envs.legged_robot import LeggedRobot
from ..utils.task_registry import task_registry
from . import (anymal_c, anymal_c_traj, cyberdog2, cyberdog2_standdance, cyberdog2_walk,
               elspider_air, franka, task_variants)

task_registry.register("anymal_c_rough", LeggedRobot, anymal_c.anymal_c_rough_cfg,
                       anymal_c.anymal_c_rough_ppo_cfg)
task_registry.register("anymal_c_rough_raycast", LeggedRobot, anymal_c.anymal_c_rough_raycast_cfg,
                       lambda: anymal_c.anymal_c_rough_ppo_cfg("rough_raycast_anymal_c"))
task_registry.register("anymal_c_flat", LeggedRobot, anymal_c.anymal_c_flat_cfg,
                       lambda: anymal_c.anymal_c_ppo_cfg("flat_anymal_c"))
task_registry.register("anymal_c_flat_sea", LeggedRobot, anymal_c.anymal_c_flat_sea_cfg,
                       lambda: anymal_c.anymal_c_ppo_cfg("flat_sea_anymal_c"))
task_registry.register("anymal_c_traj_grad_sampling", anymal_c_traj.AnymalCTrajGradSampling,
                       anymal_c_traj.anymal_c_traj_sampling_cfg, None)
task_registry.register("elspider_air_flat", elspider_air.ElSpider,
                       elspider_air.elspider_air_flat_cfg, elspider_air.elspider_air_ppo_cfg)
task_registry.register("franka", franka.Franka, franka.franka_cfg, franka.franka_ppo_cfg)
task_registry.register("franka_batch_rollout", franka.Franka,
                       task_variants.franka_batch_rollout_cfg, franka.franka_ppo_cfg)
task_registry.register("cyberdog2_walk", LeggedRobot, cyberdog2.cyberdog2_walk_cfg,
                       cyberdog2.cyberdog2_ppo_cfg)
task_registry.register("cyber2_stand", cyberdog2_standdance.CyberStandDanceEnv,
                       cyberdog2_standdance.cyberdog2_standdance_cfg,
                       cyberdog2_standdance.cyberdog2_standdance_ppo_cfg)
for _name, _cls in (("cyber2_walk", cyberdog2_walk.CyberWalkEnv),
                    ("cyber2_hop", cyberdog2_walk.CyberHopEnv),
                    ("cyber2_bounce", cyberdog2_walk.CyberBounceEnv)):
    task_registry.register(_name, _cls, cyberdog2_walk.cyberdog2_c2walk_cfg,
                           cyberdog2_walk.cyberdog2_c2walk_ppo_cfg)
