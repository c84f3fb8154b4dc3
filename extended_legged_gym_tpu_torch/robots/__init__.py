"""Task registrations (the ported subset of ``robots/__init__.py``)."""
from __future__ import annotations

from ..envs.legged_robot import LeggedRobot
from ..utils.task_registry import task_registry
from . import anymal_c, anymal_c_traj, elspider_air

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
