"""Task variants built from other tasks' config sections (the ported part of
``robots/task_variants.py``): the Franka batch rollout."""
from __future__ import annotations

from ..envs.batch_rollout import RobotBatchRolloutCfg
from . import franka as franka_mod


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
