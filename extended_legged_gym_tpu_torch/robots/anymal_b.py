"""ANYmal-B task configs (port of ``robots/anymal_b.py``): the ANYmal-C
rough task on ANYmal-B's model (13 bodies, 12 joints, 4 feet), read in place
from the JAX package's committed JSON."""
from __future__ import annotations

import os

from ..envs.legged_robot_config import LeggedRobotCfg, LeggedRobotCfgPPO
from .anymal_c import ANYMAL_C_DEFAULT_ANGLES, _DATA, anymal_c_rough_cfg  # noqa: F401


def anymal_b_rough_cfg() -> LeggedRobotCfg:
    cfg = anymal_c_rough_cfg()
    cfg.asset.file = os.path.join(_DATA, "anymal_b.json")
    cfg.asset.name = "anymal_b"
    return cfg


def anymal_b_ppo_cfg() -> LeggedRobotCfgPPO:
    t = LeggedRobotCfgPPO()
    t.runner.experiment_name = "rough_anymal_b"
    return t
