"""Train the terrain estimator on a registered task (port of
``scripts/terrain_est_train.py``): the task's env with the depth camera and
the ray caster switched on, then ``TerrainEstimatorRunner.learn`` with
random actions.

Usage, from the repository root (on a CUDA card; ``--device cpu`` runs the
plain physics on the CPU):

  python -m extended_legged_gym_tpu_torch.scripts.terrain_est_train \\
      [--task anymal_c_rough] [--num_envs N] [--max_iterations 500] [--seed 0] \\
      [--run_name NAME] [--device cuda]

The checkpoint goes to ``logs/terrain_estimator/<task>[_<run_name>]/estimator_final.pkl``
(the JAX runner's layout) and the losses to ``metrics.jsonl`` beside it.
"""
from __future__ import annotations

import os


def estimator_env(args):
    """The task's env with both sensor streams on (depth camera, ray caster)."""
    from .. import robots  # noqa: F401  (populates the registry)
    from ..utils.task_registry import task_registry

    env_cfg, train_cfg = task_registry.get_cfgs(args.task)
    env_cfg.depth.camera_type = env_cfg.depth.camera_type or "Warp"
    env_cfg.raycaster.enable_raycast = True
    env, _ = task_registry.make_env(args.task, args, env_cfg)
    return env, train_cfg


def train(args):
    from ..rl.terrain_estimator_runner import TerrainEstimatorRunner

    env, _ = estimator_env(args)
    log_dir = os.path.join("logs", "terrain_estimator",
                           args.task + (f"_{args.run_name}" if args.run_name else ""))
    runner = TerrainEstimatorRunner(env, log_dir=log_dir, seed=args.seed or 0)
    last = runner.learn(args.max_iterations or 500)
    ckpt = os.path.join(log_dir, "estimator_final.pkl")
    runner.save(ckpt)
    print("saved estimator ->", ckpt)
    return last


if __name__ == "__main__":
    from ..utils.task_registry import get_args

    train(get_args(default_task="anymal_c_rough"))
