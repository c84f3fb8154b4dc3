"""Evaluate a terrain-estimator checkpoint (port of
``scripts/terrain_est_play.py``): the play loop's prediction MSE / MAE
against the true ray distances.

Usage, from the repository root (on a CUDA card; ``--device cpu`` runs the
plain physics on the CPU):

  TE_CKPT=logs/terrain_estimator/<task>/estimator_final.pkl \\
  python -m extended_legged_gym_tpu_torch.scripts.terrain_est_play \\
      [--task anymal_c_rough] [--num_envs N] [--max_iterations 200] [--device cuda]

Without ``TE_CKPT`` it reads ``logs/terrain_estimator/<task>/estimator_final.pkl``,
and plays a fresh network where there is none.
"""
from __future__ import annotations

import os


def play(args):
    from ..rl.terrain_estimator_runner import TerrainEstimatorRunner
    from .terrain_est_train import estimator_env

    env, _ = estimator_env(args)
    runner = TerrainEstimatorRunner(env, seed=args.seed or 0)
    ckpt = os.environ.get("TE_CKPT") or os.path.join(
        "logs", "terrain_estimator", args.task, "estimator_final.pkl")
    if os.path.exists(ckpt):
        runner.load(ckpt)
        print("loaded estimator <-", ckpt)
    else:
        print(f"no checkpoint at {ckpt}; playing with a fresh network")
    stats = runner.play(num_steps=args.max_iterations or 200)
    print("terrain-estimator eval:", stats)
    return stats


if __name__ == "__main__":
    from ..utils.task_registry import get_args

    play(get_args(default_task="anymal_c_rough"))
