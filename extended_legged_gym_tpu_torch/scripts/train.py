"""Train a registered task with PPO (port of ``scripts/train.py``).

Usage, from the repository root (on a CUDA card; ``--device cpu`` runs the
plain physics on the CPU):

  python -m extended_legged_gym_tpu_torch.scripts.train --task anymal_c_flat \\
      [--seed 2] [--num_envs 4096] [--max_iterations 2000] \\
      [--experiment_name flat_anymal_c_torch] [--run_name NAME] \\
      [--resume [--load_run RUN] [--checkpoint N]] [--device cuda]

Checkpoints and ``metrics.jsonl`` go to
``logs/<experiment_name>/<date>_<run_name>/``; ``--resume`` loads the latest
run's last checkpoint (parameters, Adam state, learning rate) and trains
``max_iterations`` more.
"""
from __future__ import annotations


def train(args):
    from .. import robots  # noqa: F401  (populates the registry)
    from ..utils.task_registry import task_registry

    env, _ = task_registry.make_env(args.task, args)
    runner, train_cfg = task_registry.make_alg_runner(env, args.task, args)
    if getattr(args, "warmstart_pt", None):
        runner.warmstart_from_reference(args.warmstart_pt)
    return runner.learn(train_cfg.runner.max_iterations)


if __name__ == "__main__":
    from ..utils.task_registry import get_args

    train(get_args())
