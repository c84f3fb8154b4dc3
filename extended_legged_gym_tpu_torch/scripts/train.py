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

Data-parallel training on N cards of one machine (one process per card,
NCCL; ``--device cpu`` joins the processes over gloo instead):

  torchrun --nproc_per_node N -m extended_legged_gym_tpu_torch.scripts.train \
      --task anymal_c_flat --num_envs 4096

Under torchrun (``WORLD_SIZE`` > 1) each process joins the group
(``parallel/distributed.py::init_multi_host``), builds ``num_envs / N`` of
the ``--num_envs`` envs (a count that does not divide is refused) with its
env seed and action noise offset by its rank, and trains them with the
data-parallel runner (``rl/runner.py``); only rank 0 logs and saves, and
``--resume`` loads on rank 0, which broadcasts.
"""
from __future__ import annotations

import os


def train(args):
    from .. import robots  # noqa: F401  (populates the registry)
    from ..parallel.distributed import init_multi_host, shutdown
    from ..parallel.mesh import make_mesh
    from ..utils.task_registry import task_registry

    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        info = init_multi_host(device=args.device)
        mesh = make_mesh(device=info["device"])
    try:
        env, _ = task_registry.make_env(args.task, args, mesh=mesh)
        runner, train_cfg = task_registry.make_alg_runner(env, args.task, args, mesh=mesh)
        if getattr(args, "warmstart_pt", None):
            runner.warmstart_from_reference(args.warmstart_pt)
        return runner.learn(train_cfg.runner.max_iterations)
    finally:
        if mesh is not None:
            shutdown()


if __name__ == "__main__":
    from ..utils.task_registry import get_args

    train(get_args())
