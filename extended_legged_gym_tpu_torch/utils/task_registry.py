"""Task registry, env and runner factories and the command line (port of
``utils/task_registry.py``; ``robots/__init__.py`` registers the tasks)."""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Optional, Tuple, Type

from ..envs.legged_robot_config import LeggedRobotCfg, LeggedRobotCfgPPO


class TaskRegistry:
    def __init__(self):
        self.task_classes: Dict[str, Type] = {}
        self.env_cfgs: Dict[str, Callable] = {}
        self.train_cfgs: Dict[str, Optional[Callable]] = {}

    def register(self, name: str, task_class: Type, env_cfg_factory: Callable,
                 train_cfg_factory: Optional[Callable] = None):
        """The factories return fresh config instances."""
        self.task_classes[name] = task_class
        self.env_cfgs[name] = env_cfg_factory
        self.train_cfgs[name] = train_cfg_factory

    def get_cfgs(self, name: str) -> Tuple[LeggedRobotCfg, Optional[LeggedRobotCfgPPO]]:
        env_cfg = self.env_cfgs[name]()
        train_cfg = self.train_cfgs[name]() if self.train_cfgs.get(name) else None
        return env_cfg, train_cfg

    def make_env(self, name: str, args: Optional[argparse.Namespace] = None,
                 env_cfg: Optional[LeggedRobotCfg] = None, device=None, mesh=None):
        """The task's env on ``device`` (default: ``args.device``, else
        ``"cuda"``), its config updated from ``args``.  With a ``mesh``
        (data-parallel training) ``num_envs`` stays the global count, as in
        the JAX package: this rank's env holds ``num_envs / world`` of them
        (a count that does not divide is refused), on the mesh's device, its
        seed offset by the rank."""
        if name not in self.task_classes:
            raise ValueError(f"Task {name} not registered. Available: {list(self.task_classes)}")
        if env_cfg is None:
            env_cfg, _ = self.get_cfgs(name)
        if args is not None:
            update_cfg_from_args(env_cfg, None, args)
        device = device or getattr(args, "device", None) or "cuda"
        if mesh is not None:
            if env_cfg.env.num_envs % mesh.size:
                raise ValueError(f"num_envs {env_cfg.env.num_envs} does not divide over "
                                 f"{mesh.size} processes")
            env_cfg.env.num_envs //= mesh.size
            env_cfg.seed += mesh.rank
            device = mesh.device
        return self.task_classes[name](env_cfg, device=device), env_cfg

    def make_alg_runner(self, env, name: Optional[str] = None,
                        args: Optional[argparse.Namespace] = None,
                        train_cfg: Optional[LeggedRobotCfgPPO] = None, log_root: str = "logs",
                        mesh=None):
        """A runner logging to ``log_root/<experiment>/<date>_<run_name>``,
        resumed from the latest (or the named) run's checkpoint on
        ``--resume``.  With a ``mesh`` it is data-parallel: only rank 0
        logs, and on ``--resume`` rank 0 finds and reads the checkpoint and
        the others take its state."""
        from ..rl.runner import OnPolicyRunner

        if train_cfg is None:
            _, train_cfg = self.get_cfgs(name)
        if args is not None:
            update_cfg_from_args(None, train_cfg, args)
        is_main = mesh is None or mesh.rank == 0
        run_name = time.strftime("%b%d_%H-%M-%S") + "_" + train_cfg.runner.run_name
        log_dir = os.path.join(log_root, train_cfg.runner.experiment_name, run_name)
        runner = OnPolicyRunner(env, train_cfg, log_dir=log_dir if is_main else None, mesh=mesh)
        if train_cfg.runner.resume:
            path = None
            if is_main:
                path = get_load_path(os.path.join(log_root, train_cfg.runner.experiment_name),
                                     load_run=train_cfg.runner.load_run,
                                     checkpoint=train_cfg.runner.checkpoint)
                print(f"Loading model from: {path}", flush=True)
            runner.load(path)
        return runner, train_cfg


def get_load_path(root: str, load_run=-1, checkpoint=-1) -> str:
    """The checkpoint of the latest run (or ``load_run``), its last one (or
    ``model_<checkpoint>.pkl``); checkpoints sort by iteration, final last."""
    runs = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    if not runs:
        raise ValueError(f"No runs in {root}")
    run = runs[-1] if load_run == -1 else (load_run if isinstance(load_run, str) else runs[load_run])
    run_dir = os.path.join(root, run)

    def _iter_key(f: str):
        stem = f[len("model_"):-len(".pkl")]
        return (1, 0) if stem == "final" else (0, int(stem)) if stem.isdigit() else (-1, 0)

    models = sorted((f for f in os.listdir(run_dir) if f.startswith("model") and f.endswith(".pkl")),
                    key=_iter_key)
    if not models:
        raise ValueError(f"No checkpoints in {run_dir}")
    model = models[-1] if checkpoint == -1 else f"model_{checkpoint}.pkl"
    return os.path.join(run_dir, model)


def update_cfg_from_args(env_cfg, train_cfg, args):
    """Command-line overrides of the env and train configs."""
    if env_cfg is not None:
        if getattr(args, "num_envs", None) is not None:
            env_cfg.env.num_envs = args.num_envs
        if getattr(args, "seed", None) is not None:
            env_cfg.seed = args.seed
    if train_cfg is not None:
        if getattr(args, "seed", None) is not None:
            train_cfg.seed = args.seed
        if getattr(args, "max_iterations", None) is not None:
            train_cfg.runner.max_iterations = args.max_iterations
        if getattr(args, "resume", False):
            train_cfg.runner.resume = True
        for k in ("experiment_name", "run_name", "load_run", "checkpoint"):
            if getattr(args, k, None) is not None:
                setattr(train_cfg.runner, k, getattr(args, k))
    return env_cfg, train_cfg


def get_args(default_task: str = "anymal_c_flat", argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("extended_legged_gym_tpu_torch")
    parser.add_argument("--task", type=str, default=default_task)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--experiment_name", type=str, default=None)
    parser.add_argument("--run_name", type=str, default=None)
    parser.add_argument("--load_run", type=str, default=None)
    parser.add_argument("--checkpoint", type=int, default=None)
    parser.add_argument("--num_envs", type=int, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--max_iterations", type=int, default=None)
    parser.add_argument("--warmstart_pt", type=str, default=None,
                        help="reference rsl_rl .pt checkpoint to warm-start "
                             "PPO params from (DOF-order bridged)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; the CPU runs the plain physics")
    return parser.parse_args(argv)


# the global registry, populated by robots/__init__.py
task_registry = TaskRegistry()
