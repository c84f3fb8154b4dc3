"""Where a PPO training iteration goes, on one card: a registered task at
its training recipe from scratch, by default ``anymal_c_flat`` at TRAIN_r5's
(4096 envs, 24 steps per env, 5 x 4 minibatches, seed 2); ``--task
anymal_c_rough --seed 1`` is TRAIN_ROUGH_r5's (the terrain curriculum, the
[512, 256, 128] networks).  After ``warmup`` iterations: the seconds per
iteration split into collection and update (host clock around each part,
ending in a synchronize) over ``iters`` iterations, and, from a
torch.profiler trace of ``reps`` iterations, the wall ms per iteration
(profiler on), the device-busy ms per iteration, the device's idle share and
the physics kernel's (B1 on flat ground, B2 on a heightfield) ms and
launches per iteration.

Usage, from the repository root:

  python -m extended_legged_gym_tpu_torch.scripts.bench_train [--task anymal_c_flat] \\
      [--seed 2] [--iters 10] [--reps 2]

Prints one JSON object.
"""
import argparse
import json
import time

import torch

from extended_legged_gym_tpu_torch import robots  # noqa: F401  (populates the registry)
from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner
from extended_legged_gym_tpu_torch.scripts.bench_mpc import device_split
from extended_legged_gym_tpu_torch.scripts.eval_policy import card_name
from extended_legged_gym_tpu_torch.utils.task_registry import get_args, task_registry


def train_profile(warmup=3, iters=10, reps=2, device="cuda", task="anymal_c_flat", seed=2):
    from torch.profiler import ProfilerActivity, profile

    args = get_args(argv=["--seed", str(seed), "--num_envs", "4096", "--device", device])
    env, _ = task_registry.make_env(task, args)
    _, train_cfg = task_registry.get_cfgs(task)
    train_cfg.seed = seed
    runner = OnPolicyRunner(env, train_cfg)
    for _ in range(warmup):
        runner.train_iteration()
    col = upd = 0.0
    for _ in range(iters):
        runner.train_iteration()
        col += runner.last_times["collection_s"]
        upd += runner.last_times["update_s"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            runner.train_iteration()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    split = device_split(prof, reps)
    return dict(task=task, seed=seed, envs=env.num_envs, steps_per_env=runner.num_steps_per_env,
                collection_s=col / iters, update_s=upd / iters,
                s_per_iteration=(col + upd) / iters,
                env_steps_per_s=env.num_envs * runner.num_steps_per_env * iters / (col + upd),
                profiled_wall_ms=wall_ms, device_busy_ms=split["device_busy_ms"],
                device_idle_share=1.0 - split["device_busy_ms"] / wall_ms,
                kernel_ms=split["physics_kernel_ms"], kernel_launches=split["physics_launches"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="anymal_c_flat")
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    out = train_profile(args.warmup, args.iters, args.reps, task=args.task, seed=args.seed)
    print(json.dumps({"card": card_name("cuda"), **out}))


if __name__ == "__main__":
    main()
