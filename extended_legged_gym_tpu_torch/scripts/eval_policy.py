"""Evaluate a trained PPO policy under the evaluation protocol (port of
``scripts/eval_policy.py``): no observation noise, domain randomization or
pushes, terrain levels frozen at spawn, the command pinned to ``--cmd`` m/s
forward; ``warmup`` control steps, then ``steps`` recorded.  Prints one JSON
line: achieved speed over command, upright mean, base height, falls
(terminations that were not timeouts), plus the card.

Usage, from the repository root (on a CUDA card; ``--device cpu`` runs the
plain physics on the CPU):

  python -m extended_legged_gym_tpu_torch.scripts.eval_policy \\
      [--task anymal_c_flat] [--ckpt path.pkl] [--cmd 0.7] [--envs 16] \\
      [--steps 500] [--warmup 100] [--seed 0] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch


def card_name(device) -> str:
    """``name, power limit`` of the card, from nvidia-smi; ``cpu`` on the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def eval_env_cfg(env_cfg, envs: int, max_init_level=None):
    """``env_cfg`` under the evaluation protocol."""
    env_cfg.env.num_envs = envs
    env_cfg.noise.add_noise = False
    env_cfg.domain_rand.randomize_friction = False
    env_cfg.domain_rand.randomize_base_mass = False
    env_cfg.domain_rand.push_robots = False
    env_cfg.terrain.freeze_terrain_levels = True
    if max_init_level is not None:
        env_cfg.terrain.max_init_terrain_level = max_init_level
    env_cfg.commands.resampling_time = 1e9
    return env_cfg


@torch.no_grad()
def evaluate(task="anymal_c_flat", ckpt=None, cmd=0.7, envs=16, steps=500, warmup=100,
             max_init_level=None, seed=0, device="cuda") -> dict:
    from .. import robots  # noqa: F401  (populates the registry)
    from ..rl.runner import OnPolicyRunner
    from ..utils.task_registry import get_load_path, task_registry

    env_cfg, train_cfg = task_registry.get_cfgs(task)
    eval_env_cfg(env_cfg, envs, max_init_level)
    env, _ = task_registry.make_env(task, env_cfg=env_cfg, device=device)
    runner = OnPolicyRunner(env, train_cfg)
    ckpt = ckpt or get_load_path("logs/" + train_cfg.runner.experiment_name)
    payload = runner.load(ckpt)
    policy = runner.get_inference_policy()

    s = env.reset_all(seed=seed)
    pinned = torch.zeros_like(s.commands)
    pinned[:, 0] = cmd
    s = s.replace(commands=pinned)
    rec = {k: [] for k in ("vx", "h", "up", "fell")}
    for i in range(warmup + steps):
        s = env.step(s, policy(s.obs)).replace(commands=pinned)
        if i >= warmup:
            rec["vx"].append(s.base_lin_vel[:, 0])
            rec["h"].append(s.phys.base_pos[:, 2])
            rec["up"].append(s.projected_gravity[:, 2])
            rec["fell"].append(s.reset_buf & ~s.time_out_buf)
    vx, h, up, fell = (torch.stack(rec[k]) for k in ("vx", "h", "up", "fell"))
    return {
        "task": task, "checkpoint": ckpt, "iteration": int(payload.get("iteration", -1)),
        "command_mps": cmd,
        "achieved_over_command": round(vx.mean().item() / cmd, 4),
        "upright_mean": round(up.mean().item(), 4),
        "base_height_mean": round(h.mean().item(), 4),
        "falls": float(fell.sum().item()),
        "n_envs": envs, "n_steps": steps,
        **({"max_init_terrain_level": max_init_level} if max_init_level is not None else {}),
        "card": card_name(device),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="anymal_c_flat")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--cmd", type=float, default=0.7)
    ap.add_argument("--envs", type=int, default=16)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--max-init-level", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(evaluate(args.task, args.ckpt, args.cmd, args.envs, args.steps, args.warmup,
                              args.max_init_level, args.seed, args.device)))


if __name__ == "__main__":
    main()
