"""Evaluate a trained PPO policy under the evaluation protocol (port of
``scripts/eval_policy.py``): no observation noise, domain randomization or
pushes, terrain levels frozen at spawn, the command pinned to ``--cmd`` m/s
forward; ``warmup`` control steps, then ``steps`` recorded.  Prints one JSON
line: achieved speed over command, upright mean, base height, falls
(terminations that were not timeouts), plus the card.  The command
defaults to the task's JAX protocol: 0.5 m/s for ``elspider_air_flat``
(``TRAIN_ELSPIDER_r4``), 0.7 m/s otherwise (``TRAIN_r4``'s ``sea_variant``
for ``anymal_c_flat_sea``).  A recurrent policy keeps its carry per env and
zeroes it where an env reset.

Usage, from the repository root (on a CUDA card; ``--device cpu`` runs the
plain physics on the CPU):

  python -m extended_legged_gym_tpu_torch.scripts.eval_policy \\
      [--task anymal_c_flat] [--ckpt path.pkl] [--cmd 0.7] [--envs 16] \\
      [--steps 500] [--warmup 100] [--seed 0] [--device cuda] \\
      [--reference TRAIN_r4.json:sea_variant] [--note TEXT] [--out FILE.json]

``--reference`` names the JAX package's artifact of the same protocol (a
``path:block`` for a block inside it), whose outcome is copied beside the
port's; ``--out`` also writes the JSON to a file.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

# the command of a task's JAX evaluation protocol where it is not 0.7 m/s
TASK_CMD = {"elspider_air_flat": 0.5}


def task_cmd(task: str) -> float:
    return TASK_CMD.get(task, 0.7)


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
def evaluate(task="anymal_c_flat", ckpt=None, cmd=None, envs=16, steps=500, warmup=100,
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
    reset = getattr(policy, "reset", None)          # a recurrent policy's carry
    cmd = task_cmd(task) if cmd is None else cmd

    s = env.reset_all(seed=seed)
    pinned = torch.zeros_like(s.commands)
    pinned[:, 0] = cmd
    s = s.replace(commands=pinned)
    rec = {k: [] for k in ("vx", "h", "up", "fell")}
    for i in range(warmup + steps):
        s = env.step(s, policy(s.obs)).replace(commands=pinned)
        if reset is not None:
            reset(s.reset_buf)
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


def reference_outcome(path: str) -> dict:
    """The outcome of the JAX package's artifact at ``path`` (or of the block
    ``path:block`` inside it): its evaluation (one block, or the rough
    artifact's two) and its training's final numbers."""
    path, _, block = path.partition(":")
    with open(path) as f:
        ref = json.load(f)
    if block:
        ref = ref[block]
    keys = ("achieved_over_command", "upright_mean", "base_height_mean", "falls")
    out = {"source": os.path.basename(path) + (f":{block}" if block else ""),
           "checkpoint": ref.get("checkpoint")}
    for b in ("eval_full_difficulty", "eval_level_le2"):
        if b in ref:
            out[b] = {k: ref[b][k] for k in keys if k in ref[b]}
    out.update({k: ref[k] for k in keys if k in ref})
    out["training"] = {k: v for k, v in ref.get("training", {}).items()
                       if k in ("iterations", "seed", "num_envs", "final_terrain_level_mean",
                                "final_tracking_lin_vel_rew", "final_feet_slip_rew",
                                "final_mean_episode_length", "nonfinite_skips")}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="anymal_c_flat")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--cmd", type=float, default=None,
                    help="m/s forward (default: the task's protocol, 0.5 for ElSpider, else 0.7)")
    ap.add_argument("--envs", type=int, default=16)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--max-init-level", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reference", default=None)
    ap.add_argument("--note", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = evaluate(args.task, args.ckpt, args.cmd, args.envs, args.steps, args.warmup,
                   args.max_init_level, args.seed, args.device)
    if args.reference:
        out["reference"] = reference_outcome(args.reference)
    if args.note:
        out["note"] = args.note
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
