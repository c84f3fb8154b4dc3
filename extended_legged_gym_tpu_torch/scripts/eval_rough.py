"""Rough-terrain policy evaluation with falls by terrain type and level (port
of ``scripts/eval_rough.py``).

Two evaluations of a PPO checkpoint of a rough task (``anymal_c_rough``, or
the ray-observation ``anymal_c_rough_raycast``) on its curriculum grid, with
levels frozen at spawn (``freeze_terrain_levels``), no noise, randomization
or pushes, and a constant forward command: all spawn levels, then levels
<= 2.  Each steps the fleet ``warmup`` control steps and then records
``steps`` more: achieved speed over command, upright mean, falls
(terminations that are not timeouts) by terrain type and level, and the
spawn composition.  The JSON has the JAX script's shape and keys, plus the card.

Usage, from the repository root (on a CUDA card; ``--device cpu`` runs the
plain physics on the CPU):

  python -m extended_legged_gym_tpu_torch.scripts.eval_rough [--task anymal_c_rough] \\
      [--ckpt logs/rough_anymal_c/Aug21_13-00-24_r5_rough3/model_final.pkl] \\
      [--envs 32] [--steps 500] [--warmup 100] [--cmd 0.7] [--seed 0] [--out FILE]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import robots  # noqa: F401  (populates the registry)
from ..envs.legged_robot import LeggedRobot
from ..models.networks import ActorCritic, inference_policy, load_jax_checkpoint
from ..robots.anymal_c import anymal_c_rough_ppo_cfg
from ..utils.device import resolve_device
from ..utils.task_registry import task_registry
from .eval_policy import card_name

CKPT = "logs/rough_anymal_c/Aug21_13-00-24_r5_rough3/model_final.pkl"


def col_type_names(num_cols: int, proportions) -> list:
    """Column index -> terrain-type name, mirroring the generator's choice of
    subterrain for ``choice = col / num_cols + 0.001``."""
    p = np.cumsum(proportions).tolist()
    names = []
    for j in range(num_cols):
        c = j / num_cols + 0.001
        if c < p[0]:
            names.append("smooth_slope_down" if c < p[0] / 2 else "smooth_slope_up")
        elif c < p[1]:
            names.append("rough_slope")
        elif c < p[3]:
            names.append("stairs_down" if c < p[2] else "stairs_up")
        elif len(p) > 4 and c < p[4]:
            names.append("discrete")
        elif len(p) > 5 and c < p[5]:
            names.append("stepping_stones")
        elif len(p) > 6 and c < p[6]:
            names.append("gap")
        else:
            names.append("pit")
    return names


def eval_cfg(envs: int, max_init_level=None, task="anymal_c_rough"):
    """The task's cfg under the evaluation protocol: the training curriculum
    grid with levels frozen at spawn, no noise, randomization or pushes, no
    command resampling."""
    cfg, _ = task_registry.get_cfgs(task)
    cfg.env.num_envs = envs
    cfg.noise.add_noise = False
    cfg.domain_rand.randomize_friction = False
    cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.push_robots = False
    cfg.terrain.freeze_terrain_levels = True
    if max_init_level is not None:
        cfg.terrain.max_init_terrain_level = max_init_level
    cfg.commands.resampling_time = 1e9
    return cfg


def load_policy(ckpt: str, num_obs: int, num_actions: int, device):
    """The checkpoint's deterministic policy ``obs -> actions`` on ``device``
    (its observation normalizer applied, where it has one)."""
    pol = anymal_c_rough_ppo_cfg().policy
    net = ActorCritic(num_obs, num_actions, pol.actor_hidden_dims, pol.critic_hidden_dims,
                      pol.activation)
    state_dict, obs_norm = load_jax_checkpoint(ckpt)
    net.load_state_dict(state_dict)
    return inference_policy(net.to(device).eval(), obs_norm)


@torch.no_grad()
def run_eval(ckpt, envs, steps, warmup, cmd_mps, max_init_level=None, seed=0, device="cuda",
             task="anymal_c_rough"):
    device = resolve_device(device)
    cfg = eval_cfg(envs, max_init_level, task)
    env = LeggedRobot(cfg, device=device)
    policy = load_policy(ckpt, env.num_obs, env.num_actions, device)

    s = env.reset_all(seed=seed)
    cmd = torch.zeros_like(s.commands)
    cmd[:, 0] = cmd_mps
    s = s.replace(commands=cmd)
    rec = {k: [] for k in ("vx", "up", "fell", "lvl", "typ")}
    for i in range(warmup + steps):
        s = env.step(s, policy(s.obs)).replace(commands=cmd)
        if i >= warmup:
            rec["vx"].append(s.base_lin_vel[:, 0])
            rec["up"].append(s.projected_gravity[:, 2])
            rec["fell"].append(s.reset_buf & ~s.time_out_buf)
            rec["lvl"].append(s.terrain_levels)
            rec["typ"].append(s.terrain_types)
    vx, up, fell, lvl, typ = (torch.stack(rec[k]).cpu().numpy()
                              for k in ("vx", "up", "fell", "lvl", "typ"))

    names = col_type_names(cfg.terrain.num_cols, cfg.terrain.terrain_proportions)
    by_type: dict = {}
    by_level: dict = {}
    for t, e in zip(*np.nonzero(fell)):
        tn = names[int(typ[t, e]) % len(names)]
        by_type[tn] = by_type.get(tn, 0) + 1
        lv = int(lvl[t, e])
        by_level[lv] = by_level.get(lv, 0) + 1
    comp: dict = {}
    for t, n in zip(*np.unique(typ[0], return_counts=True)):
        tn = names[int(t) % len(names)]
        comp[tn] = comp.get(tn, 0) + int(n)
    return {
        "achieved_over_command": round(float(vx.mean()) / cmd_mps, 4),
        "upright_mean": round(float(up.mean()), 4),
        "falls": int(fell.sum()),
        "n_envs": envs, "n_steps": steps,
        **({"max_init_terrain_level": max_init_level} if max_init_level is not None else {}),
        "falls_by_terrain_type": by_type,
        "falls_by_level": {str(k): v for k, v in sorted(by_level.items())},
        "spawn_composition": comp,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="anymal_c_rough")
    ap.add_argument("--ckpt", default=CKPT)
    ap.add_argument("--envs", type=int, default=32)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--cmd", type=float, default=0.7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    kw = dict(seed=args.seed, device=args.device, task=args.task)
    full = run_eval(args.ckpt, args.envs, args.steps, args.warmup, args.cmd, **kw)
    easy = run_eval(args.ckpt, args.envs, args.steps, args.warmup, args.cmd, max_init_level=2, **kw)
    card = card_name(args.device)
    out = {
        "task": args.task, "checkpoint": args.ckpt, "command_mps": args.cmd,
        "seed": args.seed, "card": card,
        "eval_full_difficulty": full,
        "eval_level_le2": easy,
    }
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
