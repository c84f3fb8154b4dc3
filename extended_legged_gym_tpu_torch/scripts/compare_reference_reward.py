"""Which gait does the engine's reward landscape prefer: the reference
checkpoint's walk or a PPO optimum of this repository? (Port of
``scripts/compare_reference_reward.py``.)

Replays each policy through the task's full training env (rewards on;
noise, randomization and pushes off; the command pinned) for 100 warm-up
and ``--steps`` recorded control steps at 16 envs, and prints one JSON line
per policy: the mean step reward, the achieved velocity over the command,
the resets and each reward term's rate per step (steps with a reset left
out).  Either side can be skipped with an empty path; an absent reference
``.pt`` fails naming its path.

Usage, from the repository root (on a CUDA card; ``--device cpu`` runs the
plain physics on the CPU):

  python -m extended_legged_gym_tpu_torch.scripts.compare_reference_reward \\
      [--ours logs/.../model_final.pkl] [--ref .../plane_walk_200.pt] \\
      [--task anymal_c_flat] [--cmd 0.7] [--steps 400] [--full-scales]
"""
from __future__ import annotations

import argparse
import json

import torch

from ..rl.torch_compat import REF_CKPT, load_reference_policy, require_checkpoint
from .eval_parity import pinned_commands

WARMUP = 100


def build_env(task: str, full_scales: bool, device="cuda"):
    from .. import robots  # noqa: F401  (populates the registry)
    from ..utils.task_registry import task_registry

    env_cfg, train_cfg = task_registry.get_cfgs(task)
    env_cfg.env.num_envs = 16
    env_cfg.noise.add_noise = False
    env_cfg.domain_rand.randomize_friction = False
    env_cfg.domain_rand.randomize_base_mass = False
    env_cfg.domain_rand.push_robots = False
    env_cfg.commands.resampling_time = 1e9
    if full_scales:
        # the final-stage (reference) scales instead of the staged bootstrap
        env_cfg.rewards.multi_stage_rewards = False
    env, _ = task_registry.make_env(task, env_cfg=env_cfg, device=device)
    return env, train_cfg


def run(env, policy, label: str, cmd_mps: float, steps: int) -> dict:
    s = env.reset_all(seed=0)
    cmd = pinned_commands(s, cmd_mps)
    s = s.replace(commands=cmd)
    rew, vx, resets, deltas = [], [], [], {n: [] for n in s.episode_sums}
    with torch.no_grad():
        for i in range(WARMUP + steps):
            before = s.episode_sums
            s = env.step(s, policy(s.obs)).replace(commands=cmd)
            if i < WARMUP:
                continue
            rew.append(s.rew)
            vx.append(s.base_lin_vel[:, 0])
            resets.append(s.reset_buf)
            # a reset zeroes the sums: those steps are masked out of the rates
            for n in deltas:
                deltas[n].append(s.episode_sums[n] - before[n])
    g = lambda xs: torch.stack(xs).cpu().numpy()
    ok = ~g(resets)
    out = {
        "label": label,
        "mean_step_reward": round(float(g(rew).mean()), 5),
        "achieved_over_command": round(float(g(vx).mean()) / cmd_mps, 4),
        "resets": int(ok.size - ok.sum()),
        "per_term_reward_rate": {n: round(float(g(d)[ok].mean()), 6)
                                 for n, d in sorted(deltas.items())},
    }
    print(json.dumps(out))
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ours", default="logs/flat_anymal_c/Aug20_20-45-05_r3_walk/model_final.pkl",
                    help="a PPO checkpoint (.pkl); empty string to skip")
    ap.add_argument("--ref", default=REF_CKPT,
                    help="the reference rsl_rl checkpoint (.pt); empty string to skip")
    ap.add_argument("--task", default="anymal_c_flat")
    ap.add_argument("--cmd", type=float, default=0.7)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--full-scales", action="store_true",
                    help="score at the final-stage (reference) reward scales")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.ref:
        require_checkpoint(args.ref)
    env, train_cfg = build_env(args.task, args.full_scales, args.device)
    outs = []
    if args.ours:
        from ..rl.runner import OnPolicyRunner

        runner = OnPolicyRunner(env, train_cfg)
        runner.load(args.ours)
        outs.append(run(env, runner.get_inference_policy(), "ours", args.cmd, args.steps))
    if args.ref:
        _, _, ref_policy = load_reference_policy(args.ref, env.num_obs, env.num_actions,
                                                 our_joint_names=env.model.joint_names,
                                                 device=env.device)
        outs.append(run(env, ref_policy, "reference", args.cmd, args.steps))
    return outs


if __name__ == "__main__":
    main()
