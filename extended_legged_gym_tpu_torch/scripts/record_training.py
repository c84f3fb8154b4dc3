"""Write a training artifact (``TRAIN_torch_rNN.json``,
``TRAIN_ROUGH_torch_rNN.json``): the evaluation of a run's final checkpoint
under the evaluation protocol beside what the run's ``metrics.jsonl`` says
about the training.  A flat task is evaluated by
:func:`scripts.eval_policy.evaluate` (16 envs, 100 + 500 steps, 0.7 m/s); a
rough task by :func:`scripts.eval_rough.run_eval` twice, as
``TRAIN_ROUGH_r5.json`` is (32 envs, 100 + 500 steps, 0.7 m/s, all spawn
levels and levels <= 2).  The training side: iterations, the last logged
episode statistics, the first iteration's KL, learning rate and action std,
the iteration the reward stage advanced, non-finite skips, wall time and
seconds per iteration split into collection and update, on a generated
terrain the final mean terrain level, with the card.  ``--reference`` names
the JAX package's artifact of the same recipe, whose outcome is copied beside
the port's; ``--jax-ckpt`` also evaluates the JAX package's checkpoint in
the port under the same protocol (flat tasks).

Usage, from the directory that holds ``logs/`` (on a CUDA card):

  python -m extended_legged_gym_tpu_torch.scripts.record_training \\
      --run logs/flat_anymal_c_torch/<run> [--run <resumed run> ...] \\
      [--task anymal_c_flat] [--seed 2] [--reference TRAIN_r5.json] \\
      [--jax-ckpt logs/<experiment>/<run>/model_final.pkl] \\
      [--note TEXT] [--out TRAIN_torch_r01.json]

Several ``--run`` are the segments of one training resumed with
``--resume``, in order; the last one's ``model_final.pkl`` is evaluated.
"""
from __future__ import annotations

import argparse
import json
import os

from .eval_policy import card_name, evaluate, reference_outcome, task_cmd
from .eval_rough import run_eval


def read_metrics(runs):
    rows = []
    for run in runs:
        with open(os.path.join(run, "metrics.jsonl")) as f:
            rows += [json.loads(line) for line in f]
    return rows


def training_summary(runs, num_envs: int, seed: int) -> dict:
    """The training side of the artifact from the runs' metric streams."""
    rows = read_metrics(runs)
    done = [r for r in rows if r["episodes_done"] > 0]
    last = done[-1]
    iters = [r["collection_s"] + r["update_s"] for r in rows]
    # wall time per segment: first to last timestamp plus the first iteration
    wall, start = 0.0, 0
    for run in runs:
        seg = read_metrics([run])
        wall += seg[-1]["time"] - seg[0]["time"] + iters[start]
        start += len(seg)
    steady = rows[1:] if len(rows) > 1 else rows
    staged = [r["step"] for r in rows if r["reward_stage"] >= 1]
    levels = ({"final_terrain_level_mean": rows[-1]["terrain_level"]}
              if "terrain_level" in rows[-1] else {})
    return {
        "runs": list(runs), "segments": len(runs), "num_envs": num_envs, "seed": seed,
        "iterations": int(rows[-1]["step"]),
        "final_tracking_lin_vel_rew": last["episode/rew_tracking_lin_vel"],
        **({"final_feet_slip_rew": last["episode/rew_feet_slip"]}
           if "episode/rew_feet_slip" in last else {}),
        "final_mean_episode_length": last["mean_episode_length"],
        "final_mean_reward": last["mean_reward"], **levels,
        "final_reward_stage": rows[-1]["reward_stage"],
        "final_learning_rate": rows[-1]["learning_rate"],
        "final_action_std": rows[-1]["action_std"],
        # where a mismatch with the JAX runner shows first: iteration 1's KL,
        # learning rate after it and action std, and the staged-reward advance
        "first_iteration": {k: rows[0][k] for k in ("kl", "learning_rate", "action_std")},
        "reward_stage_1_at_iteration": staged[0] if staged else None,
        "nonfinite_skips": sum(r["nonfinite_skips"] for r in rows),
        "wall_time_s": wall,
        "s_per_iteration": sum(r["collection_s"] + r["update_s"] for r in steady) / len(steady),
        "collection_s_per_iteration": sum(r["collection_s"] for r in steady) / len(steady),
        "update_s_per_iteration": sum(r["update_s"] for r in steady) / len(steady),
        "env_steps_per_s": sum(r["fps"] for r in steady) / len(steady),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", action="append", required=True)
    ap.add_argument("--task", default="anymal_c_flat")
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--cmd", type=float, default=None,
                    help="m/s forward (default: the task's protocol, 0.5 for ElSpider, else 0.7)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reference", default=None)
    ap.add_argument("--jax-ckpt", default=None)
    ap.add_argument("--note", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from ..utils.task_registry import task_registry

    ckpt = os.path.join(args.run[-1], "model_final.pkl")
    args.cmd = task_cmd(args.task) if args.cmd is None else args.cmd
    env_cfg, _ = task_registry.get_cfgs(args.task)
    if env_cfg.terrain.mesh_type in ("heightfield", "trimesh"):
        kw = dict(task=args.task, device=args.device)
        out = {"task": args.task, "checkpoint": ckpt, "command_mps": args.cmd,
               "eval_full_difficulty": run_eval(ckpt, 32, 500, 100, args.cmd, **kw),
               "eval_level_le2": run_eval(ckpt, 32, 500, 100, args.cmd, max_init_level=2, **kw),
               "card": card_name(args.device)}
    else:
        out = evaluate(args.task, ckpt, args.cmd, envs=16, steps=500, warmup=100,
                       device=args.device)
    out["training"] = training_summary(args.run, args.num_envs, args.seed)
    if args.jax_ckpt:
        out["jax_checkpoint_in_port"] = evaluate(args.task, args.jax_ckpt, args.cmd, envs=16,
                                                 steps=500, warmup=100, device=args.device)
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
