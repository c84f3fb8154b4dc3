"""Evaluate the ray-observation rough task's policy on true rays, under the
protocol of the JAX package's terrain-estimator closed loop
(``scripts/estimator_closed_loop.py``, its eval A, recorded in
``ESTIMATOR_CL_r5.json``): ``anymal_c_rough_raycast`` with levels frozen at
spawn levels <= 2, 128 envs, 100 warm-up and 400 recorded control steps, the
command pinned to 0.5 m/s forward and never resampled, no noise,
randomization or pushes.  Writes ``RAYCAST_torch_rNN.json``: tracking (mean
forward speed over command) and falls on true rays, the falls by terrain
type and level, with the JAX artifact's numbers beside them and the card.

Usage, from the repository root (on a CUDA card):

  python -m extended_legged_gym_tpu_torch.scripts.eval_raycast \\
      [--ckpt logs/rough_raycast_anymal_c/Aug21_13-41-24_r5_rayc/model_final.pkl] \\
      [--envs 128] [--steps 400] [--warmup 100] [--cmd 0.5] [--seed 7] \\
      [--reference ESTIMATOR_CL_r5.json] [--out RAYCAST_torch_r01.json]
"""
from __future__ import annotations

import argparse
import json
import os
import time

from .eval_policy import card_name
from .eval_rough import run_eval

RAY_CKPT = "logs/rough_raycast_anymal_c/Aug21_13-41-24_r5_rayc/model_final.pkl"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=RAY_CKPT)
    ap.add_argument("--envs", type=int, default=128)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--cmd", type=float, default=0.5)
    ap.add_argument("--max-init-level", type=int, default=2)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reference", default="ESTIMATOR_CL_r5.json")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    res = run_eval(args.ckpt, args.envs, args.steps, args.warmup, args.cmd,
                   max_init_level=args.max_init_level, seed=args.seed, device=args.device,
                   task="anymal_c_rough_raycast")
    out = {
        "task": "anymal_c_rough_raycast", "checkpoint": args.ckpt,
        "protocol": "ESTIMATOR_CL_r5 eval A (true rays): levels frozen, spawn levels <= "
                    f"{args.max_init_level}, {args.warmup} + {args.steps} control steps, command "
                    f"{args.cmd} m/s never resampled, no noise, randomization or pushes",
        "command_mps": args.cmd, "n_envs": args.envs, "n_steps": args.steps,
        "warmup": args.warmup, "max_init_terrain_level": args.max_init_level, "seed": args.seed,
        "tracking_true_rays": res["achieved_over_command"],
        "falls_true_rays": res["falls"],
        "upright_mean": res["upright_mean"],
        "falls_by_terrain_type": res["falls_by_terrain_type"],
        "falls_by_level": res["falls_by_level"],
        "spawn_composition": res["spawn_composition"],
        "seconds": time.perf_counter() - t0,
        "card": card_name(args.device),
    }
    if args.reference and os.path.exists(args.reference):
        with open(args.reference) as f:
            ref = json.load(f)
        out["reference"] = {"source": os.path.basename(args.reference),
                            **{k: ref[k] for k in ("policy", "command_mps", "n_envs", "n_steps",
                                                   "max_init_terrain_level", "tracking_true_rays",
                                                   "falls_true_rays")}}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
