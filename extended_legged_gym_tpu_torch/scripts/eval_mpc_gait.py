"""Gait quality of the ANYmal-C sampling MPC, on the port (counterpart of the
JAX package's ``scripts/eval_mpc_gait.py``).

Runs the receding-horizon loop (optimize -> execute the first action -> shift)
warm-started from a JAX runner checkpoint, with the forward command pinned,
and reports over the second half of the cycles the achieved-over-command
speed ratio, the uprightness and the base height, and the resets.

Usage (from the repository root, on a CUDA machine):
  python -m extended_legged_gym_tpu_torch.scripts.eval_mpc_gait \
      [--ckpt path.pkl] [--cycles N] [--cmd V] [--envs E] [--seed S] [--out file.json]
Prints one JSON line (and writes it to ``--out``); GAIT_torch_r*.json are its output.
"""
import argparse
import json
import os
import time

import torch

from extended_legged_gym_tpu_torch.robots.anymal_c_traj import (AnymalCTrajGradSampling,
                                                               anymal_c_traj_sampling_cfg)
from extended_legged_gym_tpu_torch.utils.config import class_to_dict

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CKPT = os.path.join(_ROOT, "logs/flat_anymal_c/Aug21_12-38-39_r5_ft4/model_final.pkl")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--cycles", type=int, default=300)
    ap.add_argument("--warm", type=int, default=6, help="warm-up cycles at 6 diffusion steps")
    ap.add_argument("--cmd", type=float, default=0.7)
    ap.add_argument("--envs", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    E, cmd = args.envs, args.cmd
    cfg = anymal_c_traj_sampling_cfg(num_main_envs=E)
    cfg.rl_warmstart.policy_checkpoint = args.ckpt
    cfg.commands.resampling_time = 1e9          # pin commands for the metric
    cfg.commands.ranges.lin_vel_x = [cmd, cmd]
    cfg.commands.ranges.lin_vel_y = [0.0, 0.0]
    cfg.commands.ranges.ang_vel_yaw = [0.0, 0.0]
    env = AnymalCTrajGradSampling(cfg, device=args.device)
    env.setup_rl_warmstart()
    state = env.reset_all(seed=args.seed)
    nodes = env.init_trajectories_from_rl(state)

    t0 = time.perf_counter()
    vx, up, z, resets = [], [], [], torch.zeros(E)
    for i in range(args.warm + args.cycles):
        warm = i < args.warm
        state, nodes, _ = env.mpc_step(state, nodes, n_diffuse=6 if warm else None)
        if not warm:
            vx.append(state.base_lin_vel[:, 0])
            up.append(state.projected_gravity[:, 2])
            z.append(state.phys.base_pos[:, 2])
            resets += state.reset_buf.cpu()
    vx, up, z = torch.stack(vx).cpu(), torch.stack(up).cpu(), torch.stack(z).cpu()
    seconds = time.perf_counter() - t0
    half = args.cycles // 2
    device = (torch.cuda.get_device_name(0) if env.device.type == "cuda" else "cpu")
    out = {
        "task": "anymal_c_traj_grad_sampling",
        "package": "extended_legged_gym_tpu_torch",
        "device": device,
        "warmstart_checkpoint": os.path.relpath(args.ckpt, _ROOT),
        "command_mps": cmd,
        "achieved_over_command": round(float(vx[half:].mean()) / cmd, 4),
        "per_env": [round(float(v) / cmd, 3) for v in vx[half:].mean(0)],
        "upright_mean": round(float(up[half:].mean()), 4),
        "resets": float(resets.sum()),
        "resets_per_env": [int(r) for r in resets],
        "base_height_mean": round(float(z[half:].mean()), 4),
        "n_envs": E, "n_cycles": args.cycles, "seed": args.seed,
        "seconds": round(seconds, 1),
        "trajectory_opt": class_to_dict(cfg.trajectory_opt),
    }
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
