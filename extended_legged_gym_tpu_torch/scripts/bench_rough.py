"""Where a control step of the rough-terrain policy evaluation goes, on one
card: the ``anymal_c_rough`` env under the evaluation protocol, stepped by
the committed rough policy at the evaluation's 32 envs and the rough
config's 4096.  For each fleet size: control steps per second (host clock
around ``steps`` steps ending in a synchronize, policy included) and, from a
torch.profiler trace of ``reps`` steps, the wall ms per step (profiler on),
the device-busy ms per step and B2's ms and launches per step.
Usage, from the repository root:

  python -m extended_legged_gym_tpu_torch.scripts.bench_rough [--steps 50] [--reps 10]

Prints one JSON object.
"""
import argparse
import json
import subprocess
import time

import torch

from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
from extended_legged_gym_tpu_torch.scripts.bench_mpc import device_split
from extended_legged_gym_tpu_torch.scripts.eval_rough import CKPT, eval_cfg, load_policy

FLEETS = (32, 4096)


@torch.no_grad()
def rough_step_profile(envs, steps=50, reps=10, cmd_mps=0.7, device="cuda"):
    from torch.profiler import ProfilerActivity, profile

    env = LeggedRobot(eval_cfg(envs), device=device)
    policy = load_policy(CKPT, env.num_obs, env.num_actions, env.device)
    s = env.reset_all(seed=0)
    cmd = torch.zeros_like(s.commands)
    cmd[:, 0] = cmd_mps
    s = s.replace(commands=cmd)

    def step(s):
        return env.step(s, policy(s.obs)).replace(commands=cmd)

    for _ in range(5):
        s = step(s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        s = step(s)
    torch.cuda.synchronize()
    sps = steps / (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            s = step(s)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    return dict(control_steps_per_s=sps, env_steps_per_s=sps * envs, wall_ms=wall_ms,
                **device_split(prof, reps))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    out = {E: rough_step_profile(E, args.steps, args.reps) for E in FLEETS}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "steps": args.steps, "reps": args.reps, "fleets": out}))


if __name__ == "__main__":
    main()
