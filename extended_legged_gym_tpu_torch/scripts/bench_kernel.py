"""Time the fused flat physics kernel, built from one or more CUDA sources, at
the batches the main path launches it with (8 x 128, 8 x 97, 8 x 3, 8) and at
2048, on one card.  Each source is timed twice, in the order a b ... b a, so
a drift of the card's clock falls on all alike.  The ptxas register and stack
report comes with each source this run built (null for one built before).
Usage, from the repository root:

  python -m extended_legged_gym_tpu_torch.scripts.bench_kernel [--source FILE ...] [--reps N]

Without ``--source`` it times ``csrc/physics_step.cu``.  Prints one JSON object.
"""
import argparse
import json
import subprocess

import numpy as np
import torch

from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
from extended_legged_gym_tpu_torch.physics import EnvPhysParams, initial_state
from extended_legged_gym_tpu_torch.robots.anymal_c_traj import (AnymalCTrajGradSampling,
                                                               anymal_c_traj_sampling_cfg)
from extended_legged_gym_tpu_torch.scripts.bench_mpc import cuda_ms

BATCHES = (1024, 776, 24, 8, 2048)


def _inputs(env, B, seed):
    """Seeded near-standing states with random actions."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=env.device)
    st = initial_state(env.model, B, pos=(0.0, 0.0, 0.54), device=env.device)
    st = st.replace(joint_pos=st.joint_pos + t(0.1 * rng.standard_normal((B, env.model.nj))),
                    joint_vel=t(0.5 * rng.standard_normal((B, env.model.nj))))
    ep = EnvPhysParams(t(rng.uniform(0.5, 1.25, B)), t(rng.uniform(-1.0, 1.0, B)))
    return st, t(rng.standard_normal((B, env.model.nj))), ep


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=None)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sources = args.source or [pk.SOURCE]
    env = AnymalCTrajGradSampling(anymal_c_traj_sampling_cfg(1), device="cuda")
    step = env.decimated_step
    libs, ptxas = {}, {}
    for src in sources:
        libs[src] = pk.load_library(src)
        ptxas[src] = [ln.strip() for ln in pk.build_log(src).splitlines()
                      if "registers" in ln or "stack frame" in ln] or None
    ms = {src: {B: [] for B in BATCHES} for src in sources}
    for B in BATCHES:
        st, act, ep = _inputs(env, B, seed=B)
        for src in sources + sources[::-1]:
            ms[src][B].append(cuda_ms(lambda: step.launch(st, act, ep, lib=libs[src]),
                                      reps=args.reps, warmup=5))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "reps": args.reps, "kernels": [
        {"source": src, "ptxas": ptxas[src], "ms_per_launch": {B: v for B, v in ms[src].items()}}
        for src in sources]}))


if __name__ == "__main__":
    main()
