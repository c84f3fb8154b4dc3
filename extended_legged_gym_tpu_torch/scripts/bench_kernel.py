"""Time the fused physics kernels, built from one or more CUDA sources, on one
card: B1 (flat) at the batches the sampling-MPC path launches it with
(8 x 128, 8 x 97, 8 x 3, 8) and at 2048, and B2 (heightfield) at the rough
evaluation's 32 envs and the rough config's 4096, on the ``anymal_c_rough``
curriculum grid.  Each source is timed twice, in the order a b ... b a, so a
drift of the card's clock falls on all alike.  The ptxas register and stack
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

from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
from extended_legged_gym_tpu_torch.physics import EnvPhysParams, initial_state
from extended_legged_gym_tpu_torch.robots.anymal_c_traj import (AnymalCTrajGradSampling,
                                                               anymal_c_traj_sampling_cfg)
from extended_legged_gym_tpu_torch.scripts.bench_mpc import cuda_ms
from extended_legged_gym_tpu_torch.scripts.eval_rough import eval_cfg

FLAT_BATCHES = (1024, 776, 24, 8, 2048)
ROUGH_BATCHES = (32, 4096)


def near_standing(model, B, seed, device, origins=None):
    """Seeded near-standing states (base 0.54 m above ``origins`` [>=B, 3], or
    above the origin), anchors at the base, random friction scales and mass
    deltas, and random actions."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    nj, ng = model.nj, model.ng
    st = initial_state(model, B, pos=(0.0, 0.0, 0.54), device=device)
    base = st.base_pos if origins is None else st.base_pos + origins[:B]
    st = st.replace(base_pos=base + t(0.05 * rng.standard_normal((B, 3))),
                    joint_pos=st.joint_pos + t(0.1 * rng.standard_normal((B, nj))),
                    joint_vel=t(0.5 * rng.standard_normal((B, nj))),
                    base_lin_vel=t(0.3 * rng.standard_normal((B, 3))),
                    base_ang_vel=t(0.3 * rng.standard_normal((B, 3))))
    st = st.replace(contact_anchor=st.base_pos[:, None, :2].expand(B, ng, 2).contiguous())
    ep = EnvPhysParams(t(rng.uniform(0.5, 1.25, B)), t(rng.uniform(-1.0, 1.0, B)))
    return st, ep, t(rng.standard_normal((B, nj)))


def rough_env(num_envs: int, device) -> LeggedRobot:
    """The ``anymal_c_rough`` env under the evaluation protocol; its
    ``decimated_step`` runs B2 and ``reset_all().env_origins`` are spawn
    origins on the curriculum grid."""
    return LeggedRobot(eval_cfg(num_envs), device=device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=None)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sources = args.source or [pk.SOURCE]
    dev = torch.device("cuda")
    flat = AnymalCTrajGradSampling(anymal_c_traj_sampling_cfg(1), device=dev).decimated_step
    renv = rough_env(max(ROUGH_BATCHES), dev)
    origins = renv.reset_all(seed=0).env_origins
    libs, ptxas = {}, {}
    for src in sources:
        libs[src] = pk.load_library(src)
        ptxas[src] = [ln.strip() for ln in pk.build_log(src).splitlines()
                      if "registers" in ln or "stack frame" in ln] or None
    ms = {src: {"B1": {B: [] for B in FLAT_BATCHES}, "B2": {B: [] for B in ROUGH_BATCHES}}
          for src in sources}
    for name, step, batches, org in (("B1", flat, FLAT_BATCHES, None),
                                     ("B2", renv.decimated_step, ROUGH_BATCHES, origins)):
        for B in batches:
            st, ep, act = near_standing(step.model, B, B, dev, org)
            for src in sources + sources[::-1]:
                ms[src][name][B].append(cuda_ms(
                    lambda: step.launch(st, act, ep, lib=libs[src]), reps=args.reps, warmup=5))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "reps": args.reps, "kernels": [
        {"source": src, "ptxas": ptxas[src], "ms_per_launch": ms[src]} for src in sources]}))


if __name__ == "__main__":
    main()
