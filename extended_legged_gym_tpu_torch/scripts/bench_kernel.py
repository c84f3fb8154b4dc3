"""Time the fused physics kernels, built from one or more CUDA sources, on one
card: B1 (flat) at the batches the sampling-MPC path launches it with at
E=8 (8 x 128, 8 x 97, 8 x 3, 8) and at E=1 (128, 97, 3), and at 2048, and B2
(heightfield) at the rough evaluation's 32 envs and the rough config's 4096,
on the ``anymal_c_rough`` curriculum grid.  Each source is timed twice, in
the order a b ... b a, so a drift of the card's clock falls on all alike.
The launches run on inputs packed once, so the time is the kernel's own, not
the wrapper's packing.  Each batch's bound (``launch_bound``) comes with it.
The ptxas report (per entry: registers, stack frame, spill stores and loads)
comes with each source this run built (null for one built before).  A source
of the same table layout from before the warp-per-env design (one thread per
env, no shared workspace) is timed through the same wrapper; a source of
another layout fails ``load_library``'s check.  Usage, from the repository
root, for example against an older commit's source:

  mkdir -p checkout && git show REV:extended_legged_gym_tpu_torch/csrc/physics_step.cu > checkout/old.cu
  python -m extended_legged_gym_tpu_torch.scripts.bench_kernel --source checkout/old.cu \
      --source extended_legged_gym_tpu_torch/csrc/physics_step.cu

Without ``--source`` it times ``csrc/physics_step.cu``.  ``--robot
elspider_air`` times B1 with the ElSpider Air hexapod's tables (19 bodies,
18 joints, 46 spheres, 6 feet) instead, at the evaluation's 16 envs and the
training fleet's 4096 (B2 is not run).  Prints one JSON object.
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

FLAT_BATCHES = (1024, 776, 24, 8, 128, 97, 3, 2048)
ROUGH_BATCHES = (32, 4096)
ELSPIDER_BATCHES = (16, 4096)
# base heights at which near_standing's robots touch the ground (ANYmal-C
# stands at ~0.5 m, ElSpider Air at its default pose at ~0.18 m)
STAND_HEIGHT = {"anymal_c": 0.54, "elspider_air": 0.2}
PEAK_F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3


def launch_bound(step, B):
    """The least time (ms) one launch of ``step``'s kernel at B envs could
    take on an H100: the larger of its float operations over the card's
    float32 peak and its bytes (inputs read once, outputs written once, the
    model tables once) over the memory rate.  Returns (ms, "operations" or
    "bytes", operations, bytes)."""
    m = step.model
    nbytes = (B * pk.control_step_bytes(m.nj, m.ng, step.nf, step.decimation, step.rough)
              + 4 * (pk.TF_SIZE + pk.TI_FULL))
    flops = B * pk.control_step_flops(m.nb, m.nj, m.ng, step.nf, step.decimation, step.rough)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", flops, nbytes


def near_standing(model, B, seed, device, origins=None, height=0.54):
    """Seeded near-standing states (base ``height`` above ``origins`` [>=B,
    3], or above the origin), anchors at the base, random friction scales and
    mass deltas, and random actions."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    nj, ng = model.nj, model.ng
    st = initial_state(model, B, pos=(0.0, 0.0, height), device=device)
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


def elspider_step(device):
    """B1 with the ElSpider Air tables: the ``elspider_air_flat`` env's fused
    control step (PD, 4 substeps)."""
    from extended_legged_gym_tpu_torch.robots.elspider_air import ElSpider, elspider_air_flat_cfg

    cfg = elspider_air_flat_cfg()
    cfg.env.num_envs = 1
    return ElSpider(cfg, device=device).decimated_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=None)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--robot", default="anymal_c", choices=["anymal_c", "elspider_air"])
    args = ap.parse_args()
    sources = args.source or [pk.SOURCE]
    dev = torch.device("cuda")
    if args.robot == "elspider_air":
        runs = (("B1", elspider_step(dev), ELSPIDER_BATCHES, None),)
    else:
        flat = AnymalCTrajGradSampling(anymal_c_traj_sampling_cfg(1), device=dev).decimated_step
        renv = rough_env(max(ROUGH_BATCHES), dev)
        origins = renv.reset_all(seed=0).env_origins
        runs = (("B1", flat, FLAT_BATCHES, None),
                ("B2", renv.decimated_step, ROUGH_BATCHES, origins))
    libs, ptxas = {}, {}
    for src in sources:
        libs[src] = pk.load_library(src)
        ptxas[src] = [ln.strip() for ln in pk.build_log(src).splitlines()
                      if any(w in ln for w in ("entry function", "registers", "stack frame"))] or None
    ms = {src: {name: {B: [] for B in batches} for name, _, batches, _ in runs}
          for src in sources}
    bounds = {name: {} for name, _, _, _ in runs}
    for name, step, batches, org in runs:
        for B in batches:
            bms, by, _, _ = launch_bound(step, B)
            bounds[name][B] = {"bound_ms": bms, "bound_by": by}
            st, ep, act = near_standing(step.model, B, B, dev, org, STAND_HEIGHT[args.robot])
            bufs = step.pack(st, act, ep)          # the kernel alone is timed
            for src in sources + sources[::-1]:
                ms[src][name][B].append(cuda_ms(
                    lambda: step.run(bufs, lib=libs[src]), reps=args.reps, warmup=5))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "robot": args.robot, "reps": args.reps, "bounds": bounds,
                      "kernels": [
        {"source": src, "ptxas": ptxas[src], "shared_workspace": libs[src].shared_workspace,
         "ms_per_launch": ms[src]} for src in sources]}))


if __name__ == "__main__":
    main()
