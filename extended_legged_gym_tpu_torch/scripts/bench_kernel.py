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

Without ``--source`` it times ``csrc/physics_step.cu``.  ``--task T`` (one
or more) times the fused step of registered tasks instead, at ``--batches``
(default 4096): B1 on a plane, B2 on the task's own curriculum grid from
its spawn origins, the fixed-base regime from states at rest at the task's
initial position; near-standing states stand at the robot's
``STAND_HEIGHT``.  For example ``--task elspider_air_flat --batches 16
4096`` (B1 with the hexapod's tables), ``--task cyberdog2_walk`` (B1 with
CyberDog2's), ``--task franka --batches 8 1024`` (the fixed-base regime
with the arm's).  With several sources, each batch's outputs of every
source are compared with the first source's bit for bit (``same_bits``).
Prints one JSON object.
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
# base heights at which near_standing's robots touch the ground: ANYmal-C
# stands at ~0.5 m, ElSpider Air at its default pose at ~0.18 m; at the
# default pose the lowest sphere hangs below the base by 0.239 m on
# CyberDog2, 0.294-0.302 m on A1 (front feet lower), 0.314-0.324 m on Go2,
# 0.497 m on ANYmal-B and 0.854 m on Cassie
STAND_HEIGHT = {"anymal_c": 0.54, "elspider_air": 0.2, "cyberdog2": 0.23, "a1": 0.29,
                "go2": 0.31, "anymal_b": 0.49, "cassie": 0.845}
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
    flops = B * pk.control_step_flops(m.nb, m.nj, m.ng, step.nf, step.decimation, step.rough,
                                      fix_base=m.fix_base)
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


def franka_step(device, control_type="P", terrain=None):
    """The fixed-base regime with the Franka arm's tables: the ``franka``
    env's fused control step (PD with the arm's gains, 4 substeps), on
    ``terrain`` (default the plane) or with control T."""
    step = task_step("franka", device)
    if control_type == "P" and terrain is None:
        return step
    return pk.make_decimated_env_step(step.model, step.sp, terrain or step.terrain, 4,
                                      step._host["p"], step._host["d"], step._host["ddp"], 0.5,
                                      control_type=control_type)


def at_rest(model, B, seed, device, origins=None):
    """near_standing's joints, friction, mass deltas and actions with the
    base at rest at ``origins`` [>=B, 3] (default the world origin), as the
    env resets a fixed base."""
    st, ep, act = near_standing(model, B, seed, device, origins, height=0.0)
    base = (torch.zeros(B, 3, device=device) if origins is None
            else origins[:B].to(device=device, dtype=torch.float32).clone())
    zero = torch.zeros(B, 3, device=device)
    st = st.replace(base_pos=base, base_lin_vel=zero, base_ang_vel=zero.clone(),
                    contact_anchor=base[:, None, :2].expand(B, model.ng, 2).contiguous())
    return st, ep, act


def task_env(task, device, num_envs=1):
    """A registered task's env at ``num_envs`` envs."""
    from extended_legged_gym_tpu_torch import robots  # noqa: F401
    from extended_legged_gym_tpu_torch.utils.task_registry import task_registry

    cfg, _ = task_registry.get_cfgs(task)
    cfg.env.num_envs = num_envs
    return task_registry.make_env(task, env_cfg=cfg, device=device)[0]


def task_step(task, device):
    """The fused control step (PD, 4 substeps) of a registered task's env:
    B1 on a plane, B2 on its generated grid, the fixed-base regime where
    its base is fixed."""
    return task_env(task, device).decimated_step


def task_states(env, B, seed, device):
    """States of ``B`` envs for ``env``'s fused step: on a fixed base at
    rest at the task's initial position; else near-standing at the robot's
    STAND_HEIGHT, above the env's spawn origins on a generated grid (the env
    must have at least ``B`` envs there)."""
    m = env.decimated_step.model
    if m.fix_base:
        origins = env.base_init_state[:3].expand(B, 3)
        return at_rest(m, B, seed, device, origins)
    origins = env.reset_all(seed=0).env_origins if env.custom_origins else None
    return near_standing(m, B, seed, device, origins, STAND_HEIGHT[env.cfg.asset.name])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=None)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--task", action="append", default=None)
    ap.add_argument("--batches", type=int, nargs="+", default=[4096])
    args = ap.parse_args()
    sources = args.source or [pk.SOURCE]
    dev = torch.device("cuda")
    # (name, fused step, batches, states(B) for that step)
    if args.task:
        envs = {t: task_env(t, dev, max(args.batches)) for t in args.task}
        runs = tuple((t, envs[t].decimated_step, tuple(args.batches),
                      lambda B, env=envs[t]: task_states(env, B, B, dev)) for t in args.task)
    else:
        flat = AnymalCTrajGradSampling(anymal_c_traj_sampling_cfg(1), device=dev).decimated_step
        renv = rough_env(max(ROUGH_BATCHES), dev)
        origins = renv.reset_all(seed=0).env_origins
        h = STAND_HEIGHT["anymal_c"]
        runs = (("B1", flat, FLAT_BATCHES,
                 lambda B: near_standing(flat.model, B, B, dev, height=h)),
                ("B2", renv.decimated_step, ROUGH_BATCHES,
                 lambda B: near_standing(renv.model, B, B, dev, origins, h)))
    libs, ptxas = {}, {}
    for src in sources:
        libs[src] = pk.load_library(src)
        ptxas[src] = [ln.strip() for ln in pk.build_log(src).splitlines()
                      if any(w in ln for w in ("entry function", "registers", "stack frame"))] or None
    ms = {src: {name: {B: [] for B in batches} for name, _, batches, _ in runs}
          for src in sources}
    bounds = {name: {} for name, _, _, _ in runs}
    same = {src: {name: {} for name, _, _, _ in runs} for src in sources[1:]}
    outs = ("out", "tau", "gf", "fpos", "fvel")
    for name, step, batches, states in runs:
        for B in batches:
            bms, by, _, _ = launch_bound(step, B)
            bounds[name][B] = {"bound_ms": bms, "bound_by": by}
            st, ep, act = states(B)
            bufs = step.pack(st, act, ep)          # the kernel alone is timed
            for src in sources + sources[::-1]:
                ms[src][name][B].append(cuda_ms(
                    lambda: step.run(bufs, lib=libs[src]), reps=args.reps, warmup=5))
            first = None
            for src in sources:
                step.run(bufs, lib=libs[src])
                got = [bufs[k].clone() for k in outs]
                if first is None:
                    first = got
                else:
                    same[src][name][B] = all(torch.equal(a, b) for a, b in zip(first, got))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "tasks": args.task or ["anymal_c"], "reps": args.reps,
                      "bounds": bounds,
                      "kernels": [
        {"source": src, "ptxas": ptxas[src], "shared_workspace": libs[src].shared_workspace,
         "ms_per_launch": ms[src], "same_bits": same.get(src)} for src in sources]}))


if __name__ == "__main__":
    main()
