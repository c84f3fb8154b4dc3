"""Full-solve latency of every polish mode at the flagship shape, on one CUDA
card (counterpart of the JAX package's ``scripts/bench_polish.py``).

Times one whole ``optimize_all_trajectories`` solve (the diffusion sweep and
the polish) at E=1, Nsample=127, Hsample=16, Hnode=4, Ndiffuse=2, for the
modes "none" (no polish), "fd" (central differences through the fused
kernel), "gradient" (autograd through the plain engine) and "ilqr" (Riccati
sweeps on the plain engine's forward-mode linearizations), each polishing
``--polish-iters`` times (default 2).  Solves are chained (each starts from
the last one's nodes) and timed with CUDA events after a warm-up solve; the
launches of the fused kernel (B1) and the plain engine's substeps of one
solve are counted and held to what the solve's structure implies; one more
solve runs under torch.profiler for the device's busy and idle shares.

Usage, from the repository root on a CUDA machine:
  python -m extended_legged_gym_tpu_torch.scripts.bench_polish [--polish-iters 2]
      [--reps 3] [--out POLISH_torch_rNN.json]
Prints one JSON line with the card's name and power limit (``nvidia-smi``).
"""
import argparse
import json
import subprocess
import time

import torch

from extended_legged_gym_tpu_torch.envs.batch_rollout import RobotTrajGradSampling
from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
from extended_legged_gym_tpu_torch.physics.engine import EngineEnvStep
from extended_legged_gym_tpu_torch.robots.anymal_c_traj import anymal_c_traj_sampling_cfg
from extended_legged_gym_tpu_torch.scripts.bench_mpc import cuda_ms, device_split

MODES = ("none", "fd", "gradient", "ilqr")


def polish_env(mode: str, iters: int, device="cuda", num_envs: int = 1) -> RobotTrajGradSampling:
    """The flagship MPC env (``anymal_c_traj_sampling_cfg``) polishing
    ``iters`` times by ``mode`` ("none": no polish)."""
    cfg = anymal_c_traj_sampling_cfg(num_envs)
    cfg.trajectory_opt.polish_iters = 0 if mode == "none" else iters
    if mode != "none":
        cfg.trajectory_opt.polish_method = mode
    return RobotTrajGradSampling(cfg, device=device)


def expected_counts(env: RobotTrajGradSampling):
    """(B1 launches, engine substeps) of one solve: a launch per control step
    of each kernel-route rollout batch (the diffusion sweep's; fd's stencil
    and line search; the iLQR's two node-level scorings), ``decimation``
    engine substeps per control step of each differentiable one (gradient:
    the gradient pass and the line search; iLQR: the nominal rollout, then
    per iteration the linearization's one step and the line search)."""
    to = env.cfg.trajectory_opt
    T1, it, dec = to.horizon_samples + 1, to.polish_iters, env.cfg.control.decimation
    mode = to.polish_method if it else "none"
    b1 = to.num_diffuse_steps * T1 + {"fd": 2 * T1 * it, "ilqr": 2 * T1}.get(mode, 0)
    engine = {"gradient": 2 * T1 * it, "ilqr": T1 + it * (T1 + 1)}.get(mode, 0) * dec
    return b1, engine


def zero_counts():
    pk.DecimatedEnvStep.launches = pk.DecimatedEnvStep.rough_launches = 0
    pk.DecimatedEnvStep.fixed_launches = 0
    EngineEnvStep.engine_substeps = 0


def counted_solve(env, state, nodes, seed=0):
    """One solve with the sampling noise drawn from a generator seeded with
    ``seed``: ``(nodes, info, {"B1": launches, "B2": ..., "engine_substeps": ...})``."""
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)
    zero_counts()
    out, info = env.optimize_all_trajectories(state, nodes, generator=gen)
    if env.device.type == "cuda":
        torch.cuda.synchronize()
    return out, info, {"B1": pk.DecimatedEnvStep.launches,
                       "B2": pk.DecimatedEnvStep.rough_launches,
                       "engine_substeps": EngineEnvStep.engine_substeps}


def node_scores(env, state, nodes):
    """Each env's summed discounted reward of its nodes on the fast route."""
    disc = env.traj_sampler._disc()
    with torch.no_grad():
        rew = env.rollout_batch(state, env.node2u_batch(nodes)[:, None])[:, 0]
    return torch.sum(rew * disc, dim=-1)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def bench_mode(mode, iters, reps, seed=0, device="cuda"):
    from torch.profiler import ProfilerActivity, profile

    env = polish_env(mode, iters, device)
    state = env.reset_all(seed=seed)
    nodes = env.traj_sampler.init_node_trajectories()
    with torch.no_grad():
        nodes, _, counts = counted_solve(env, state, nodes, seed)         # warm-up
        want = dict(zip(("B1", "engine_substeps"), expected_counts(env)), B2=0)
        if counts != want:
            raise RuntimeError(f"{mode}: counts {counts}, want {want}")
        times = []
        for i in range(reps):
            def solve():
                nonlocal nodes
                nodes, _ = env.optimize_all_trajectories(state, nodes)
            times.append(cuda_ms(solve))
        if not torch.isfinite(nodes).all():
            raise RuntimeError(f"{mode}: non-finite nodes")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            env.optimize_all_trajectories(state, nodes)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    busy = device_split(prof, 1)["device_busy_ms"]
    return dict(ms=sorted(times), counts=counts, profiled_wall_ms=wall, device_busy_ms=busy,
                idle_share=1.0 - busy / wall)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--polish-iters", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    pk.load_library()
    res = {}
    for mode in MODES:
        res[mode] = bench_mode(mode, args.polish_iters, args.reps, args.seed)
        print(f"# {mode}: {res[mode]['ms']} ms/solve, counts {res[mode]['counts']}, idle "
              f"{res[mode]['idle_share']:.3f}", flush=True)
    line = json.dumps({
        "script": "extended_legged_gym_tpu_torch/scripts/bench_polish.py",
        "card": card(), "torch": torch.__version__, "cuda": torch.version.cuda,
        "shape": f"E=1 Nsample=127 Hsample=16 Hnode=4 Ndiffuse=2 polish_iters={args.polish_iters}",
        "timing": f"CUDA events, median of {args.reps} chained solves after one warm-up solve",
        "solve_ms_by_polish_mode": {m: r["ms"][len(r["ms"]) // 2] for m, r in res.items()},
        "solve_ms_all": {m: r["ms"] for m, r in res.items()},
        "counts_per_solve": {m: r["counts"] for m, r in res.items()},
        "profiled_solve": {m: {k: r[k] for k in ("profiled_wall_ms", "device_busy_ms",
                                                 "idle_share")} for m, r in res.items()},
        "note": ("fd polishes through the fused kernel (B1); gradient and ilqr through the "
                 "plain engine under autograd and forward-mode AD.  POLISH_r03.json holds the "
                 "JAX package's TPU times: history, not targets."),
    })
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
