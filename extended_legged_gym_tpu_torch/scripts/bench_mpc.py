"""Sampling-MPC timings of the port on one CUDA card, in the JSON shape of the
repository's ``bench.py``: rollout throughput at E=16, S=128, H=64 and the
latency of one full ``optimize_all_trajectories`` solve at the committed
config (Nsample=127, Hsample=16, Hnode=4, Ndiffuse=2, fd polish x2), E=1.

Times come from CUDA events after warm-up; ``solve_profile`` adds a
torch.profiler breakdown of one solve (device-busy share, physics kernel
share).  Usage, from the repository root:
  python -m extended_legged_gym_tpu_torch.scripts.bench_mpc [--solves N] [--seed S]
"""
import argparse
import json
import time

import torch

from extended_legged_gym_tpu_torch.robots.anymal_c_traj import (AnymalCTrajGradSampling,
                                                               anymal_c_traj_sampling_cfg)
from extended_legged_gym_tpu_torch.utils.config import class_to_dict


def cuda_ms(fn, reps=1, warmup=0):
    """Mean milliseconds of ``reps`` back-to-back calls of ``fn()``, timed
    with CUDA events after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rollout_throughput(device="cuda", E=16, S=128, H=64, reps=3, seed=0):
    """(ms per rollout_batch, rollouts/s) for E envs x S samples x H steps."""
    cfg = anymal_c_traj_sampling_cfg(E)
    cfg.trajectory_opt.num_samples = S - 1
    cfg.trajectory_opt.horizon_samples = H
    cfg.trajectory_opt.horizon_nodes = 16
    env = AnymalCTrajGradSampling(cfg, device=device)
    state = env.reset_all(seed=seed)
    g = torch.Generator(device=env.device)
    g.manual_seed(seed + 1)
    all_us = env.node2u_batch(0.1 * torch.randn(E, S, 17, env.num_actions, generator=g,
                                                device=env.device))
    rew = env.rollout_batch(state, all_us)                        # warm-up
    if not torch.isfinite(rew).all():
        raise RuntimeError("non-finite rollout rewards")
    ms = sorted(cuda_ms(lambda: env.rollout_batch(state, all_us)) for _ in range(reps))[reps // 2]
    return ms, E * S / ms * 1e3


def solve_latency(device="cuda", n_solves=15, warmup=3, seed=0):
    """Sorted per-solve milliseconds of optimize_all_trajectories at E=1."""
    env = AnymalCTrajGradSampling(anymal_c_traj_sampling_cfg(1), device=device)
    state = env.reset_all(seed=seed)
    nodes = env.traj_sampler.init_node_trajectories()
    for _ in range(warmup):
        nodes, _ = env.optimize_all_trajectories(state, nodes)
    times = []
    for _ in range(n_solves):
        def solve():
            nonlocal nodes
            nodes, _ = env.optimize_all_trajectories(state, nodes)
        times.append(cuda_ms(solve))
    if not torch.isfinite(nodes).all():
        raise RuntimeError("non-finite node trajectories")
    return sorted(times), env.cfg.trajectory_opt


def solve_profile(device="cuda", reps=3, seed=0):
    """Where one solve's time goes, from a torch.profiler trace of ``reps``
    solves at E=1: wall ms per solve (profiler on), device-busy ms (sum of
    kernel times on the one stream), the fused physics kernel's ms and its
    launch count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    env = AnymalCTrajGradSampling(anymal_c_traj_sampling_cfg(1), device=device)
    state = env.reset_all(seed=seed)
    nodes, _ = env.optimize_all_trajectories(state, env.traj_sampler.init_node_trajectories())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            nodes, _ = env.optimize_all_trajectories(state, nodes)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    busy_us = kernel_us = launches = 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:          # count device kernels only
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        busy_us += us
        if "decimated_step_kernel" in ev.key:
            kernel_us += us
            launches += ev.count
    return dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3 / reps,
                physics_kernel_ms=kernel_us / 1e3 / reps, physics_launches=launches / reps)


def percentile(sorted_ms, q):
    """The bench.py convention: p50 = middle sample, p90 = the 0.9·n-th."""
    if q == 50:
        return sorted_ms[len(sorted_ms) // 2]
    return sorted_ms[max(0, int(len(sorted_ms) * q / 100) - 1)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--solves", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rb_ms, rps = rollout_throughput(seed=args.seed)
    solves, to = solve_latency(n_solves=args.solves, seed=args.seed)
    prof = solve_profile(seed=args.seed)
    print(json.dumps({
        "metric": "rollouts/s/chip (ANYmal-C, H=64)", "value": round(rps, 2), "unit": "rollouts/s",
        "device": torch.cuda.get_device_name(0), "rollout_batch_ms": round(rb_ms, 3),
        "solve_p50_ms": round(percentile(solves, 50), 3),
        "solve_p90_ms": round(percentile(solves, 90), 3), "n_solves": len(solves),
        "solve_profile": {k: round(v, 3) for k, v in prof.items()},
        "solve_shape": (f"Nsample={to.num_samples} Hsample={to.horizon_samples}"
                        f" Hnode={to.horizon_nodes} Ndiffuse={to.num_diffuse_steps}"
                        f" polish={to.polish_method}x{to.polish_iters}"),
        "trajectory_opt": class_to_dict(to),
    }))


if __name__ == "__main__":
    main()
