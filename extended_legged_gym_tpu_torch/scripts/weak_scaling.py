"""Scaling of the sample-sharded MPC rollout (port of
``scripts/weak_scaling.py``).

* :func:`measure`: weak scaling.  The sampling MPC's hot path,
  ``rollout_batch`` (E main envs x S samples x H+1 control steps, each step
  one launch of the fused physics step), with the samples axis sharded over
  the processes of ``torch.distributed`` (one card each) at a constant
  number of samples per process: each rank rolls out its slice and the
  rewards are all-gathered, four data-dependent rollouts in a chain.  One
  call measures the world it runs in; run it under ``torchrun
  --nproc_per_node N`` for N cards.
* :func:`measure_strong_singlechip`: single-card saturation, rollouts per
  second against the rollout batch (E=2, H=16, S = 64 ... 4096 samples):
  where the card saturates, i.e. how many samples each card of a sharded
  run needs.

Writes one JSON (``--out``, default ``SCALING_torch_r01.json``) with the
card's name and power limit beside the rows.  The JAX package's own
history of this measurement is ``SCALING.md``.

Usage, from the repository root:

  python -m extended_legged_gym_tpu_torch.scripts.weak_scaling [--out F.json]
  torchrun --nproc_per_node 4 -m extended_legged_gym_tpu_torch.scripts.weak_scaling --weak-only \
      --out SCALING_torch_w4.json
  python -m extended_legged_gym_tpu_torch.scripts.weak_scaling --device cpu --sizes 8 16
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Sequence

import torch

SIZES = (64, 128, 256, 512, 1024, 2048, 4096)
CHAIN = 4                          # data-dependent rollouts per timed chain


def rollout_env(n_envs: int, samples: int, horizon: int, device="cuda"):
    """The flagship ANYmal-C sampling config at E=``n_envs``, S=``samples``
    (``num_samples`` = S - 1 plus the mean), H=``horizon``."""
    from ..envs.batch_rollout import RobotTrajGradSampling
    from ..robots.anymal_c_traj import anymal_c_traj_sampling_cfg

    cfg = anymal_c_traj_sampling_cfg(num_main_envs=n_envs)
    cfg.trajectory_opt.num_samples = samples - 1
    cfg.trajectory_opt.horizon_samples = horizon
    return RobotTrajGradSampling(cfg, device=device)


def candidates(env, samples: int, horizon: int, seed: int = 1) -> torch.Tensor:
    """``[E, S, H+1, A]`` candidate controls, N(0, 0.1²) from a CPU
    generator (the same on every rank), on the env's device."""
    g = torch.Generator().manual_seed(seed)
    us = 0.1 * torch.randn(env.num_envs, samples, horizon + 1, env.num_actions, generator=g)
    return us.to(env.device)


def sharded_rollout_batch(env, state, us_local: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's slice ``[E, S/n, H+1, A]`` rolled out, the rewards
    all-gathered into ``[E, S, H+1]`` (rank order)."""
    from ..parallel.mesh import gather_batch

    return gather_batch(env.rollout_batch(state, us_local), mesh, axis=1)


def _chain(env, state, us, mesh=None) -> float:
    """CHAIN rollouts, each control sequence moved by the last rollout's
    mean reward, then one scalar read (the barrier); returns that scalar."""
    c, total = us, None
    for _ in range(CHAIN):
        r = env.rollout_batch(state, c) if mesh is None else sharded_rollout_batch(
            env, state, c, mesh)
        c = c * 0.999 + r.mean() * 1e-6
        total = r.sum() if total is None else total + r.sum()
    return float(total.item())


def measure(samples_per_device: int = 16, horizon: int = 16, n_envs: int = 2, mesh=None,
            device="cuda", reps: int = 3) -> dict:
    """One weak-scaling row for the world this process runs in: S =
    ``samples_per_device`` x world size samples, each rank rolling out its
    ``samples_per_device``; the best of ``reps`` chains (after a warm-up),
    per rollout."""
    from ..parallel.mesh import make_mesh, replicate, shard_batch

    mesh = mesh or make_mesh(axis_name="s", device=device)
    S = samples_per_device * mesh.size
    env = rollout_env(n_envs, samples_per_device, horizon, mesh.device)
    state = replicate(env.reset_all(seed=0), mesh)
    us = shard_batch(candidates(env, S, horizon), mesh, S, axis=1)
    _chain(env, state, us, mesh)                                    # warm-up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _chain(env, state, us, mesh)
        times.append((time.perf_counter() - t0) / CHAIN)
    dt = min(times)
    return dict(devices=mesh.size, samples=S, samples_per_device=samples_per_device,
                rollouts=n_envs * S, t_rollout_s=dt, rollouts_per_s=n_envs * S / dt)


def measure_strong_singlechip(horizon: int = 16, n_envs: int = 2, sizes: Sequence[int] = SIZES,
                              device="cuda", reps: int = 3) -> list:
    """Rollouts per second against the batch on one card: for each S, the
    best of ``reps`` chains after a warm-up, per rollout."""
    rows = []
    for S in sizes:
        env = rollout_env(n_envs, S, horizon, device)
        state = env.reset_all(seed=0)
        us = candidates(env, S, horizon)
        _chain(env, state, us)                                        # warm-up
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            _chain(env, state, us)
            times.append((time.perf_counter() - t0) / CHAIN)
        dt = min(times)
        rows.append(dict(samples=S, rollouts=n_envs * S, t_rollout_s=dt,
                         rollouts_per_s=n_envs * S / dt))
    return rows


def main(argv=None) -> dict:
    from ..parallel.distributed import init_multi_host, shutdown
    from .eval_policy import card_name

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="SCALING_torch_r01.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", type=int, nargs="*", default=list(SIZES))
    ap.add_argument("--samples-per-device", type=int, default=16)
    ap.add_argument("--weak-only", action="store_true",
                    help="only the sharded measurement (the sweep is single-card)")
    args = ap.parse_args(argv)
    info = init_multi_host(device=args.device)
    try:
        weak = measure(args.samples_per_device, device=info["device"])
        strong = ([] if args.weak_only or info["process_count"] > 1 else
                  measure_strong_singlechip(sizes=args.sizes, device=info["device"]))
    finally:
        shutdown()
    out = dict(artifact="sample-sharded MPC rollout scaling, PyTorch port",
               card=card_name(info["device"]), horizon=16, n_envs=2, chain=CHAIN,
               weak=[weak], singlechip=strong)
    if info["is_main"]:
        print(json.dumps(out))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
