"""Multi-process dry run of the port's sharded paths (the counterpart of
``__graft_entry__.dryrun_multichip``), and the timing of data-parallel PPO.

Passes, in the JAX function's order:

* ``toy_train``: one data-parallel PPO iteration of ``anymal_c_flat``
  through ``OnPolicyRunner(..., mesh=)``: 2 envs per rank, [32] actor and
  critic, 4 steps per env;
* ``toy_mpc``: one ``TrajGradSampling.optimize`` (1 main env, 2 samples per
  rank, H=8) whose rollout is sample-sharded over the ranks
  (``scripts/weak_scaling.py::sharded_rollout_batch``);
* ``train``: the committed shapes, 1024 global envs at
  ``anymal_c_ppo_cfg``'s [128, 64, 32] with 24 steps per env;
* ``mpc``: the flagship optimize, 127 samples + the mean = 128 rollouts
  sharded over the ranks, H=16, Hnode=4, AVWBFO (its config's fd polish is
  a separate call, which the JAX dry run does not make either).

The training passes turn the empirical normalizer on (the JAX dry run leaves
the config's default, off) so that its reduction runs too.  Each pass
checks that its outputs are finite and that the ranks agree bit for bit
(a SHA-256 of the parameters, the normalizer and the learning rate, or of
the optimized nodes, all-gathered), and holds the sharded optimize to a
one-process optimize of the same noise (1e-5).  Rank 0 prints one line per
pass: ``dryrun_multichip {json}``, with each rank's B1 launches.

Usage, from the repository root:

  torchrun --nproc_per_node N -m extended_legged_gym_tpu_torch.scripts.dryrun_multichip
  torchrun --nproc_per_node 2 -m extended_legged_gym_tpu_torch.scripts.dryrun_multichip \\
      --device cpu                   # gloo on the CPU
  python -m extended_legged_gym_tpu_torch.scripts.dryrun_multichip --time [--out F.json]

``--device cuda:0 --backend gloo`` puts every rank on card 0 over gloo (one
card cannot hold two NCCL ranks).  ``--time`` runs on one card: the
``anymal_c_flat`` training cell (4096 global envs, ``TRAIN_r5``'s recipe)
for TIME_ITERS iterations without a mesh and with a world-size-1 NCCL mesh,
interleaved, the replayed reductions of one iteration timed alone, then the
same cell over 2 gloo processes on the card; it prints one JSON object
with the card's name and power limit (and writes it to ``--out``).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TASK = "anymal_c_flat"
MPC_TOL = 1e-5
TIME_ENVS = 4096                   # the training cell's global envs
TIME_ITERS = 4                     # timed iterations per runner (after one warm-up)
REPLAYS = 10                       # replays of one iteration's reductions


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def digest(tensors: Sequence[torch.Tensor]) -> str:
    """SHA-256 of the tensors' bytes: equal exactly when every bit is."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def gather_objects(obj, mesh) -> list:
    """Every rank's ``obj``, in rank order."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out


def runner_tensors(runner) -> List[torch.Tensor]:
    """What the ranks of a data-parallel runner must hold alike: the
    parameters, the normalizer, the learning rate and the reward stage."""
    out = [p.detach() for p in runner.network.parameters()]
    if runner.obs_norm is not None:
        out += [runner.obs_norm.mean, runner.obs_norm.var, runner.obs_norm.count]
    return out + [runner.learning_rate, runner.env_state.reward_stage]


def training_runner(mesh, num_envs: int, steps_per_env: int, dims: Optional[Sequence[int]] = None,
                    normalizer: bool = True, seed: int = 2, device="cuda"):
    """``anymal_c_flat`` through the registry at ``num_envs`` global envs
    (``num_envs / world`` on this rank), ``steps_per_env`` steps per
    iteration, ``dims`` actor and critic (default: the task's), and its
    runner on ``mesh`` (``None``: one process, all envs, on ``device``)."""
    from .. import robots  # noqa: F401  (populates the registry)
    from ..rl.runner import OnPolicyRunner
    from ..utils.task_registry import task_registry

    env_cfg, train_cfg = task_registry.get_cfgs(TASK)
    env_cfg.env.num_envs = num_envs
    env_cfg.seed = train_cfg.seed = seed
    train_cfg.runner.num_steps_per_env = steps_per_env
    train_cfg.runner.empirical_normalization = normalizer
    if dims is not None:
        train_cfg.policy.actor_hidden_dims = train_cfg.policy.critic_hidden_dims = list(dims)
    dev = mesh.device if mesh is not None else device
    env, _ = task_registry.make_env(TASK, env_cfg=env_cfg, device=dev, mesh=mesh)
    return OnPolicyRunner(env, train_cfg, mesh=mesh)


def train_pass(mesh, num_envs: int, steps_per_env: int, dims: Optional[Sequence[int]] = None,
               name: str = "train") -> Dict:
    """One data-parallel PPO iteration; the ranks must agree bit for bit."""
    from ..ops import physics_kernel as pk

    runner = training_runner(mesh, num_envs, steps_per_env, dims)
    _sync(mesh.device)
    pk.DecimatedEnvStep.launches = 0
    t0 = time.perf_counter()
    metrics = runner.train_iteration()
    _sync(mesh.device)
    seconds = time.perf_counter() - t0
    launches = pk.DecimatedEnvStep.launches
    state = runner_tensors(runner)
    finite = bool(torch.isfinite(metrics["loss"])) and all(
        bool(torch.isfinite(t.float()).all()) for t in state)
    ranks = gather_objects(dict(digest=digest(state), launches=launches, finite=finite,
                                loss=float(metrics["loss"])), mesh)
    out = {"pass": name, "ranks": mesh.size, "envs": num_envs,
           "envs_per_rank": runner.env.num_envs, "steps_per_env": steps_per_env,
           "dims": list(runner.cfg.policy.actor_hidden_dims), "seconds": seconds,
           "launches": [r["launches"] for r in ranks], "loss": [r["loss"] for r in ranks],
           "agree": len({r["digest"] for r in ranks}) == 1,
           "finite": all(r["finite"] for r in ranks)}
    if not (out["agree"] and out["finite"]):
        raise RuntimeError(f"dry run {name}: the ranks disagree or a value is not finite: {out}")
    return out


def mpc_pass(mesh, num_samples: int, horizon_samples: int, name: str = "mpc",
             seed: int = 1) -> Dict:
    """One ``optimize`` of the flagship sampling config (1 main env) with its
    rollout sample-sharded over the ranks, against the one-process
    ``optimize`` of the same noise."""
    from ..envs.batch_rollout import RobotTrajGradSampling
    from ..ops import physics_kernel as pk
    from ..parallel.mesh import replicate, shard_batch
    from ..robots.anymal_c_traj import anymal_c_traj_sampling_cfg
    from .weak_scaling import sharded_rollout_batch

    cfg = anymal_c_traj_sampling_cfg(num_main_envs=1)
    cfg.trajectory_opt.num_samples = num_samples
    cfg.trajectory_opt.horizon_samples = horizon_samples
    S = num_samples + 1
    if S % mesh.size:
        raise ValueError(f"{S} rollouts do not divide over {mesh.size} processes")
    env = RobotTrajGradSampling(cfg, device=mesh.device)
    state = replicate(env.reset_all(seed=seed), mesh)
    sampler = env.traj_sampler
    nodes = sampler.init_node_trajectories()
    g = torch.Generator().manual_seed(seed + 1)
    noise = torch.randn((1, 1, num_samples, cfg.trajectory_opt.horizon_nodes + 1,
                         env.num_actions), generator=g).to(mesh.device)

    def sharded(all_us):
        return sharded_rollout_batch(env, state, shard_batch(all_us, mesh, S, axis=1), mesh)

    _sync(mesh.device)
    pk.DecimatedEnvStep.launches = 0
    t0 = time.perf_counter()
    out, info = sampler.optimize(nodes, sharded, 1, noise=noise)
    _sync(mesh.device)
    seconds = time.perf_counter() - t0
    launches = pk.DecimatedEnvStep.launches
    whole, _ = sampler.optimize(nodes, lambda us: env.rollout_batch(state, us), 1, noise=noise)
    err = float((out - whole).abs().max())
    finite = bool(torch.isfinite(out).all() and torch.isfinite(info["rew_mean"]).all())
    ranks = gather_objects(dict(digest=digest([out]), launches=launches, finite=finite,
                                err=err), mesh)
    res = {"pass": name, "ranks": mesh.size, "rollouts": S, "rollouts_per_rank": S // mesh.size,
           "horizon_samples": horizon_samples,
           "horizon_nodes": cfg.trajectory_opt.horizon_nodes,
           "update": cfg.trajectory_opt.update_method, "seconds": seconds,
           "launches": [r["launches"] for r in ranks],
           "max_abs_err": max(r["err"] for r in ranks), "tolerance": MPC_TOL,
           "agree": len({r["digest"] for r in ranks}) == 1,
           "finite": all(r["finite"] for r in ranks)}
    if not (res["agree"] and res["finite"] and res["max_abs_err"] <= MPC_TOL):
        raise RuntimeError(f"dry run {name}: the ranks disagree, a value is not finite or the "
                           f"sharded optimize is off the one-process one: {res}")
    return res


PASSES = {
    "toy_train": lambda mesh: train_pass(mesh, 2 * mesh.size, 4, [32], "toy_train"),
    "toy_mpc": lambda mesh: mpc_pass(mesh, 2 * mesh.size - 1, 8, "toy_mpc"),
    "train": lambda mesh: train_pass(mesh, max(1024, 2 * mesh.size), 24, None, "train"),
    "mpc": lambda mesh: mpc_pass(mesh, 127, 16, "mpc"),
}


def join(device: str, backend: Optional[str]):
    """Join torchrun's group (world size 1 without it) and return
    ``init_multi_host``'s topology; ``backend="gloo"`` on a card starts a
    gloo group instead of NCCL's."""
    from ..parallel.distributed import init_multi_host

    env = os.environ
    if backend == "gloo" and int(env.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"tcp://{env['MASTER_ADDR']}:"
                                f"{env['MASTER_PORT']}", world_size=int(env["WORLD_SIZE"]),
                                rank=int(env["RANK"]))
    return init_multi_host(device=device)


def launch(argv: Sequence[str], n: int = 2) -> List[subprocess.Popen]:
    """Start this script in ``n`` processes of one group on a free local
    port (torchrun's environment variables)."""
    port = free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(n),
                   RANK=str(rank), LOCAL_RANK=str(rank),
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "extended_legged_gym_tpu_torch.scripts.dryrun_multichip",
             *argv], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def stop(procs: Sequence[subprocess.Popen]):
    """Kill the ``launch``ed processes still running."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def collect(procs: Sequence[subprocess.Popen], timeout: float = 600.0) -> List[str]:
    """Each ``launch``ed process's output; raises (having stopped them all)
    when one fails or outlasts ``timeout``."""
    outs = []
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        stop(procs)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} of {p.args[3:]} exited {p.returncode}:\n"
                               f"{out[-4000:]}")
    return outs


def results_of(out: str) -> List[Dict]:
    """The pass lines in one process's output."""
    return [json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
            if line.startswith("dryrun_multichip {")]


def _iteration_s(runner) -> float:
    _sync(runner.device)
    t0 = time.perf_counter()
    runner.train_iteration()
    _sync(runner.device)
    return time.perf_counter() - t0


def reductions_ms(runner, mesh) -> Tuple[float, List[Dict]]:
    """ms of one iteration's reductions replayed alone on zeros of their
    shapes (the advantage moments, one gradient buffer per minibatch step,
    the normalizer's two, the episode sums and the means), and the top
    operations of one replay under torch.profiler by self host time."""
    from torch.profiler import ProfilerActivity, profile

    from ..parallel.mesh import all_sum, pmean

    dev = mesh.device
    grads = torch.zeros(sum(p.numel() for p in runner.network.parameters()), device=dev)
    one = torch.zeros((), device=dev)
    steps = runner.ppo_cfg.num_learning_epochs * runner.ppo_cfg.num_mini_batches
    em = list(runner.env_state.episode_metrics.values())
    obs = torch.zeros(runner.env.num_obs, device=dev)

    def replay():
        pmean([one, one], mesh)
        for _ in range(steps):
            pmean([grads, one, one], mesh)
        if runner.obs_norm is not None:
            pmean([obs], mesh)
            pmean([obs], mesh)
        all_sum(em, mesh)
        pmean([one], mesh)

    replay()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(REPLAYS):
        replay()
    _sync(dev)
    ms = (time.perf_counter() - t0) / REPLAYS * 1e3
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        replay()
        _sync(dev)
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    top = [dict(name=e.key, calls=e.count, self_host_ms=e.self_cpu_time_total / 1e3,
                host_ms=e.cpu_time_total / 1e3,
                device_ms=getattr(e, "device_time_total", 0.0) / 1e3) for e in rows]
    return ms, top


def time_gloo_worker(device: str):
    """One rank of the 2-process gloo timing (``spawn``ed by ``time_main``)."""
    from ..parallel.distributed import shutdown
    from ..parallel.mesh import make_mesh

    info = join(device, "gloo")
    mesh = make_mesh(device=info["device"])
    try:
        runner = training_runner(mesh, TIME_ENVS, 24, normalizer=False)
        _iteration_s(runner)
        iters = [_iteration_s(runner) for _ in range(TIME_ITERS)]
        red, top = reductions_ms(runner, mesh)
        if info["is_main"]:
            print("dryrun_multichip " + json.dumps(
                {"pass": "time_gloo", "ranks": mesh.size, "envs_per_rank": runner.env.num_envs,
                 "iteration_s": iters, "reductions_ms": red, "reductions_top": top}), flush=True)
    finally:
        shutdown()


def time_main(args) -> Dict:
    """``--time``: world size 1 over NCCL against no mesh, interleaved, then
    2 gloo processes on the card."""
    from ..parallel.distributed import init_multi_host, shutdown
    from ..parallel.mesh import make_mesh
    from .eval_policy import card_name

    info = init_multi_host(f"127.0.0.1:{free_port()}", 1, 0, device=args.device)
    mesh = make_mesh(device=info["device"])
    try:
        plain = training_runner(None, TIME_ENVS, 24, normalizer=False, device=mesh.device)
        dp = training_runner(mesh, TIME_ENVS, 24, normalizer=False)
        for runner in (plain, dp):                                   # warm-up
            _iteration_s(runner)
        times = {"plain": [], "dp": []}
        for i in range(TIME_ITERS):
            for name in (("plain", "dp") if i % 2 == 0 else ("dp", "plain")):
                times[name].append(_iteration_s(plain if name == "plain" else dp))
        red, top = reductions_ms(dp, mesh)
        del plain, dp
    finally:
        shutdown()
    med = lambda xs: sorted(xs)[len(xs) // 2]
    world1 = dict(backend="nccl", envs=TIME_ENVS, iteration_s_plain=times["plain"],
                  iteration_s_dp=times["dp"], reductions_ms=red,
                  reductions_share=red / 1e3 / med(times["dp"]), reductions_top=top)
    gloo = results_of(collect(launch(["--gloo-timing", "--device", str(info["device"])], 2))[0])[0]
    gloo["reductions_share"] = gloo["reductions_ms"] / 1e3 / med(gloo["iteration_s"])
    out = dict(artifact="data-parallel PPO timing, PyTorch port", card=card_name(info["device"]),
               task=TASK, recipe="TRAIN_r5 (seed 2, [128, 64, 32], 24 steps per env)",
               world1_nccl=world1, gloo2_one_card=gloo)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


def main(argv=None):
    from ..parallel.distributed import shutdown
    from ..parallel.mesh import make_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on a card, gloo on the CPU")
    ap.add_argument("--passes", nargs="+", default=list(PASSES), choices=list(PASSES))
    ap.add_argument("--time", action="store_true", help="time data-parallel PPO on one card")
    ap.add_argument("--gloo-timing", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.time:
        return time_main(args)
    if args.gloo_timing:
        return time_gloo_worker(args.device)
    info = join(args.device, args.backend)
    mesh = make_mesh(device=info["device"])
    results = []
    try:
        for name in args.passes:
            res = PASSES[name](mesh)
            results.append(res)
            if info["is_main"]:
                print("dryrun_multichip " + json.dumps(res), flush=True)
    finally:
        shutdown()
    return results


if __name__ == "__main__":
    main()
