"""Where a training iteration goes, on one card.  ``--path``:

* ``ppo`` (default): a registered task's PPO at its training recipe from
  scratch, by default ``anymal_c_flat`` at TRAIN_r5's (4096 envs, 24 steps
  per env, 5 x 4 minibatches, seed 2); ``--task anymal_c_rough --seed 1`` is
  TRAIN_ROUGH_r5's (the terrain curriculum, the [512, 256, 128] networks);
  ``--task anymal_c_flat_sea`` runs the SEA actuator network (one torques-in
  B1 launch per substep), ``--task elspider_air_flat --seed 1`` the hexapod,
  ``--task franka --num_envs 1024`` the arm on the fixed-base regime; any
  other registered PPO task the same way, e.g. ``--task cassie`` (B2 on the
  biped's grid), ``--task anymal_c_rough_teacher`` (the critic on the
  privileged observation) or ``--task foot_track_elspider_air_hang`` (the
  hexapod on the fixed-base regime);
* ``ppo_recurrent``: the task's PPO with the recurrent policy
  (``ActorCriticRecurrent``, an LSTM of the config's 512 units before each
  MLP) and RND intrinsic rewards (``RND_CFG``);
* ``estimator_ray``: the terrain estimator on the ray task under the closed
  loop's protocol (128 envs, levels <= 2), the committed ray policy driving;
* ``estimator_flat``: the terrain estimator at the ESTIMATOR_r4 recipe (flat,
  64 envs, random actions);
* ``distill``: distillation at the DISTILL_NATIVE_r5 recipe (flat, 256 envs,
  the committed teacher).

After ``warmup`` iterations: the seconds per iteration split into collection
and update (host clock around each part, ending in a synchronize) over
``iters`` iterations, and, from a torch.profiler trace of ``reps``
iterations, the wall ms per iteration (profiler on), the device-busy ms per
iteration, the device's idle share against the profiled wall
(``device_idle_share``) and against the unprofiled iteration
(``device_idle_share_unprofiled``; the profiler's host overhead stretches the
wall, so the first is the larger), the physics kernel's (B1 on flat
ground, B2 on a heightfield) ms and launches per iteration, and the device
kernels that take the most time.  On the PPO paths also the host ms that
``OnPolicyRunner.learn``'s ``MetricsWriter.write`` adds per iteration, with
the JSONL file alone and with the TensorBoard sink (where it imports), its
share of an iteration of ``learn`` (the unprofiled iteration plus the
write), and the first write's ms (the sink's import and set-up).

Usage, from the repository root:

  python -m extended_legged_gym_tpu_torch.scripts.bench_train [--path ppo] \\
      [--task anymal_c_flat] [--seed 2] [--iters 10] [--reps 2] [--num_envs 4096]

Prints one JSON object.
"""
import argparse
import json
import tempfile
import time

import torch

from extended_legged_gym_tpu_torch import robots  # noqa: F401  (populates the registry)
from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner
from extended_legged_gym_tpu_torch.scripts.bench_mpc import device_split
from extended_legged_gym_tpu_torch.scripts.eval_policy import card_name
from extended_legged_gym_tpu_torch.utils.metrics import MetricsWriter
from extended_legged_gym_tpu_torch.utils.task_registry import get_args, task_registry

TEACHER = "logs/flat_anymal_c/Aug21_12-38-39_r5_ft4/model_final.pkl"
# the RND settings of the recurrent recipe (the JAX runner's defaults: a
# (256, 256) -> 64 target and predictor, Adam at 1e-3)
RND_CFG = {"weight": 1.0, "learning_rate": 1e-3}


def recurrent_train_cfg(train_cfg, rnn_type: str = "lstm"):
    """``train_cfg`` with the recurrent policy and RND."""
    train_cfg.runner.policy_class_name = "ActorCriticRecurrent"
    train_cfg.policy.rnn_type = rnn_type
    train_cfg.algorithm.rnd_cfg = dict(RND_CFG)
    return train_cfg


def top_device_kernels(prof, reps: int, n: int = 8):
    """The ``n`` device kernels with the most self time: ``[name, ms per
    iteration, launches per iteration]``."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        rows.append([ev.key[:80], us / 1e3 / reps, ev.count / reps])
    return sorted(rows, key=lambda r: -r[1])[:n]


def profile_iterations(iterate, warmup: int, iters: int, reps: int) -> dict:
    """``iterate()`` runs one iteration and returns its ``{"collection_s",
    "update_s"}``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        iterate()
    col = upd = 0.0
    for _ in range(iters):
        times = iterate()
        col += times["collection_s"]
        upd += times["update_s"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            iterate()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    split = device_split(prof, reps)
    return dict(collection_s=col / iters, update_s=upd / iters,
                s_per_iteration=(col + upd) / iters,
                profiled_wall_ms=wall_ms, device_busy_ms=split["device_busy_ms"],
                device_idle_share=1.0 - split["device_busy_ms"] / wall_ms,
                device_idle_share_unprofiled=1.0 - split["device_busy_ms"] * iters
                / ((col + upd) * 1e3),
                kernel_ms=split["physics_kernel_ms"], kernel_launches=split["physics_launches"],
                top_device_kernels=top_device_kernels(prof, reps))


def metrics_write_ms(metrics: dict, n: int = 50) -> dict:
    """Host ms per ``MetricsWriter.write`` of one iteration's ``metrics`` (a
    dict of floats), after a first write timed apart, for the JSONL file
    alone and with the TensorBoard sink; the sinks each writer opened."""
    out = {}
    for name, use_tb in (("jsonl", False), ("jsonl+tensorboard", True)):
        with tempfile.TemporaryDirectory() as d:
            w = MetricsWriter(d, use_tensorboard=use_tb, backend="tensorboard")
            t0 = time.perf_counter()
            w.write(0, metrics)
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            for i in range(1, n + 1):
                w.write(i, metrics)
            out[name] = dict(ms=(time.perf_counter() - t0) * 1e3 / n, first_ms=first * 1e3,
                             sinks=[type(s).__name__ for s in w.sinks])
            w.close()
    return out


def ppo_iteration(task: str, seed: int, device, recurrent: bool = False, num_envs: int = 4096):
    args = get_args(argv=["--seed", str(seed), "--num_envs", str(num_envs), "--device",
                          str(device)])
    env, _ = task_registry.make_env(task, args)
    _, train_cfg = task_registry.get_cfgs(task)
    train_cfg.seed = seed
    if recurrent:
        recurrent_train_cfg(train_cfg)
    runner = OnPolicyRunner(env, train_cfg)
    last = {}

    def iterate():
        last["metrics"] = runner.train_iteration()
        return runner.last_times

    def write_cost():
        m = {k: float(v) for k, v in last["metrics"].items()}
        return metrics_write_ms({**m, **runner.last_times, "fps": 0.0})

    return iterate, dict(task=task, seed=seed, envs=env.num_envs, recurrent=recurrent,
                         steps_per_env=runner.num_steps_per_env), write_cost


def estimator_iteration(path: str, device):
    from extended_legged_gym_tpu_torch.rl.terrain_estimator_runner import TerrainEstimatorRunner
    from extended_legged_gym_tpu_torch.scripts.estimator_closed_loop import build_env
    from extended_legged_gym_tpu_torch.scripts.eval_raycast import RAY_CKPT
    from extended_legged_gym_tpu_torch.scripts.eval_rough import load_policy
    from extended_legged_gym_tpu_torch.scripts.evidence_artifacts import estimator_env

    if path == "estimator_ray":
        env = build_env(128, 2, device)
        policy = load_policy(RAY_CKPT, env.num_obs, env.num_actions, device)
    else:
        env, policy = estimator_env(64, device), None
    runner = TerrainEstimatorRunner(env, seed=0, policy=policy)
    state = [env.reset_all()]

    def iterate():
        state[0], _ = runner.collect_and_update(state[0])
        return runner.last_times

    task = "anymal_c_rough_raycast" if path == "estimator_ray" else "anymal_c_flat"
    return iterate, dict(task=task, envs=env.num_envs, steps_per_env=runner.num_steps_per_env)


def distill_iteration(device):
    from extended_legged_gym_tpu_torch.scripts.evidence_artifacts import distill_runner

    runner = distill_runner(TEACHER, 256, 1500, device)

    def iterate():
        runner.train_iteration()
        return runner.last_times

    return iterate, dict(task="anymal_c_flat", envs=runner.env.num_envs,
                         steps_per_env=runner.num_steps_per_env)


def train_profile(warmup=3, iters=10, reps=2, device="cuda", task="anymal_c_flat", seed=2,
                  path="ppo", num_envs=4096):
    write_cost = None
    if path in ("ppo", "ppo_recurrent"):
        iterate, info, write_cost = ppo_iteration(
            task, seed, device, recurrent=path == "ppo_recurrent", num_envs=num_envs)
    elif path == "distill":
        iterate, info = distill_iteration(device)
    else:
        iterate, info = estimator_iteration(path, device)
    out = profile_iterations(iterate, warmup, iters, reps)
    if write_cost is not None:
        out["metrics_write"] = write_cost()
        for w in out["metrics_write"].values():
            w["share_of_learn_iteration"] = w["ms"] / (w["ms"] + out["s_per_iteration"] * 1e3)
    return dict(path=path, **info, **out,
                env_steps_per_s=info["envs"] * info["steps_per_env"] / out["s_per_iteration"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", default="ppo",
                    choices=["ppo", "ppo_recurrent", "estimator_ray", "estimator_flat", "distill"])
    ap.add_argument("--task", default="anymal_c_flat")
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--num_envs", type=int, default=4096)
    args = ap.parse_args()
    out = train_profile(args.warmup, args.iters, args.reps, task=args.task, seed=args.seed,
                        path=args.path, num_envs=args.num_envs)
    print(json.dumps({"card": card_name("cuda"), **out}))


if __name__ == "__main__":
    main()
