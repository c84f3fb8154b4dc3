"""Learning-curve evidence for distillation and the terrain estimator (port
of ``scripts/evidence_artifacts.py``).

* ``distill``: teacher -> student behaviour cloning on ``anymal_c_flat``
  (observation noise off; randomization and pushes on, as in training) at
  the ``DISTILL_NATIVE_r5`` recipe: an engine-native teacher checkpoint
  (``--teacher-ckpt``, a PPO ``.pkl``), a (256, 256, 128) MLP student, 24
  steps per env, 2 epochs of gradient_length-15 chunks (4 optimizer steps
  per iteration), exploration noise 0.05, the learning rate optax's
  ``cosine_decay_schedule(1e-3, decay_steps=2 * iters, alpha=0.1)`` stepped
  per optimizer update.  Then the student alone, clean env (no noise,
  randomization or pushes), 0.5 m/s, 100 warm-up + 300 recorded steps:
  tracking and falls (resets).  Without ``--teacher-ckpt`` the teacher is
  the JAX script's default, the reference's ``.pt`` (``REF_CKPT``, relative
  to the working directory) through the DOF bridge; it fails where that
  file is absent.
* ``estimator``: the ``ESTIMATOR_r4`` recipe: ``anymal_c_flat`` with the
  depth camera (48 x 24 -> 32 x 16) and 32 spherical rays (8 x 4, 5 m),
  random actions, the supervised loss curve.

Each samples the curve every ``iters / 20`` iterations (the last loss of
each chunk, as the JAX script does) and writes one JSON with the JAX
artifact's numbers and the card beside its own.

Usage, from the repository root (on a CUDA card):

  python -m extended_legged_gym_tpu_torch.scripts.evidence_artifacts distill \\
      --teacher-ckpt logs/flat_anymal_c/Aug21_12-38-39_r5_ft4/model_final.pkl \\
      [--iters 1500] [--envs 256] [--out DISTILL_NATIVE_torch_rNN.json]
  python -m extended_legged_gym_tpu_torch.scripts.evidence_artifacts estimator \\
      [--iters 300] [--envs 64] [--out ESTIMATOR_torch_rNN.json]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..rl.torch_compat import REF_CKPT
from .eval_policy import card_name


def _chunked_curve(learn, total: int, chunk: int, keys):
    """``learn(n)`` in chunks of ``chunk``: ``[[iterations done, {key: last
    value}], ...]`` and the chunks' last timing rows."""
    curve, times, done = [], [], 0
    while done < total:
        n = min(chunk, total - done)
        last = learn(n)
        done += n
        curve.append([done, {k: round(float(last[k]), 6) for k in keys}])
        times.append({k: last[k] for k in ("collection_s", "update_s")})
    return curve, times


def _timing(times, iters: int, wall: float) -> dict:
    """The wall time, and the collection / update split of each chunk's
    last iteration averaged over the chunks."""
    def mean(k):
        return sum(t[k] for t in times) / len(times)

    return {"wall_time_s": wall, "s_per_iteration": wall / iters,
            "collection_s_per_iteration_sampled": mean("collection_s"),
            "update_s_per_iteration_sampled": mean("update_s")}


def _reference(path: str, keys) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        ref = json.load(f)
    return {"reference": {"source": os.path.basename(path), **{k: ref[k] for k in keys}}}


@torch.no_grad()
def student_eval(policy, envs: int, device, cmd_mps: float = 0.5, warmup: int = 100,
                 steps: int = 300, seed: int = 3) -> dict:
    """The student on the clean flat env: tracking and resets over ``steps``
    after ``warmup``."""
    from ..envs.legged_robot import LeggedRobot
    from ..robots.anymal_c import anymal_c_flat_cfg

    cfg = anymal_c_flat_cfg()
    cfg.env.num_envs = envs
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.randomize_friction = False
    cfg.domain_rand.randomize_base_mass = False
    cfg.commands.resampling_time = 1e9
    env = LeggedRobot(cfg, device=device)
    s = env.reset_all(seed=seed)
    cmd = torch.zeros_like(s.commands)
    cmd[:, 0] = cmd_mps
    s = s.replace(commands=cmd)
    vx, falls = [], []
    for i in range(warmup + steps):
        s = env.step(s, policy(s.obs)).replace(commands=cmd)
        if i >= warmup:
            vx.append(s.base_lin_vel[:, 0].mean())
            falls.append(s.reset_buf.sum())
    return {"command_mps": cmd_mps,
            "achieved_over_command": round(torch.stack(vx).mean().item() / cmd_mps, 4),
            "falls": float(torch.stack(falls).sum().item()),
            "n_envs": envs, "n_steps": steps, "warmup": warmup, "seed": seed}


def distill_runner(teacher_ckpt: str, envs: int, iters: int, device="cuda"):
    """The ``DISTILL_NATIVE_r5`` recipe's runner for ``iters`` iterations on
    ``anymal_c_flat`` at ``envs`` envs, the teacher ``teacher_ckpt``'s
    deterministic policy (a PPO ``.pkl``, or a reference ``.pt`` through the
    DOF bridge)."""
    from ..envs.legged_robot import LeggedRobot
    from ..rl.distillation import cosine_decay_schedule
    from ..rl.distillation_runner import DistillationRunner
    from ..rl.runner import OnPolicyRunner
    from ..rl.torch_compat import load_reference_policy
    from ..robots.anymal_c import anymal_c_flat_cfg, anymal_c_ppo_cfg
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    cfg = anymal_c_flat_cfg()
    cfg.env.num_envs = envs
    cfg.noise.add_noise = False
    env = LeggedRobot(cfg, device=dev)
    if teacher_ckpt.endswith(".pt"):
        # the reference's teacher, bridged to the engine's DOF order
        teacher = load_reference_policy(teacher_ckpt, env.num_obs, env.num_actions,
                                        our_joint_names=env.model.joint_names, device=dev)[2]
    else:
        teacher_runner = OnPolicyRunner(env, anymal_c_ppo_cfg())
        teacher_runner.load(teacher_ckpt)
        teacher = teacher_runner.get_inference_policy()
    lr = cosine_decay_schedule(1e-3, decay_steps=max(1, iters * 2), alpha=0.1)
    return DistillationRunner(env, teacher,
                              student_hidden_dims=(256, 256, 128), num_steps_per_env=24,
                              num_learning_epochs=2, learning_rate=lr)


def distill(args) -> dict:
    runner = distill_runner(args.teacher_ckpt, args.envs, args.iters, args.device)
    dev = runner.device
    t0 = time.perf_counter()
    curve, times = _chunked_curve(runner.learn, args.iters, max(1, args.iters // 20),
                                  ("behavior_loss",))
    wall = time.perf_counter() - t0
    out = {
        "artifact": f"distillation ({args.teacher_ckpt} teacher -> MLP student), PyTorch port",
        "teacher": args.teacher_ckpt,
        "iterations": args.iters, "num_envs": args.envs,
        "recipe": {"student_hidden_dims": [256, 256, 128], "num_steps_per_env": 24,
                   "num_learning_epochs": 2, "gradient_length": 15,
                   "optimizer_steps_per_iteration": runner.alg.num_updates // args.iters,
                   "exploration_std": runner.exploration_std,
                   "learning_rate": "cosine_decay_schedule(1e-3, decay_steps=2 * iters, "
                                    "alpha=0.1) per optimizer step",
                   "final_learning_rate": runner.alg.learning_rate},
        "behavior_loss_first": curve[0][1]["behavior_loss"],
        "behavior_loss_final": curve[-1][1]["behavior_loss"],
        "curve": curve,
        "timing": _timing(times, args.iters, wall),
        "student_eval": student_eval(runner.get_student_policy(), args.envs, dev),
        "card": card_name(dev),
        **_reference(args.reference or "DISTILL_NATIVE_r5.json",
                     ("teacher", "iterations", "num_envs", "behavior_loss_first",
                      "behavior_loss_final", "student_eval")),
    }
    return out


def estimator_env(envs: int, device="cuda"):
    """The ``ESTIMATOR_r4`` recipe's env: ``anymal_c_flat`` with the depth
    camera (48 x 24 -> 32 x 16) and 32 spherical rays (8 x 4, 5 m)."""
    from ..envs.legged_robot import LeggedRobot
    from ..robots.anymal_c import anymal_c_flat_cfg

    cfg = anymal_c_flat_cfg()
    cfg.env.num_envs = envs
    cfg.depth.camera_type = "Warp"
    cfg.depth.original = [48, 24]
    cfg.depth.resized = [32, 16]
    cfg.raycaster.enable_raycast = True
    cfg.raycaster.ray_pattern = "spherical"
    cfg.raycaster.spherical_num_azimuth = 8
    cfg.raycaster.spherical_num_elevation = 4
    cfg.raycaster.max_distance = 5.0
    return LeggedRobot(cfg, device=device)


def estimator(args) -> dict:
    from ..rl.terrain_estimator_runner import TerrainEstimatorRunner
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    env = estimator_env(args.envs, dev)
    runner = TerrainEstimatorRunner(env, seed=0)
    t0 = time.perf_counter()
    curve, times = _chunked_curve(runner.learn, args.iters, max(1, args.iters // 20), ("loss",))
    wall = time.perf_counter() - t0
    return {
        "artifact": "terrain estimator (anymal_c_flat depth + spherical raycast: depth + "
                    "proprio -> raycast distances), PyTorch port",
        "iterations": args.iters, "num_envs": args.envs,
        "recipe": {"camera": "48 x 24 -> 32 x 16", "rays": "spherical 8 x 4, 5 m",
                   "num_steps_per_env": runner.num_steps_per_env, "encoder": runner.encoder_name,
                   "learning_rate": runner.learning_rate, "actions": "0.3 * N(0, 1)", "seed": 0},
        "loss_first": curve[0][1]["loss"],
        "loss_final": curve[-1][1]["loss"],
        "curve": curve,
        "timing": _timing(times, args.iters, wall),
        "card": card_name(dev),
        **_reference(args.reference or "ESTIMATOR_r4.json",
                     ("iterations", "num_envs", "loss_first", "loss_final")),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("which", choices=["distill", "estimator"])
    ap.add_argument("--iters", type=int, default=None,
                    help="iterations (distill 1500, estimator 300)")
    ap.add_argument("--envs", type=int, default=None, help="envs (distill 256, estimator 64)")
    ap.add_argument("--teacher-ckpt", default=REF_CKPT,
                    help="teacher: an engine-native .pkl, or the reference .pt (default) through "
                         "the DOF bridge (distill)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reference", default=None, help="the JAX artifact to set beside")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.which == "distill":
        args.iters, args.envs = args.iters or 1500, args.envs or 256
        out = distill(args)
    else:
        args.iters, args.envs = args.iters or 300, args.envs or 64
        out = estimator(args)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
