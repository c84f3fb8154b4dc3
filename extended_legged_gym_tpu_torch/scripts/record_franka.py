"""Write the Franka training artifact (``TRAIN_FRANKA_torch_rNN.json``): the
end-effector tracking of a ``franka`` training run's final policy beside the
freshly initialised policy of the same seed (iteration 0), what the run's
``metrics.jsonl`` says about the training, and where an iteration's time
goes on the card (``bench_train``'s profile of the ``franka`` task).

Evaluation: ``envs`` arms from one reset, ``steps`` control steps (one 8 s
episode is 400) of the deterministic policy; the position error is
``|ee_pos - target|`` and the orientation error ``|ee_quat - target_quat|``
(the reward terms' own measures), each averaged over the second half of every
4 s command segment (after the arm had time to reach a new target) and over
all steps; the episode return is the sum of the rewards over the steps,
averaged over the envs.  There is no JAX artifact of this task to set beside
it.

Usage, from the directory that holds ``logs/`` (on a CUDA card):

  python -m extended_legged_gym_tpu_torch.scripts.record_franka \\
      --run logs/franka_torch/<run> --seed 1 [--envs 64] [--steps 400] \\
      [--out TRAIN_FRANKA_torch_r01.json]

``--device cpu`` runs it on the CPU (no profile).
"""
from __future__ import annotations

import argparse
import json

import torch

from extended_legged_gym_tpu_torch import robots  # noqa: F401  (populates the registry)
from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner
from extended_legged_gym_tpu_torch.scripts.eval_policy import card_name
from extended_legged_gym_tpu_torch.scripts.record_training import read_metrics
from extended_legged_gym_tpu_torch.utils.device import resolve_device
from extended_legged_gym_tpu_torch.utils.task_registry import task_registry

TASK = "franka"


@torch.no_grad()
def track(env, policy, steps: int, seed: int) -> dict:
    """End-effector errors and the episode return of ``policy`` over
    ``steps`` control steps from ``env.reset_all(seed)``."""
    s = env.reset_all(seed=seed)
    seg = env.resampling_interval
    pos, ori, late_pos, late_ori, ret = [], [], [], [], torch.zeros(env.num_envs, device=env.device)
    for i in range(steps):
        s = env.step(s, policy(s.obs))
        ret += s.rew
        ee_pos, ee_quat, _, _ = env._ee_state(s.phys)
        p = torch.linalg.norm(ee_pos - s.commands[:, :3], dim=1).mean().item()
        o = torch.linalg.norm(ee_quat - s.commands[:, 3:7], dim=1).mean().item()
        pos.append(p)
        ori.append(o)
        if (i % seg) >= seg // 2:
            late_pos.append(p)
            late_ori.append(o)
    mean = lambda x: sum(x) / len(x)
    return dict(ee_pos_err_m=mean(late_pos), ee_ori_err=mean(late_ori),
                ee_pos_err_all_steps_m=mean(pos), ee_ori_err_all_steps=mean(ori),
                episode_return=ret.mean().item(), resets=int(s.reset_buf.sum()))


def training_side(run: str) -> dict:
    rows = read_metrics([run])
    done = [r for r in rows if r["episodes_done"] > 0]
    steady = rows[1:] if len(rows) > 1 else rows
    col = sum(r["collection_s"] for r in steady) / len(steady)
    upd = sum(r["update_s"] for r in steady) / len(steady)
    logged = lambda r: None if r is None else {
        "iteration": r["step"], "episode_return": r["mean_reward"],
        **{k: r[f"episode/rew_{k}"] for k in ("ee_position_tracking", "ee_orientation_tracking",
                                              "ee_velocity")}}
    return dict(iterations=len(rows),
                first_logged_episodes=logged(done[0] if done else None),
                last_logged_episodes=logged(done[-1] if done else None),
                first_iteration_kl=rows[0]["kl"], final_learning_rate=rows[-1]["learning_rate"],
                nonfinite_skips=sum(r["nonfinite_skips"] for r in rows),
                wall_s=rows[-1]["time"] - rows[0]["time"] + rows[0]["collection_s"]
                + rows[0]["update_s"],
                s_per_iteration=col + upd, collection_s=col, update_s=upd)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", required=True)
    ap.add_argument("--seed", type=int, required=True, help="the training's seed")
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    env_cfg, train_cfg = task_registry.get_cfgs(TASK)
    fleet = env_cfg.env.num_envs
    env_cfg.env.num_envs = args.envs
    env, _ = task_registry.make_env(TASK, env_cfg=env_cfg, device=dev)
    train_cfg.seed = args.seed
    initial = OnPolicyRunner(env, train_cfg)                 # the run's iteration-0 policy
    final = OnPolicyRunner(env, train_cfg)
    final.load(f"{args.run}/model_final.pkl")
    out = {"task": TASK, "card": card_name(dev), "training_envs": fleet, "seed": args.seed,
           "run": args.run, "eval": {"envs": args.envs, "steps": args.steps, "seed": 0},
           "iteration_0": track(env, initial.get_inference_policy(), args.steps, 0),
           "final": track(env, final.get_inference_policy(), args.steps, 0),
           "training": training_side(args.run),
           "reference": "none: the JAX package has no Franka training artifact or checkpoint"}
    if dev.type == "cuda":
        from extended_legged_gym_tpu_torch.scripts.bench_train import train_profile

        prof = train_profile(task=TASK, seed=args.seed, num_envs=fleet, device=dev)
        out["profile"] = {k: prof[k] for k in ("s_per_iteration", "collection_s", "update_s",
                                               "device_busy_ms", "profiled_wall_ms",
                                               "device_idle_share", "kernel_ms",
                                               "kernel_launches", "top_device_kernels")}
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
