"""The terrain estimator in the closed loop (port of
``scripts/estimator_closed_loop.py``): the ray task's policy walks once on
the true rays (eval A) and once with the observation's ray tail replaced by
the estimator's predictions from depth and proprioception, ``1 -
clip(pred / max_distance, 0, 1)`` (eval B).

Protocol (``anymal_c_rough_raycast``): the depth camera 48 x 24 resized to
32 x 16; levels frozen at spawn levels <= ``--max-init-level``; no noise,
randomization or pushes; the command pinned to ``--cmd`` m/s forward and
never resampled; both evals reset with ``--seed``; ``--warmup`` control
steps, then ``--steps`` recorded.  It reports the prediction RMSE and MAE in
meters, the near-3 m RMSE (defined as the JAX script defines it: the square
root of the mean over steps of each step's MSE over the rays whose true hit
is within 3 m), and tracking (mean forward speed over command) and falls
(resets) on true and on estimated rays, with ``ESTIMATOR_CL_r5.json``'s
numbers and the card beside them.

``--train N`` first trains the port's estimator N iterations with the policy
driving, on the same env, and writes it (default
``logs/terrain_estimator/anymal_c_rough_raycast_torch/estimator_final.pkl``,
beside its ``metrics.jsonl``); the loss curve goes into the output.  Without
it the script loads ``--estimator`` (default: the JAX package's committed
estimator).

Usage, from the repository root (on a CUDA card):

  python -m extended_legged_gym_tpu_torch.scripts.estimator_closed_loop \\
      [--policy logs/rough_raycast_anymal_c/Aug21_13-41-24_r5_rayc/model_final.pkl] \\
      [--estimator CKPT] [--train 300] [--envs 128] [--steps 400] [--warmup 100] \\
      [--cmd 0.5] [--max-init-level 2] [--seed 7] [--out ESTIMATOR_CL_torch_rNN.json]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .eval_policy import card_name
from .eval_raycast import RAY_CKPT

JAX_ESTIMATOR = "logs/terrain_estimator/anymal_c_rough_raycast/estimator_final.pkl"
PORT_ESTIMATOR = "logs/terrain_estimator/anymal_c_rough_raycast_torch/estimator_final.pkl"
NEAR_M = 3.0
REF_KEYS = ("policy", "estimator", "command_mps", "n_envs", "n_steps", "max_init_terrain_level",
            "prediction_rmse_m", "prediction_mae_m", "prediction_rmse_m_near3m",
            "tracking_true_rays", "tracking_estimated_rays", "tracking_delta", "falls_true_rays",
            "falls_estimated_rays")


def build_env(num_envs: int, max_init_level=None, device="cuda"):
    """The ray task under the evaluation protocol with the estimator's camera
    (48 x 24 -> 32 x 16)."""
    from ..envs.legged_robot import LeggedRobot
    from .eval_rough import eval_cfg

    cfg = eval_cfg(num_envs, max_init_level, task="anymal_c_rough_raycast")
    cfg.depth.camera_type = "Warp"
    cfg.depth.original = [48, 24]
    cfg.depth.resized = [32, 16]
    return LeggedRobot(cfg, device=device)


def near_mse(err: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """One step's MSE over the rays whose true hit lies within 3 m (0 where
    none does).  The reported near-3 m RMSE is the square root of this
    step-wise ratio's mean over steps, as the JAX script computes it: a step
    with few near rays weighs as much as one with many."""
    near = (gt < NEAR_M).to(torch.float32)
    return (torch.square(err) * near).sum() / torch.clamp(near.sum(), min=1.0)


@torch.no_grad()
def rollout(env, te, policy, swap: bool, warmup: int, steps: int, cmd_mps: float, seed: int):
    """``warmup + steps`` control steps from ``env.reset_all(seed)``, the
    estimator predicting every step; with ``swap`` the policy reads the
    predicted rays.  Returns, over the recorded steps, the mean forward speed
    ``vx``, the ``resets``, the prediction's ``rmse``, ``mae`` and ``near_rmse``
    (m) and ``upright`` (the mean of projected gravity's z)."""
    estimate = te.get_estimator()
    R, max_d = te.raycaster.num_rays, env.cfg.raycaster.max_distance
    s = env.reset_all(seed=seed)
    cmd = torch.zeros_like(s.commands)
    cmd[:, 0] = cmd_mps
    s = s.replace(commands=cmd)
    carry = te.carry0
    rec = {k: [] for k in ("vx", "resets", "mse", "mae", "near_mse", "upright")}
    for i in range(warmup + steps):
        pos, quat = s.phys.base_pos, s.phys.base_quat
        frame = te.camera.render(pos, quat)
        gt = te.raycaster.cast(pos, quat).distance
        pred, carry = estimate(frame, te._proprio(s), carry)
        obs = s.obs
        if swap:
            obs = torch.cat([obs[:, :-R], 1.0 - torch.clamp(pred / max_d, 0.0, 1.0)], dim=-1)
        s = env.step(s, policy(obs)).replace(commands=cmd)
        carry = torch.where(s.reset_buf[:, None], torch.zeros_like(carry), carry)
        if i < warmup:
            continue
        err = pred - gt
        rec["vx"].append(s.base_lin_vel[:, 0].mean())
        rec["resets"].append(s.reset_buf.sum())
        rec["upright"].append(s.projected_gravity[:, 2].mean())
        rec["mse"].append(torch.square(err).mean())
        rec["mae"].append(torch.abs(err).mean())
        rec["near_mse"].append(near_mse(err, gt))
    r = {k: torch.stack(v).to(torch.float64) for k, v in rec.items()}
    return {"vx": r["vx"].mean().item(), "resets": r["resets"].sum().item(),
            "rmse": r["mse"].mean().sqrt().item(), "mae": r["mae"].mean().item(),
            "near_rmse": r["near_mse"].mean().sqrt().item(), "upright": r["upright"].mean().item()}


def loss_curve(metrics_path: str, every: int):
    """``[[iteration, {"loss"}], ...]`` every ``every`` iterations of a
    training's ``metrics.jsonl``, the last one included."""
    with open(metrics_path) as f:
        rows = [json.loads(line) for line in f]
    keep = [r for r in rows if (r["step"] + 1) % every == 0 or r is rows[-1]]
    return [[r["step"] + 1, {"loss": round(r["loss"], 6)}] for r in keep], rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default=RAY_CKPT)
    ap.add_argument("--estimator", default=None,
                    help=f"checkpoint to load, or to write with --train (default {JAX_ESTIMATOR}, "
                         f"with --train {PORT_ESTIMATOR})")
    ap.add_argument("--train", type=int, default=0,
                    help="train the port's estimator this many iterations first")
    ap.add_argument("--envs", type=int, default=128)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--cmd", type=float, default=0.5)
    ap.add_argument("--max-init-level", type=int, default=2)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reference", default="ESTIMATOR_CL_r5.json")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from ..rl.terrain_estimator_runner import TerrainEstimatorRunner
    from ..utils.device import resolve_device
    from .eval_rough import load_policy

    t_start = time.perf_counter()
    dev = resolve_device(args.device)
    env = build_env(args.envs, args.max_init_level, dev)
    policy = load_policy(args.policy, env.num_obs, env.num_actions, dev)
    est_path = args.estimator or (PORT_ESTIMATOR if args.train else JAX_ESTIMATOR)
    log_dir = os.path.dirname(est_path) if args.train else None
    if log_dir and os.path.exists(os.path.join(log_dir, "metrics.jsonl")):
        os.remove(os.path.join(log_dir, "metrics.jsonl"))   # the writer appends
    te = TerrainEstimatorRunner(env, log_dir=log_dir, seed=0, policy=policy)
    out = {"artifact": "terrain estimator closed loop (anymal_c_rough_raycast: the policy walks "
                       "on estimator-predicted rays), PyTorch port",
           "policy": args.policy}
    if args.train:
        t0 = time.perf_counter()
        te.learn(args.train)
        train_s = time.perf_counter() - t0
        te.save(est_path)
        print("saved estimator ->", est_path)
        curve, rows = loss_curve(os.path.join(log_dir, "metrics.jsonl"), max(1, args.train // 20))
        steady = rows[1:] or rows
        out["training"] = {
            "iterations": args.train, "num_envs": args.envs, "num_steps_per_env":
            te.num_steps_per_env, "seed": 0, "driving": "the policy (--policy)",
            "loss_first": rows[0]["loss"], "loss_final": rows[-1]["loss"], "curve": curve,
            "wall_time_s": train_s,
            "s_per_iteration": sum(r["iter_time"] for r in steady) / len(steady),
            "collection_s_per_iteration": sum(r["collection_s"] for r in steady) / len(steady),
            "update_s_per_iteration": sum(r["update_s"] for r in steady) / len(steady)}
        out["note"] = ("ESTIMATOR_CL_r5 does not record how many iterations its estimator was "
                       "trained; this one trained --train iterations with the policy driving")
    else:
        te.load(est_path)
        print("loaded estimator <-", est_path)

    kw = dict(warmup=args.warmup, steps=args.steps, cmd_mps=args.cmd, seed=args.seed)
    a = rollout(env, te, policy, False, **kw)
    b = rollout(env, te, policy, True, **kw)
    out.update({
        "estimator": est_path,
        "command_mps": args.cmd, "n_envs": args.envs, "n_steps": args.steps,
        "warmup": args.warmup, "max_init_terrain_level": args.max_init_level, "seed": args.seed,
        "camera": "48 x 24 -> 32 x 16",
        "prediction_rmse_m": round(a["rmse"], 4),
        "prediction_mae_m": round(a["mae"], 4),
        "prediction_rmse_m_near3m": round(a["near_rmse"], 4),
        "prediction_on_estimated_rays": {"rmse_m": round(b["rmse"], 4),
                                         "mae_m": round(b["mae"], 4),
                                         "rmse_m_near3m": round(b["near_rmse"], 4)},
        "tracking_true_rays": round(a["vx"] / args.cmd, 4),
        "tracking_estimated_rays": round(b["vx"] / args.cmd, 4),
        "tracking_delta": round((b["vx"] - a["vx"]) / args.cmd, 4),
        "falls_true_rays": a["resets"],
        "falls_estimated_rays": b["resets"],
        "upright_true_rays": round(a["upright"], 4),
        "upright_estimated_rays": round(b["upright"], 4),
        "seconds": time.perf_counter() - t_start,
        "card": card_name(dev),
    })
    if args.reference and os.path.exists(args.reference):
        with open(args.reference) as f:
            ref = json.load(f)
        out["reference"] = {"source": os.path.basename(args.reference),
                            **{k: ref[k] for k in REF_KEYS}}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
