"""Per-fall traces of the reference checkpoint's replay (port of
``scripts/diag_parity.py``): the tool to run first when a replay misbehaves.

Replays the reference checkpoint as ``scripts/eval_parity.py`` does and
records a dense per-step trace, then prints, for each reset, the 10 control
steps before it (base height, uprightness, base / knee / shank contact
forces, per-foot contact and slip, joint-velocity maxima, lowest foot) and
the aggregates away from resets: stance slip, touchdown and stance normal
forces, base height, tracking, duty factor per foot and contact incidence.
Contact gains can be overridden (``--kp --kd --kt --kt-spring``).  An absent
checkpoint fails naming its path.

Usage, from the repository root (on a CUDA card; ``--device cpu`` runs the
plain physics on the CPU):

  python -m extended_legged_gym_tpu_torch.scripts.diag_parity [--ckpt PT] [--envs 8] ...
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..rl.torch_compat import REF_CKPT, load_reference_policy, require_checkpoint
from .eval_parity import parity_env, pinned_commands


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=REF_CKPT)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--cmd", type=float, default=0.5)
    ap.add_argument("--envs", type=int, default=8)
    ap.add_argument("--no-actuator-net", action="store_true")
    ap.add_argument("--kp", type=float, default=None)
    ap.add_argument("--kd", type=float, default=None)
    ap.add_argument("--kt", type=float, default=None)
    ap.add_argument("--kt-spring", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_checkpoint(args.ckpt)

    env = parity_env(args.envs, args.device, not args.no_actuator_net, args.kp, args.kd, args.kt,
                     args.kt_spring)
    sim = env.cfg.sim
    print("contact params:", sim.contact_kp, sim.contact_kd, sim.contact_kt, sim.contact_kt_spring)
    _, _, policy = load_reference_policy(args.ckpt, 48, 12, our_joint_names=env.model.joint_names,
                                         device=env.device)
    links = env.model.geom_links
    geoms = lambda pred: torch.as_tensor([g for g, l in enumerate(links) if pred(l)],
                                         dtype=torch.int64, device=env.device)
    base_geoms = geoms(lambda l: l == "base")
    knee_geoms = geoms(lambda l: l.endswith("KFE"))
    shank_geoms = geoms(lambda l: l.endswith("SHANK"))
    max_force = lambda g, s: (torch.linalg.norm(s.geom_forces[:, g], dim=-1).amax(dim=-1)
                              if len(g) else torch.zeros(env.num_envs, device=env.device))

    s = env.reset_all(seed=0)
    cmd = pinned_commands(s, args.cmd)
    s = s.replace(commands=cmd)
    recs = []
    with torch.no_grad():
        for i in range(args.warmup + args.steps):
            s = env.step(s, policy(s.obs)).replace(commands=cmd)
            if i < args.warmup:
                continue
            fz = s.geom_forces[:, env.feet_geoms, 2]
            recs.append(dict(
                vx=s.base_lin_vel[:, 0], h=s.phys.base_pos[:, 2], up=s.projected_gravity[:, 2],
                base_f=max_force(base_geoms, s), knee_f=max_force(knee_geoms, s),
                shank_f=max_force(shank_geoms, s), contact=fz > 1.0, fz=fz,
                slip=torch.linalg.norm(s.foot_velocities[..., :2], dim=-1),
                foot_h=s.foot_positions[..., 2], jv_max=s.phys.joint_vel.abs().amax(dim=-1),
                reset=s.reset_buf,
                pitchroll=torch.linalg.norm(s.projected_gravity[:, :2], dim=-1)))
    o = {k: torch.stack([r[k] for r in recs]).cpu().numpy() for k in recs[0]}

    T, E = o["h"].shape
    resets = o["reset"]  # [T, E] bool
    n_resets = int(resets.sum())
    print(f"=== {n_resets} resets over {T} steps x {E} envs ===")

    # --- per-event context ---
    events = np.argwhere(resets)
    for t, e in events[:30]:
        lo = max(0, t - 10)
        print(f"\n--- reset env {e} at step {t} ---")
        for tt in range(lo, min(T, t + 2)):
            c = "".join("#" if x else "." for x in o["contact"][tt, e])
            print(f"  t={tt} h={o['h'][tt,e]:.3f} up={o['up'][tt,e]:+.3f} "
                  f"pr={o['pitchroll'][tt,e]:.3f} vx={o['vx'][tt,e]:+.2f} "
                  f"baseF={o['base_f'][tt,e]:7.1f} kneeF={o['knee_f'][tt,e]:7.1f} "
                  f"shankF={o['shank_f'][tt,e]:6.1f} "
                  f"c={c} slip={o['slip'][tt,e].max():.2f} "
                  f"fz_max={o['fz'][tt,e].max():6.1f} jv={o['jv_max'][tt,e]:5.1f} "
                  f"footh_min={o['foot_h'][tt,e].min():+.3f}")

    # --- aggregate stance-slip stats (excluding steps near resets) ---
    near_reset = np.zeros((T, E), bool)
    for t, e in events:
        near_reset[max(0, t - 20):min(T, t + 20), e] = True
    ok = ~near_reset
    stance = o["contact"] & ok[..., None]
    slip_in_stance = o["slip"][stance]
    print("\n=== stance slip (away from resets) ===")
    if len(slip_in_stance):
        print(f"  mean={slip_in_stance.mean():.4f} median={np.median(slip_in_stance):.4f} "
              f"p90={np.percentile(slip_in_stance, 90):.4f} p99={np.percentile(slip_in_stance, 99):.4f} m/s")
    # touchdown detection: contact rising edge
    rising = o["contact"][1:] & ~o["contact"][:-1] & ok[1:, :, None]
    fz_td = o["fz"][1:][rising]
    fz_stance = o["fz"][o["contact"] & ok[..., None]]
    print("=== normal forces ===")
    if len(fz_td):
        print(f"  touchdown-step fz: mean={fz_td.mean():.1f} p99={np.percentile(fz_td, 99):.1f} N")
    if len(fz_stance):
        print(f"  stance fz: mean={fz_stance.mean():.1f} p99={np.percentile(fz_stance, 99):.1f} N "
              f"(static per-foot ~{26.37 + 4 * 6.44:.0f}kg total)")
    print("=== base height ===")
    print(f"  mean={o['h'][ok].mean():.4f} std={o['h'][ok].std():.4f}")
    print("=== tracking ===")
    print(f"  vx mean={o['vx'][ok].mean():.4f} / cmd {args.cmd}")
    print("=== duty factor per foot ===", o["contact"][ok].mean(axis=0))
    # knee/shank grazing incidence away from resets
    print("=== contact incidence (away from resets) ===")
    print(f"  base force>1N: {(o['base_f'][ok] > 1.0).mean()*100:.2f}% of steps")
    print(f"  knee force>1N: {(o['knee_f'][ok] > 1.0).mean()*100:.2f}%")
    print(f"  shank force>1N: {(o['shank_f'][ok] > 1.0).mean()*100:.2f}%")
    return o


if __name__ == "__main__":
    main()
