"""Set two training runs' learning curves side by side: the port's and the
JAX package's, each read from the ``metrics.jsonl`` of its run directories.

A run may be several segments (a training resumed with ``--resume``); their
rows are joined by iteration, a later segment replacing an earlier one's rows
from its first iteration on.  At each milestone iteration the script prints
the mean, over the rows within ``--window`` iterations of it that closed
episodes, of the mean episode length, the mean terrain level, the tracking
reward per episode (``episode/rew_tracking_lin_vel``) and the mean episode
reward; and, for each run, every iteration at which the reward stage rose.

Usage, from the repository root:

  python -m extended_legged_gym_tpu_torch.scripts.compare_curves \\
      --port logs/rough_anymal_c_torch/<run> \\
      --jax logs/rough_anymal_c/Aug21_09-57-41_r5_rough2 \\
      --jax logs/rough_anymal_c/Aug21_13-00-24_r5_rough3 [--out FILE]

Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os

KEYS = ("mean_episode_length", "terrain_level", "episode/rew_tracking_lin_vel", "mean_reward")
MILESTONES = (1, 10, 25, 50, 100, 200, 300, 500, 750, 950, 1000, 1250, 1500, 2000, 2450)


def joined_rows(runs):
    """The segments' rows by iteration, later segments taking precedence."""
    by_step = {}
    for run in runs:
        with open(os.path.join(run, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        first = rows[0]["step"]
        by_step = {k: v for k, v in by_step.items() if k < first}
        by_step.update({r["step"]: r for r in rows})
    return [by_step[k] for k in sorted(by_step)]


def stage_rises(rows):
    """Iterations at which ``reward_stage`` rose (it falls back to 0 where a
    JAX segment resumed)."""
    out, last = [], 0.0
    for r in rows:
        st = r.get("reward_stage", 0.0)
        if st > last:
            out.append(r["step"])
        last = st
    return out


def curve(rows, milestones, window):
    out = {}
    last = rows[-1]["step"]
    for m in milestones:
        if m > last:
            continue
        near = [r for r in rows if abs(r["step"] - m) <= window and r["episodes_done"] > 0]
        out[str(m)] = {k: (sum(r[k] for r in near) / len(near) if near else None)
                       for k in KEYS if k in rows[0]}
    return out


def compare(port_runs, jax_runs, milestones=MILESTONES, window=10):
    result = {}
    for name, runs in (("port", port_runs), ("jax", jax_runs)):
        rows = joined_rows(runs)
        result[name] = {"runs": list(runs), "iterations": rows[-1]["step"],
                        "reward_stage_rises_at": stage_rises(rows),
                        "curve": curve(rows, milestones, window)}
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="append", required=True)
    ap.add_argument("--jax", action="append", required=True)
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = compare(args.port, args.jax, window=args.window)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
