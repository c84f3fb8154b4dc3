"""Play a trained policy and log its state traces (port of ``scripts/play.py``,
after the reference's ``play.py``).

The task's config gets the evaluation overrides (at most 50 envs, no
observation noise, friction randomization, pushes or terrain curriculum);
the runner loads its checkpoint through the registry (``--resume``: the
latest run of the task's experiment, or ``--load_run`` / ``--checkpoint``),
and the deterministic policy drives ``10 s / env.dt`` control steps from
``reset_all(seed)``.  Env 0's trace goes to ``play_log.jsonl`` (one row per
step: time, base height, base velocity x, command x, reward),
``play_states.json`` (``utils/plot_logger.Logger``) and, where matplotlib
is installed, ``play_states.png``, in the runner's log directory (or
``out_dir``).  ``EXPORT_POLICY=1`` also writes the deployment files
(``runner.export_policy``) into its ``exported/`` directory.

Usage, from the repository root (on a CUDA card; ``--device cpu`` runs the
plain physics on the CPU):

  python -m extended_legged_gym_tpu_torch.scripts.play --task anymal_c_flat \\
      --load_run Aug21_12-38-39_r5_ft4 [--experiment_name flat_anymal_c] [--seed 0]
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional


def play(args, steps: Optional[int] = None, out_dir: Optional[str] = None,
         log_root: str = "logs", initial_state=None) -> dict:
    """Play ``steps`` control steps (default ``int(10 / env.dt)``) and write
    the traces into ``out_dir`` (default: the runner's log directory).
    ``initial_state`` replaces ``env.reset_all(seed)`` as the start.  Returns
    ``rows`` (the logged rows), ``files`` (the paths written), ``ms_per_step``
    (wall time per control step, policy and logging included), ``finite``
    (every observation and action finite), ``mean_abs_vx_err`` (mean |vx -
    command x| from step 100 on, or over all steps if fewer), ``first``
    (the first step's (phys, env_params, actions)), ``env`` and ``runner``."""
    import numpy as np
    import torch

    from .. import robots  # noqa: F401  (populates the registry)
    from ..utils.plot_logger import Logger
    from ..utils.task_registry import task_registry

    env_cfg, train_cfg = task_registry.get_cfgs(args.task)
    env_cfg.env.num_envs = min(env_cfg.env.num_envs, 50)
    env_cfg.noise.add_noise = False
    env_cfg.domain_rand.randomize_friction = False
    env_cfg.domain_rand.push_robots = False
    env_cfg.terrain.curriculum = False
    env, env_cfg = task_registry.make_env(args.task, args, env_cfg)
    args.resume = True
    runner, _ = task_registry.make_alg_runner(env, args.task, args, train_cfg, log_root=log_root)
    policy = runner.get_inference_policy()
    out_dir = out_dir or runner.log_dir
    files = []
    if os.environ.get("EXPORT_POLICY"):
        files += runner.export_policy(os.path.join(out_dir, "exported"))
        for f in files:
            print("exported policy ->", f)

    state = env.reset_all(seed=args.seed or 0) if initial_state is None else initial_state
    steps = int(10.0 / env.dt) if steps is None else steps
    plotter = Logger(env.dt)
    traces, finite = [], torch.ones((), dtype=torch.bool, device=env.device)
    first = None
    if env.device.type == "cuda":
        torch.cuda.synchronize(env.device)
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(steps):
            actions = policy(state.obs)
            if first is None:
                first = (state.phys, state.env_params, actions)
            finite &= torch.isfinite(state.obs).all() & torch.isfinite(actions).all()
            state = env.step(state, actions)
            plotter.log_env_step(env, state)
            traces.append(torch.stack([state.phys.base_pos[0, 2], state.base_lin_vel[0, 0],
                                       state.commands[0, 0], state.rew[0]]))
        finite &= torch.isfinite(state.obs).all()
        traces = torch.stack(traces).cpu().numpy() if traces else np.zeros((0, 4), np.float32)
    ms = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
    rows = [dict(t=i * env.dt, base_height=float(h), base_vel_x=float(vx), command_x=float(cx),
                 rew=float(r)) for i, (h, vx, cx, r) in enumerate(traces)]

    os.makedirs(out_dir, exist_ok=True)
    log_path = os.path.join(out_dir, "play_log.jsonl")
    with open(log_path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    png = plotter.plot_states(os.path.join(out_dir, "play_states.png"))
    files += [log_path, plotter.save_json(os.path.join(out_dir, "play_states.json"))]
    files += [png] if png else []
    tail = rows[100:] if len(rows) > 100 else rows
    err = float(np.mean([abs(r["base_vel_x"] - r["command_x"]) for r in tail])) if tail else 0.0
    print(f"played {len(rows)} steps ({ms:.3f} ms per control step); trace -> {log_path}"
          + (f"; plots -> {png}" if png else ""))
    print("mean |vx - cmd|:", err)
    return dict(rows=rows, files=files, ms_per_step=ms, finite=bool(finite),
                mean_abs_vx_err=err, first=first, env=env, runner=runner)


if __name__ == "__main__":
    from ..utils.task_registry import get_args

    play(get_args())
