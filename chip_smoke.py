#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints its seconds; the run fails rather than overrun):
1. device: require CUDA, print the card's name and power limit;
2. build: compile both fused physics kernels (csrc/physics_step.cu: B1 flat,
   B2 heightfield; one warp per env, working set in shared memory) with one
   nvcc call and print ptxas's report of each (registers, stack, spills);
3. B1 against its plain version (physics/aba.py) on the card, a block's
   shared memory printed: one control step from seeded near-standing states
   with random actions at every batch the MPC path launches it with (8 x 128,
   8 x 97, 8 x 3 and 8 envs; 128, 97 and 3 at E=1), at 2048 and at 4096 (the
   training fleet), at 64 (the flat estimator evidence) and 256 (the
   distillation fleet), then 25 control steps of drift at 8 x 97, and two
   launches on the same inputs at 1024 and at 4096, which must agree bit for
   bit;
4. B2 against its plain version on the anymal_c_rough curriculum grid
   (900 x 900 heightfield): near-standing states on the spawn origins, one
   control step at 32 envs (the rough evaluation), 128 (the estimator and
   its closed loop) and 4096 (the rough config's fleet), 25 control steps of
   drift at 32, two launches bit for bit at 4096; B2 and plain timed at
   each batch;
5. MPC path: ANYmal-C flat sampling MPC (RobotTrajGradSampling.mpc_step at
   the committed config, 8 envs, 0.7 m/s command, warm-started from the
   committed checkpoint); B1's launch count is read from this run;
6. rough path: the anymal_c_rough env at 4096 envs, levels frozen, stepped
   20 control steps by the committed rough policy; B2's launch count is read
   from this run and must be 20; then control steps per second, policy
   included, and a short rough evaluation (scripts/eval_rough.run_eval, 32
   envs, 50 + 100 steps, levels <= 2);
7. V-control routes (make_env_step, make_env_step_rough: one substep per
   launch, torques passed in): one substep against plain at 1024 envs on
   flat ground and 4096 on the rough grid, then the V-control envs (the
   flat MPC task's env, the rough evaluation env) stepped V_STEPS control
   steps each; each route's launches are read from its run and must be
   V_STEPS x decimation;
8. training path: flat PPO at the TRAIN_r5 recipe (anymal_c_flat, 4096
   envs, [128, 64, 32] actor and critic, 24 steps per env, seed 2, from
   scratch) through the task registry, OnPolicyRunner.learn for
   TRAIN_ITERS iterations; B1's launches are read from this run and must be
   TRAIN_ITERS x 24 (B2's 0); the loss and every parameter must be finite,
   no update skipped and the parameters changed; the seconds per iteration
   split into collection and update, and env-steps per second; then a
   save, a load into a fresh runner and equal actions from both policies;
9. rough training path: rough PPO at the TRAIN_ROUGH_r5 recipe
   (anymal_c_rough, 4096 envs, [512, 256, 128], seed 1, from scratch, the
   terrain curriculum on) the same way for ROUGH_TRAIN_ITERS iterations;
   B2's launches must be ROUGH_TRAIN_ITERS x 24 (B1's 0), and besides the
   checks of phase 8, some env's terrain level must have changed and every
   level must lie in [0, num_rows);
10. ray path: the anymal_c_rough_raycast env (levels frozen) at 4096 envs
   stepped RAY_STEPS control steps by the committed ray checkpoint; B2's
   launches must be RAY_STEPS; the observation must be 267 wide, its
   32-ray tail finite and in [0, 1], the robots upright; the ray cast's
   time per call at 4096 x 32 rays and the env's control steps per second;
   then a short ray evaluation (128 envs, 50 + 100 steps, levels <= 2,
   0.5 m/s);
11. depth camera: one heightfield render at 4096 envs at the terrain
   estimator's setup (48 x 24 rays resized to 32 x 16), finite and in
   [0, 1] (to float32 rounding of the resize's weights), and its time;
12. estimator path: TerrainEstimatorRunner.learn on the ray task under the
   closed loop's protocol (scripts/estimator_closed_loop.build_env: 128
   envs, levels <= 2) with the committed ray policy driving, EST_ITERS
   iterations; B2's launches must be EST_ITERS x 24 (B1's 0), the loss
   finite and the parameters changed; a save and a load into a fresh runner
   must give equal predictions; the render's time at 128 envs and the
   iteration's; then the committed JAX estimator in an EST_CL_STEPS-step
   closed-loop segment with the ray tail swapped (B2 exactly EST_CL_STEPS):
   finite predictions, robots upright;
13. distillation path: DistillationRunner at the DISTILL_NATIVE_r5 recipe
   (scripts/evidence_artifacts.distill_runner: anymal_c_flat, 256 envs, the
   committed flat teacher) for DISTILL_ITERS iterations; B1's launches must
   be DISTILL_ITERS x 24 (B2's 0), the loss finite, the student's parameters
   changed and the teacher's outputs and parameters unchanged; the
   iteration's time;
14. ElSpider path: B1 with the ElSpider Air hexapod's tables (19 bodies, 18
   joints, 46 spheres, 6 feet) against its plain version run in float64 at
   ELSPIDER_B envs (16 and the fleet's 4096), its 25-step drift at 16
   reported three ways (drift_report), two launches bit for bit at 4096;
   ELSPIDER_ITERS iterations of elspider_air_flat training at the fleet (B1
   exactly ELSPIDER_ITERS x 24, the other routes 0) with the save/load round
   trip; the committed JAX checkpoint evaluated (16 envs, 50 + 100 steps,
   0.5 m/s: B1 exactly 150, upright);
15. SEA path: the anymal_c_flat_sea env's torques-in B1 step (EnvStep)
   against plain at the fleet with the actuator network's torques;
   SEA_ITERS training iterations (EnvStep exactly SEA_ITERS x 24 x 4, the
   fused step 0); the committed JAX SEA checkpoint evaluated (16 envs, 50 +
   100 steps, 0.7 m/s, upright);
16. RL extensions on anymal_c_flat at the fleet: a recurrent policy with a
   symmetry_cfg must be refused; EXT_ITERS iterations of the recurrent
   policy (LSTM of 512) with RND, then of the MLP policy with RND and the
   left-right symmetry loss (B1 exactly EXT_ITERS x 24 each, finite losses
   and RND losses, policy and predictor changed); the recurrent inference
   policy must change its action with its carry, give the first action
   again after a reset, and round-trip through a checkpoint;
17. the fixed-base regime (the kernels' TI_FIX flag: zero base
   acceleration, no base solve) with the Franka arm's tables (8 bodies, 7
   joints, one sphere on the base, no feet) against its plain version: one
   control step from states at rest with random actions at FRANKA_B (8, the
   batch rollout's main envs, and 1024, franka_cfg's fleet and 8 x 128
   rollout samples), the base unchanged bit for bit after one step and
   after 25, the 25-step drift at 8 reported (drift_report: the arm's
   2.2-2.6 rad/s limits clamp often), two launches bit for bit at 1024;
18. Franka paths: the franka task through the registry for FRANKA_ITERS
   PPO iterations at 1024 envs (the fixed-base route exactly FRANKA_ITERS x
   24, B1 and B2 0; phase 8's checks), then franka_batch_rollout's
   rollout_batch at 8 main envs x 128 samples x H=16 (exactly 16 launches,
   finite rewards);
19. CyberDog2 on B1: its tables (13 bodies, 12 joints, 37 spheres, 4 feet)
   against the float64 plain version at the walk family's 4096 envs, two
   launches bit for bit; CYBER_ITERS iterations of cyber2_walk training at
   4096 (B1 exactly CYBER_ITERS x 24, phase 8's checks);
20. flat evaluation: scripts/eval_policy on the committed JAX checkpoint
   (16 envs, 50 + 100 steps): finite values, upright_mean below -0.9;
21. timing: the MPC solve latency at 1 env and the rollout throughput at 16
   envs x 128 samples x H=64, timed with CUDA events;
22. the kernel line (JSON) and the result line.  B1's entry counts its
   launches on the MPC path, the flat training path, the distillation path
   and the RL-extension paths; B1's entry on the hexapod's tables its
   launches on the ElSpider path; the SEA route's its launches on the SEA
   training path; B2's entry on the rough path, the ray path, the rough
   training path and the estimator path; the fixed-base regime's on the
   Franka training and rollout paths, with its times at 1024; B1's entry
   on CyberDog2's tables on the CyberDog2 training path; the others carry
   their times at the training fleet's 4096.

Exits non-zero, printing no result line, without CUDA or without the port.
Imports nothing of JAX or of the JAX package.
"""
import json
import math
import os
import subprocess
import sys
import time

T_START = time.perf_counter()
TIME_LIMIT_S = 280.0            # the whole run, build included
ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "logs/flat_anymal_c/Aug21_12-38-39_r5_ft4/model_final.pkl")
ROUGH_CKPT = os.path.join(ROOT, "logs/rough_anymal_c/Aug21_13-00-24_r5_rough3/model_final.pkl")
FLAT_CKPT = os.path.join(ROOT, "logs/flat_anymal_c/Aug21_16-29-23_r5_scratch/model_final.pkl")
RAY_CKPT = os.path.join(ROOT, "logs/rough_raycast_anymal_c/Aug21_13-41-24_r5_rayc/model_final.pkl")
JAX_ESTIMATOR = os.path.join(ROOT,
                             "logs/terrain_estimator/anymal_c_rough_raycast/estimator_final.pkl")
CMD = 0.7

# kernel against plain, one control step (tests/test_physics_kernel.py:66-84):
# positions integrate from matching velocities, so they are tight; velocities
# carry float32 accumulation-order noise through the contact solve
ONE_STEP_ATOL = dict(base_pos=1e-4, base_quat=1e-4, joint_pos=5e-4, base_lin_vel=2e-2,
                     base_ang_vel=2e-2, joint_vel=5e-2, contact_anchor=1e-4, foot_pos=1e-4)
# the main path's batches at E=8: sampling rollouts (8 x 128), fd polish
# (8 x 97), line search (8 x 3), the main env step (8); the solve cell's at
# E=1 (128, 97, 3); the rollout cell's 2048 and the training fleet's 4096
# (three waves of 3 blocks of 4 envs per SM); the flat estimator evidence's
# 64 and the distillation fleet's 256
CHECK_B = (1024, 776, 24, 8, 128, 97, 3, 2048, 4096, 64, 256)
# B2: the rough evaluation's fleet, the estimator's and the rough config's
# training fleet
ROUGH_B = (32, 128, 4096)
ROUGH_STEPS = 20
# after 25 control steps (100 substeps) the stiction/contact dynamics amplify
# rounding differences (FMA contraction, summation order); the bounds are ~10x
# the divergence of the same code compiled for the host
DRIFT_ATOL = dict(base_pos=2e-2, base_quat=3e-2, joint_pos=0.1, base_lin_vel=0.1,
                  base_ang_vel=0.5, joint_vel=2.0)
# V-control routes: flat at the MPC path's batch, rough at the fleet's
V_FLAT_B, V_ROUGH_B, V_STEPS = 1024, 4096, 10
# training paths: the fleet and iterations of the TRAIN_r5 and
# TRAIN_ROUGH_r5 recipes (the ray path runs the same fleet)
FLEET = 4096
TRAIN_ITERS = 5
ROUGH_TRAIN_ITERS = 3
# ray path: control steps of the 4096-env ray task; its evaluation's command
RAY_STEPS = 20
RAY_CMD = 0.5
# the depth render may leave [0, 1] by float32 rounding of the resize's
# normalized weights (as jax.image.resize does)
DEPTH_SLACK = 1e-6
# estimator path: the closed loop's fleet, iterations of 24 steps, and the
# closed-loop segment with the JAX estimator
EST_ENVS, EST_ITERS, EST_CL_STEPS = 128, 2, 20
# distillation path: the DISTILL_NATIVE_r5 fleet and iterations of 24 steps
DISTILL_ENVS, DISTILL_ITERS = 256, 3
# ElSpider Air: B1 on its tables at the evaluation's 16 and the fleet's 4096,
# training iterations at the fleet; the SEA task's and the RL extensions'
# training iterations at the fleet
ELSPIDER_B, ELSPIDER_ITERS = (16, 4096), 3
SEA_ITERS, EXT_ITERS = 3, 2
# Franka (the fixed-base regime): B at franka_batch_rollout's 8 main envs
# and at franka_cfg's fleet of 1024 (also 8 main envs x 128 rollout
# samples); training iterations at that fleet; the rollout batch's main
# envs, samples and horizon
FRANKA_B, FRANKA_FLEET, FRANKA_ITERS = (8, 1024), 1024, 3
FRANKA_E, FRANKA_S, FRANKA_H = 8, 128, 16
# CyberDog2 on B1: the walk family's fleet, its training iterations
CYBER_B, CYBER_ITERS = 4096, 2
ELSPIDER_CKPT = os.path.join(ROOT, "logs/flat_elspider_air/Aug21_04-21-51_r4b/model_final.pkl")
SEA_CKPT = os.path.join(ROOT, "logs/flat_sea_anymal_c/Aug21_07-18-55_r4_sea2/model_final.pkl")


def log(msg):
    print(msg, flush=True)


def phase_done(name, t0):
    now = time.perf_counter()
    log(f"[{name}] {now - t0:.2f} s (total {now - T_START:.1f} s)")
    if now - T_START > TIME_LIMIT_S:
        raise SystemExit(f"chip_smoke: over the {TIME_LIMIT_S:.0f} s limit after phase {name}")


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def compare_one_step(name, step, B, states, kernel_stats, plain_dtype=None):
    """One control step of ``step``'s kernel against its plain version from
    ``states`` = (phys, env_params, actions), the plain version computed in
    ``plain_dtype`` (default float32); fails beyond ONE_STEP_ATOL.  Times
    both (the plain version in float32) and records ms, plain ms and the
    bound in ``kernel_stats[B]``.  Returns the largest difference over the
    checked fields."""
    import torch

    from extended_legged_gym_tpu_torch.scripts import bench_mpc
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import launch_bound

    st, ep, act = states
    sk, tk, rk = step.launch(st, act, ep)
    sp_, tp, rp = step.plain(st, act, ep, dtype=plain_dtype)
    if plain_dtype is not None:
        sp32 = step.plain(st, act, ep)[0]
        log(f"{name} B={B}: kernel - float32 plain: " + " ".join(
            f"{k}={(getattr(sk, k) - getattr(sp32, k)).abs().max().item():.3g}"
            for k in ("joint_pos", "joint_vel")) + "; float32 plain - float64 plain: " + " ".join(
            f"{k}={(getattr(sp32, k) - getattr(sp_, k)).abs().max().item():.3g}"
            for k in ("joint_pos", "joint_vel")) + f"; below: kernel - {plain_dtype} plain")
    torch.cuda.synchronize()
    errs = {k: (getattr(sk, k) - getattr(sp_, k)).abs().max().item()
            for k in ONE_STEP_ATOL if k != "foot_pos"}
    errs["foot_pos"] = maxabs(rk.foot_pos - rp.foot_pos)
    errs["tau_last"] = (tk - tp).abs().max().item()
    fz_k, fz_p = rk.geom_forces[..., 2].sum(1), rp.geom_forces[..., 2].sum(1)
    fz_ok = bool(((fz_k - fz_p).abs() <= 30.0 + 0.2 * fz_p.abs()).all())
    log(f"{name} one step B={B}: " + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
        + f" fz_sum_max_diff={(fz_k - fz_p).abs().max().item():.3g} (rtol 0.2, atol 30)")
    for k, tol in ONE_STEP_ATOL.items():
        if not errs[k] <= tol:
            fail(f"{name} vs plain at B={B}: {k} differs by {errs[k]:.3g} > {tol}")
    if not fz_ok:
        fail(f"{name} vs plain at B={B}: vertical geom force sums disagree")
    for out in (sk, sp_):
        if not all(torch.isfinite(getattr(out, k)).all() for k in ONE_STEP_ATOL if k != "foot_pos"):
            fail(f"non-finite state after one {name} step at B={B}")
    bufs = step.pack(st, act, ep)
    kms = bench_mpc.cuda_ms(lambda: step.run(bufs), reps=20, warmup=3)
    wms = bench_mpc.cuda_ms(lambda: step.launch(st, act, ep), reps=20, warmup=3)
    pms = bench_mpc.cuda_ms(lambda: step.plain(st, act, ep), reps=3, warmup=1)
    bound_ms, bound_by, flops, nbytes = launch_bound(step, B)
    kernel_stats[B] = dict(ms=kms, plain_ms=pms, bound_ms=bound_ms, bound_by=bound_by)
    log(f"{name} at B={B}: kernel {kms:.4f} ms/launch ({wms:.4f} ms with the wrapper's "
        f"packing), plain {pms:.3f} ms, bound {bound_ms * 1e3:.3f} us ({flops:.3g} flop, "
        f"{nbytes:.3g} bytes)")
    return max(errs[k] for k in ONE_STEP_ATOL)


def maxabs(x) -> float:
    """The largest magnitude in ``x`` (0 for an empty tensor: a model
    without feet reports none)."""
    return x.abs().max().item() if x.numel() else 0.0


def bit_identical(name, step, B, states):
    """Two launches on the same inputs must give the same bits (every sum in
    the kernel has a fixed order)."""
    import torch

    st, ep, act = states
    a, b = step.launch(st, act, ep), step.launch(st, act, ep)
    torch.cuda.synchronize()
    fields = [(k, getattr(a[0], k), getattr(b[0], k)) for k in ONE_STEP_ATOL if k != "foot_pos"]
    fields += [("tau", a[1], b[1])] + [(k, getattr(a[2], k), getattr(b[2], k))
                                       for k in ("geom_forces", "foot_pos", "foot_vel")]
    bad = [k for k, x, y in fields if not torch.equal(x, y)]
    log(f"{name} two launches at B={B}: " + ("bit-identical" if not bad else f"differ in {bad}"))
    if bad:
        fail(f"{name}: two launches on the same inputs differ in {bad}")


def drift_report(name, step, B, states):
    """drift_check's 25 control steps, with the plain version run both in
    float32 and in float64: prints the kernel's drift from each and the
    float32 plain's own drift from float64, and fails only on non-finite
    states.  For a model whose trajectories from these states are chaotic
    (the float32 plain leaves float64 by more than DRIFT_ATOL), a drift
    bound cannot tell a kernel fault from rounding."""
    import torch

    st, ep, act = states
    act = 0.2 * act
    sk, s32, s64 = st, st, st
    for _ in range(25):
        sk = step.launch(sk, act, ep)[0]
        s32 = step.plain(s32, act, ep)[0]
        s64 = step.plain(s64, act, ep, dtype=torch.float64)[0]
    torch.cuda.synchronize()
    for label, a, b in (("kernel - float32 plain", sk, s32), ("kernel - float64 plain", sk, s64),
                        ("float32 plain - float64 plain", s32, s64)):
        log(f"{name} drift after 25 control steps B={B}, {label}: " + " ".join(
            f"{k}={(getattr(a, k) - getattr(b, k)).abs().max().item():.3g}" for k in DRIFT_ATOL))
    log(f"{name}: joint velocities at the {step.model.dof_vel_limits.min():g} rad/s limit after "
        f"25 steps: {int((s64.joint_vel.abs() > 0.99 * float(step.model.dof_vel_limits.min())).sum())}"
        f" (float64 plain)")
    if not all(torch.isfinite(getattr(sk, k)).all() for k in DRIFT_ATOL):
        fail(f"{name}: non-finite state after 25 control steps")


def v_control(cfg):
    """V control with gains the explicit substep keeps stable (as in
    tests/test_torch_env.py)."""
    cfg.control.control_type = "V"
    cfg.control.stiffness = {"HAA": 10.0, "HFE": 10.0, "KFE": 10.0}
    cfg.control.damping = {"HAA": 0.01, "HFE": 0.01, "KFE": 0.01}
    return cfg


def drift_check(name, step, B, states):
    """25 control steps of kernel and plain from the same states (actions
    scaled by 0.2); fails beyond DRIFT_ATOL."""
    import torch

    st, ep, act = states
    act = 0.2 * act
    sk, sp_ = st, st
    for _ in range(25):
        sk = step.launch(sk, act, ep)[0]
        sp_ = step.plain(sp_, act, ep)[0]
    torch.cuda.synchronize()
    drift = {k: (getattr(sk, k) - getattr(sp_, k)).abs().max().item() for k in DRIFT_ATOL}
    log(f"{name} drift after 25 control steps B={B}: "
        + " ".join(f"{k}={v:.3g}" for k, v in drift.items()))
    for k, tol in DRIFT_ATOL.items():
        if not drift[k] <= tol:
            fail(f"{name} 25-step drift of {k} is {drift[k]:.3g} > {tol}")


def launch_counts():
    """The launch counters of the fused control step (B1, B2, either with a
    fixed base) and of the torques-in route (EnvStep: V control and the
    actuator network)."""
    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk

    return {"B1": pk.DecimatedEnvStep.launches, "B2": pk.DecimatedEnvStep.rough_launches,
            "fixed": pk.DecimatedEnvStep.fixed_launches,
            "B1 torques-in": pk.EnvStep.launches, "B2 torques-in": pk.EnvStep.rough_launches,
            "fixed torques-in": pk.EnvStep.fixed_launches}


def zero_launch_counts():
    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk

    pk.DecimatedEnvStep.launches = pk.DecimatedEnvStep.rough_launches = 0
    pk.EnvStep.launches = pk.EnvStep.rough_launches = 0
    pk.DecimatedEnvStep.fixed_launches = pk.EnvStep.fixed_launches = 0


def training_path(dev, task, seed, iters, envs=FLEET):
    """``iters`` iterations of PPO on ``task`` at its training recipe
    (``envs`` envs, from scratch) through the task registry and
    OnPolicyRunner.learn, then a save/load round trip.  On a generated
    terrain the curriculum must have moved some env's level, within [0,
    num_rows).  Returns the launches of the physics route of the task (B1
    flat, B2 rough, "fixed" on a fixed base; their torques-in route, one
    launch per substep, with the actuator network) in the learn call; no
    other route may launch."""
    import tempfile

    import torch

    from extended_legged_gym_tpu_torch import robots  # noqa: F401
    from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner
    from extended_legged_gym_tpu_torch.utils.task_registry import get_args, task_registry

    args = get_args(argv=["--task", task, "--seed", str(seed), "--num_envs", str(envs),
                          "--max_iterations", str(iters), "--device", str(dev)])
    env, _ = task_registry.make_env(args.task, args)
    rough = env.custom_origins
    ours = (("fixed" if env.model.fix_base else "B2" if rough else "B1")
            + (" torques-in" if env.substep is not None else ""))
    with tempfile.TemporaryDirectory() as root:
        runner, train_cfg = task_registry.make_alg_runner(env, args.task, args, log_root=root)
        net = runner.network
        log(f"{task} training: {env.num_envs} envs, obs {env.num_obs}, actor "
            f"{train_cfg.policy.actor_hidden_dims}, T={runner.num_steps_per_env}, "
            f"{train_cfg.algorithm.num_learning_epochs} epochs x "
            f"{train_cfg.algorithm.num_mini_batches} minibatches, seed {train_cfg.seed}")
        before = torch.cat([p.detach().reshape(-1) for p in net.parameters()]).clone()
        levels0 = runner.env_state.terrain_levels.clone()
        torch.cuda.synchronize()
        zero_launch_counts()
        runner.learn(train_cfg.runner.max_iterations, log_interval=1)
        torch.cuda.synchronize()
        counts = launch_counts()
        with open(os.path.join(runner.log_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        after = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
        want = iters * runner.num_steps_per_env * (
            env.cfg.control.decimation if env.substep is not None else 1)
        others = {k: v for k, v in counts.items() if k != ours}
        log(f"{task} training path: {ours} launches={counts[ours]} (want {want}), others "
            f"{others}; losses " + " ".join(f"{r['loss']:.4g}" for r in rows)
            + "; nonfinite_skips " + " ".join(f"{r['nonfinite_skips']:g}" for r in rows)
            + f"; learning rate {rows[-1]['learning_rate']:.3g}; reward stage "
            f"{rows[-1].get('reward_stage', 0):g}")
        if counts[ours] != want or any(others.values()):
            fail(f"the {task} training path launched {ours} {counts[ours]} times (want {want}) "
                 f"and others {others} (want 0)")
        if not all(math.isfinite(r["loss"]) for r in rows) or not torch.isfinite(after).all():
            fail(f"non-finite loss or parameters on the {task} training path")
        if any(r["nonfinite_skips"] != 0 for r in rows):
            fail(f"the {task} training path skipped updates for non-finite values")
        if torch.equal(before, after):
            fail(f"the {task} training path left the parameters unchanged")
        if rough:
            levels = runner.env_state.terrain_levels
            moved = int((levels != levels0).sum())
            lo, hi = int(levels.min()), int(levels.max())
            log(f"terrain curriculum: {moved} of {env.num_envs} envs changed level; levels "
                f"{lo}..{hi} (rows {env.max_terrain_level}), mean "
                + " -> ".join(f"{r['terrain_level']:.3f}" for r in rows))
            if moved == 0:
                fail("the rough training path moved no env's terrain level")
            if lo < 0 or hi >= env.max_terrain_level:
                fail(f"terrain levels {lo}..{hi} outside [0, {env.max_terrain_level})")
        steady = rows[1:] or rows
        col = sum(r["collection_s"] for r in steady) / len(steady)
        upd = sum(r["update_s"] for r in steady) / len(steady)
        log(f"{task} training iteration (mean of iterations 2-{len(rows)}): {col + upd:.4f} s = "
            f"collection {col:.4f} s + update {upd:.4f} s; "
            f"{env.num_envs * runner.num_steps_per_env / (col + upd):.0f} env-steps/s "
            f"(first iteration {rows[0]['collection_s'] + rows[0]['update_s']:.3f} s)")

        path = os.path.join(root, "roundtrip.pkl")
        runner.save(path)
        fresh = OnPolicyRunner(env, train_cfg)
        fresh.load(path)
        obs = runner.env_state.obs
        a, b = runner.get_inference_policy()(obs), fresh.get_inference_policy()(obs)
        log(f"save/load round trip: iteration {fresh.iteration}, actions equal "
            f"{torch.equal(a, b)} (max diff {(a - b).abs().max().item():.3g})")
        if not torch.equal(a, b):
            fail("the loaded runner's policy gives other actions than the saved one's")
    return counts[ours]


def ray_path(dev):
    """The ray-observation task at 4096 envs stepped by the committed ray
    checkpoint, the ray cast's time, a short ray evaluation and the depth
    camera.  Returns B2's launches in the stepped run."""
    import torch

    from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
    from extended_legged_gym_tpu_torch.envs.legged_robot_config import DepthCfg
    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
    from extended_legged_gym_tpu_torch.perception.depth_camera import DepthCameraRaycast
    from extended_legged_gym_tpu_torch.scripts import bench_mpc
    from extended_legged_gym_tpu_torch.scripts.eval_rough import eval_cfg, load_policy, run_eval

    t0 = time.perf_counter()
    env = LeggedRobot(eval_cfg(FLEET, task="anymal_c_rough_raycast"), device=dev)
    policy = load_policy(RAY_CKPT, env.num_obs, env.num_actions, dev)
    cmd = torch.zeros(env.num_envs, 4, device=dev)
    cmd[:, 0] = RAY_CMD
    with torch.no_grad():
        state = env.reset_all(seed=0).replace(commands=cmd)
        pk.DecimatedEnvStep.launches = pk.DecimatedEnvStep.rough_launches = 0
        up, tail_ok = [], True
        for _ in range(RAY_STEPS):
            state = env.step(state, policy(state.obs)).replace(commands=cmd)
            up.append(state.projected_gravity[:, 2])
            tail = state.obs[:, 235:]
            tail_ok = tail_ok and bool(torch.isfinite(state.obs).all()
                                       and ((tail >= 0.0) & (tail <= 1.0)).all())
        torch.cuda.synchronize()
        launches, b1 = pk.DecimatedEnvStep.rough_launches, pk.DecimatedEnvStep.launches
        upright = torch.stack(up).mean().item()
        log(f"ray path: {RAY_STEPS} control steps, {env.num_envs} envs, obs "
            f"{tuple(state.obs.shape)} ({env.raycaster.num_rays} rays): B2 launches={launches} "
            f"B1 launches={b1} upright_mean={upright:.4f} ray tail finite and in [0, 1]={tail_ok} "
            f"mean {state.obs[:, 235:].mean().item():.4f}")
        if launches != RAY_STEPS or b1:
            fail(f"the ray path launched B2 {launches} times (want {RAY_STEPS}) and B1 {b1}")
        if tuple(state.obs.shape) != (env.num_envs, 267) or not tail_ok:
            fail("the ray observation is not 267 wide with a finite ray tail in [0, 1]")
        if not upright < -0.9:
            fail(f"ray-path robots did not stay upright (upright_mean {upright:.3f})")
        pos, quat = state.phys.base_pos, state.phys.base_quat
        cast_ms = bench_mpc.cuda_ms(lambda: env.raycaster.cast(pos, quat), reps=20, warmup=3)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(RAY_STEPS):
            state = env.step(state, policy(state.obs)).replace(commands=cmd)
        torch.cuda.synchronize()
        sps = RAY_STEPS / (time.perf_counter() - t1)
        log(f"ray cast at {env.num_envs} envs x {env.raycaster.num_rays} rays: {cast_ms:.4f} ms "
            f"per call (CUDA events); ray env {sps:.2f} control steps/s, policy included")
    res = run_eval(RAY_CKPT, 128, 100, 50, RAY_CMD, max_init_level=2, seed=7, device=dev,
                   task="anymal_c_rough_raycast")
    log(f"short ray eval (128 envs, 50+100 steps, levels <= 2, {RAY_CMD} m/s): achieved/command="
        f"{res['achieved_over_command']} upright_mean={res['upright_mean']} falls={res['falls']} "
        f"by type {res['falls_by_terrain_type']}")
    if not all(math.isfinite(res[k]) for k in ("achieved_over_command", "upright_mean")):
        fail("non-finite values in the short ray eval")
    phase_done("ray path", t0)

    t0 = time.perf_counter()
    dcfg = DepthCfg()
    dcfg.camera_type, dcfg.original, dcfg.resized = "Warp", [48, 24], [32, 16]
    cam = DepthCameraRaycast(dcfg, env.num_envs, env.terrain, device=dev)
    with torch.no_grad():
        frame = cam.render(pos, quat)
        render_ms = bench_mpc.cuda_ms(lambda: cam.render(pos, quat), reps=10, warmup=2)
    ok = bool(torch.isfinite(frame).all()) and -DEPTH_SLACK <= frame.min().item() \
        and frame.max().item() <= 1.0 + DEPTH_SLACK
    log(f"depth camera: {env.num_envs} envs, {dcfg.original[0]} x {dcfg.original[1]} rays -> "
        f"{tuple(frame.shape[1:])}: {render_ms:.4f} ms per render (CUDA events), range "
        f"[{frame.min().item():.4g}, {frame.max().item():.4g}], mean {frame.mean().item():.4f}")
    if tuple(frame.shape) != (env.num_envs, 16, 32) or not ok:
        fail(f"the depth render is not finite in [0, 1] at {env.num_envs} x 16 x 32")
    phase_done("depth camera", t0)
    return launches


def flat_params(params):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in params]).clone()


def estimator_path(dev):
    """The terrain estimator trained on the ray task with the ray policy
    driving, its checkpoint round trip, the render and iteration times, and
    the committed JAX estimator in a closed-loop segment.  Returns B2's
    launches in the training and the segment."""
    import tempfile

    import torch

    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
    from extended_legged_gym_tpu_torch.rl.terrain_estimator_runner import TerrainEstimatorRunner
    from extended_legged_gym_tpu_torch.scripts import bench_mpc
    from extended_legged_gym_tpu_torch.scripts.estimator_closed_loop import build_env, rollout
    from extended_legged_gym_tpu_torch.scripts.eval_rough import load_policy

    t0 = time.perf_counter()
    env = build_env(EST_ENVS, 2, dev)
    policy = load_policy(RAY_CKPT, env.num_obs, env.num_actions, dev)
    te = TerrainEstimatorRunner(env, seed=0, policy=policy)
    before = flat_params(te.network.parameters())
    torch.cuda.synchronize()
    pk.DecimatedEnvStep.launches = pk.DecimatedEnvStep.rough_launches = 0
    last = te.learn(EST_ITERS, log_interval=1)
    torch.cuda.synchronize()
    b2, b1 = pk.DecimatedEnvStep.rough_launches, pk.DecimatedEnvStep.launches
    after = flat_params(te.network.parameters())
    want = EST_ITERS * te.num_steps_per_env
    log(f"estimator path: {EST_ITERS} iterations, {env.num_envs} envs, {te.raycaster.num_rays} "
        f"rays, frames {te.camera.H1} x {te.camera.W1}: B2 "
        f"launches={b2} (want {want}) B1 launches={b1}; loss {last['loss']:.5g}; iteration "
        f"{last['iter_time']:.4f} s = collection {last['collection_s']:.4f} s + update "
        f"{last['update_s']:.4f} s (the last)")
    if b2 != want or b1:
        fail(f"the estimator path launched B2 {b2} times (want {want}) and B1 {b1}")
    if not math.isfinite(last["loss"]) or not torch.isfinite(after).all():
        fail("non-finite loss or parameters on the estimator path")
    if torch.equal(before, after):
        fail("the estimator path left the parameters unchanged")
    with torch.no_grad():
        state = env.reset_all(seed=0)
        pos, quat = state.phys.base_pos, state.phys.base_quat
        frame, proprio = te.camera.render(pos, quat), te._proprio(state)
        with tempfile.TemporaryDirectory() as root:
            path = os.path.join(root, "estimator_final.pkl")
            te.save(path)
            fresh = TerrainEstimatorRunner(env, seed=1, policy=policy)
            fresh.load(path)
        a = te.get_estimator()(frame, proprio, te.carry0)[0]
        b = fresh.get_estimator()(frame, proprio, fresh.carry0)[0]
        render_ms = bench_mpc.cuda_ms(lambda: te.camera.render(pos, quat), reps=10, warmup=2)
    log(f"estimator save/load round trip: predictions equal {torch.equal(a, b)}; depth render at "
        f"{env.num_envs} envs: {render_ms:.4f} ms (CUDA events)")
    if not torch.equal(a, b):
        fail("the loaded estimator predicts other distances than the saved one")

    jte = TerrainEstimatorRunner(env, seed=0, policy=policy)
    jte.load(JAX_ESTIMATOR)
    torch.cuda.synchronize()
    pk.DecimatedEnvStep.launches = pk.DecimatedEnvStep.rough_launches = 0
    res = rollout(env, jte, policy, True, warmup=0, steps=EST_CL_STEPS, cmd_mps=RAY_CMD, seed=7)
    torch.cuda.synchronize()
    seg, b1 = pk.DecimatedEnvStep.rough_launches, pk.DecimatedEnvStep.launches
    log(f"closed-loop segment with the JAX estimator ({EST_CL_STEPS} steps, ray tail swapped): "
        f"B2 launches={seg} B1 launches={b1}; RMSE {res['rmse']:.4f} m, near-3 m "
        f"{res['near_rmse']:.4f} m, tracking {res['vx'] / RAY_CMD:.4f}, upright_mean "
        f"{res['upright']:.4f}, resets {res['resets']:g}")
    if seg != EST_CL_STEPS or b1:
        fail(f"the closed-loop segment launched B2 {seg} times (want {EST_CL_STEPS}) and B1 {b1}")
    if not all(math.isfinite(res[k]) for k in ("rmse", "mae", "near_rmse", "vx")):
        fail("non-finite predictions in the closed-loop segment")
    if not res["upright"] < -0.9:
        fail(f"closed-loop robots did not stay upright (upright_mean {res['upright']:.3f})")
    phase_done("estimator path", t0)
    return b2 + seg


def distill_path(dev):
    """DISTILL_ITERS iterations of the distillation recipe at its fleet.
    Returns B1's launches."""
    import torch

    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
    from extended_legged_gym_tpu_torch.scripts.evidence_artifacts import distill_runner

    t0 = time.perf_counter()
    runner = distill_runner(CKPT, DISTILL_ENVS, DISTILL_ITERS, dev)
    obs = runner.env_state.obs.clone()
    with torch.no_grad():
        teacher_out = runner.teacher_policy(obs).clone()
    student = flat_params(runner.alg.optimizer.params)
    teacher_slot = flat_params(runner.network.teacher.parameters())
    torch.cuda.synchronize()
    pk.DecimatedEnvStep.launches = pk.DecimatedEnvStep.rough_launches = 0
    last = runner.learn(DISTILL_ITERS, log_interval=1)
    torch.cuda.synchronize()
    b1, b2 = pk.DecimatedEnvStep.launches, pk.DecimatedEnvStep.rough_launches
    want = DISTILL_ITERS * runner.num_steps_per_env
    student_after = flat_params(runner.alg.optimizer.params)
    with torch.no_grad():
        teacher_same = torch.equal(runner.teacher_policy(obs), teacher_out) and torch.equal(
            flat_params(runner.network.teacher.parameters()), teacher_slot)
    log(f"distillation path: {DISTILL_ITERS} iterations, {runner.env.num_envs} envs, student "
        f"(256, 256, 128): B1 launches={b1} (want {want}) B2 launches={b2}; behavior loss "
        f"{last['behavior_loss']:.5g}; {runner.alg.num_updates} optimizer steps, learning rate "
        f"{runner.alg.learning_rate:.4g}; teacher unchanged {teacher_same}; iteration "
        f"{last['collection_s'] + last['update_s']:.4f} s = collection {last['collection_s']:.4f} "
        f"s + update {last['update_s']:.4f} s (the last)")
    if b1 != want or b2:
        fail(f"the distillation path launched B1 {b1} times (want {want}) and B2 {b2}")
    if not math.isfinite(last["behavior_loss"]) or not torch.isfinite(student_after).all():
        fail("non-finite loss or student parameters on the distillation path")
    if torch.equal(student, student_after):
        fail("the distillation path left the student's parameters unchanged")
    if not teacher_same:
        fail("the distillation path changed the teacher")
    phase_done("distillation path", t0)
    return b1


def elspider_path(dev, stats):
    """B1 with the ElSpider Air tables against plain (one control step at
    ELSPIDER_B, the 25-step drift at 16, two launches bit for bit at 4096;
    ms, plain ms and bound into ``stats``), ELSPIDER_ITERS iterations of
    elspider_air_flat training at the fleet (B1 exactly ELSPIDER_ITERS x 24
    on the hexapod's tables), and a short evaluation of the committed JAX
    checkpoint.  The plain version runs in float64 here: on the hexapod's
    light legs its float32 rounding alone moves a joint velocity by about
    0.045 rad/s in a control step from near-standing states with random
    actions (at 4096 envs, against float64), most of ONE_STEP_ATOL's 5e-2.
    The 25-step drift is reported, not bounded (drift_report): from these
    states some knees chatter against the joint velocity limit and the
    float32 plain leaves the float64 plain by several rad/s.  Returns the
    largest difference against plain and B1's launches in the training and
    the evaluation."""
    import torch

    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import (STAND_HEIGHT, elspider_step,
                                                                    near_standing)
    from extended_legged_gym_tpu_torch.scripts.eval_policy import evaluate

    t0 = time.perf_counter()
    step = elspider_step(dev)
    m, h = step.model, STAND_HEIGHT["elspider_air"]
    log(f"ElSpider B1 (nb={m.nb} nj={m.nj} ng={m.ng} nf={step.nf}) block of {pk.ENVS_PER_BLOCK} "
        f"envs: {pk.block_shared_bytes(m.nb, m.nj, m.ng, step.nf)} bytes of shared memory")
    err = max(compare_one_step("ElSpider B1", step, B, near_standing(m, B, B, dev, height=h), stats,
                               torch.float64) for B in ELSPIDER_B)
    drift_report("ElSpider B1", step, 16, near_standing(m, 16, 7, dev, height=h))
    bit_identical("ElSpider B1", step, 4096, near_standing(m, 4096, 3, dev, height=h))
    phase_done("ElSpider B1 vs plain", t0)

    t0 = time.perf_counter()
    train = training_path(dev, "elspider_air_flat", 1, ELSPIDER_ITERS)
    phase_done("ElSpider training path", t0)

    t0 = time.perf_counter()
    zero_launch_counts()
    res = evaluate("elspider_air_flat", ELSPIDER_CKPT, envs=16, steps=100, warmup=50, device=dev)
    ev = launch_counts()["B1"]
    log(f"ElSpider evaluation of the committed JAX checkpoint (16 envs, 50+100 steps, "
        f"{res['command_mps']} m/s): achieved/command={res['achieved_over_command']} "
        f"upright_mean={res['upright_mean']} base_height_mean={res['base_height_mean']} "
        f"falls={res['falls']}; B1 launches={ev}")
    if not all(math.isfinite(res[k]) for k in ("achieved_over_command", "upright_mean")):
        fail("non-finite values in the ElSpider evaluation")
    if not res["upright_mean"] < -0.9 or ev != 150:
        fail(f"ElSpider evaluation: upright_mean {res['upright_mean']}, B1 launches {ev} (want 150)")
    phase_done("ElSpider evaluation", t0)
    return err, train + ev


def sea_path(dev, stats):
    """The SEA route: the anymal_c_flat_sea env's torques-in B1 step
    (EnvStep) against plain at the fleet with the actuator network's torques
    (ms, plain ms and bound into ``stats``), SEA_ITERS training iterations
    at the fleet (EnvStep exactly SEA_ITERS x 24 x 4, the fused step never),
    and a short evaluation of the committed JAX SEA checkpoint.  Returns the
    largest difference against plain and the route's launches."""
    import torch

    from extended_legged_gym_tpu_torch import robots  # noqa: F401
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import STAND_HEIGHT, near_standing
    from extended_legged_gym_tpu_torch.scripts.eval_policy import evaluate
    from extended_legged_gym_tpu_torch.utils.task_registry import task_registry

    t0 = time.perf_counter()
    cfg, _ = task_registry.get_cfgs("anymal_c_flat_sea")
    cfg.env.num_envs = FLEET
    env, _ = task_registry.make_env("anymal_c_flat_sea", env_cfg=cfg, device=dev)
    if env.substep is None or env.decimated_step is not None or env.actuator_net is None:
        fail("the SEA env does not run the actuator network on the torques-in route")
    st, ep, act = near_standing(env.model, FLEET, 9, dev, height=STAND_HEIGHT["anymal_c"])
    with torch.no_grad():
        hidden = env.actuator_net.init_hidden((FLEET, env.num_dof))
        for _ in range(3):                      # a hidden state that has seen some steps
            tau, hidden = env._compute_torques(act, st, None, hidden)
    err = compare_one_step("SEA EnvStep", env.substep, FLEET, (st, ep, tau), stats)
    log(f"SEA torques at the fleet: |max| {tau.abs().max().item():.3g} N m")
    phase_done("SEA route vs plain", t0)

    t0 = time.perf_counter()
    launches = training_path(dev, "anymal_c_flat_sea", 2, SEA_ITERS)
    phase_done("SEA training path", t0)

    t0 = time.perf_counter()
    res = evaluate("anymal_c_flat_sea", SEA_CKPT, envs=16, steps=100, warmup=50, device=dev)
    log(f"SEA evaluation of the committed JAX checkpoint (16 envs, 50+100 steps, "
        f"{res['command_mps']} m/s): achieved/command={res['achieved_over_command']} "
        f"upright_mean={res['upright_mean']} base_height_mean={res['base_height_mean']} "
        f"falls={res['falls']}")
    if not all(math.isfinite(res[k]) for k in ("achieved_over_command", "upright_mean")):
        fail("non-finite values in the SEA evaluation")
    if not res["upright_mean"] < -0.9:
        fail(f"SEA evaluation: robots did not stay upright (upright_mean {res['upright_mean']})")
    phase_done("SEA evaluation", t0)
    return err, launches


def base_unchanged(name, before, after):
    """A fixed base's pose and velocities must come out of the kernel bit for
    bit as they went in (states at rest, the identity orientation)."""
    import torch

    bad = [k for k in ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel")
           if not torch.equal(getattr(before, k), getattr(after, k))]
    log(f"{name}: fixed base " + ("unchanged bit for bit" if not bad else f"moved in {bad}"))
    if bad:
        fail(f"{name}: the fixed base moved ({bad})")


def franka_path(dev, stats):
    """The fixed-base regime with the Franka arm's tables (8 bodies, 7 joints,
    one sphere on the base, no feet) against plain: one control step at
    FRANKA_B from states at rest with random actions, the 25-step drift at 8
    reported (drift_report: the arm's 2.2-2.6 rad/s velocity limits clamp
    often), two launches bit for bit at the fleet, the base unchanged bit
    for bit after one step and after the drift (ms, plain ms and bound into
    ``stats``); then the ``franka`` task through the registry for
    FRANKA_ITERS iterations at its fleet (the fixed-base route exactly
    FRANKA_ITERS x 24, B1 and B2 0) and ``franka_batch_rollout``'s
    ``rollout_batch`` at FRANKA_E main envs x FRANKA_S samples x FRANKA_H
    steps (exactly FRANKA_H launches, finite rewards).  Returns the largest
    difference against plain and the launches of both paths."""
    import torch

    from extended_legged_gym_tpu_torch import robots  # noqa: F401
    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import at_rest, franka_step
    from extended_legged_gym_tpu_torch.utils.task_registry import task_registry

    t0 = time.perf_counter()
    step = franka_step(dev)
    m = step.model
    log(f"fixed-base regime, Franka (nb={m.nb} nj={m.nj} ng={m.ng} nf={step.nf}, fix_base="
        f"{m.fix_base}) block of {pk.ENVS_PER_BLOCK} envs: "
        f"{pk.block_shared_bytes(m.nb, m.nj, m.ng, step.nf)} bytes of shared memory")
    err = max(compare_one_step("fixed-base", step, B, at_rest(m, B, B, dev), stats)
              for B in FRANKA_B)
    st, ep, act = at_rest(m, FRANKA_FLEET, 4, dev)
    base_unchanged("fixed-base one step", st, step.launch(st, act, ep)[0])
    st, ep, act = at_rest(m, 8, 7, dev)
    drift_report("fixed-base", step, 8, (st, ep, act))
    sk = st
    for _ in range(25):
        sk = step.launch(sk, 0.2 * act, ep)[0]
    base_unchanged("fixed-base 25 control steps", st, sk)
    bit_identical("fixed-base", step, FRANKA_FLEET, at_rest(m, FRANKA_FLEET, 3, dev))
    log("no single PyTorch call computes this step; library_ms is null")
    phase_done("fixed-base regime vs plain", t0)

    t0 = time.perf_counter()
    train = training_path(dev, "franka", 1, FRANKA_ITERS, envs=FRANKA_FLEET)
    phase_done("Franka training path", t0)

    t0 = time.perf_counter()
    cfg, _ = task_registry.get_cfgs("franka_batch_rollout")
    env, _ = task_registry.make_env("franka_batch_rollout", env_cfg=cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        state = env.reset_all(seed=0)
        us = 0.5 * torch.randn(FRANKA_E, FRANKA_S, FRANKA_H, env.num_actions, device=dev,
                               generator=gen)
        torch.cuda.synchronize()
        zero_launch_counts()
        t1 = time.perf_counter()
        rew = env.rollout_batch(state, us)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
    counts = launch_counts()
    others = {k: v for k, v in counts.items() if k != "fixed"}
    log(f"franka_batch_rollout: rollout_batch {env.num_envs} main envs x {FRANKA_S} samples x "
        f"H={FRANKA_H}: {ms:.1f} ms, fixed-base launches={counts['fixed']} (want {FRANKA_H}), "
        f"others {others}; rewards {tuple(rew.shape)} mean {rew.mean().item():.4g}")
    if counts["fixed"] != FRANKA_H or any(others.values()):
        fail(f"the Franka rollout launched the fixed-base route {counts['fixed']} times "
             f"(want {FRANKA_H}) and others {others}")
    if env.num_envs != FRANKA_E or tuple(rew.shape) != (FRANKA_E, FRANKA_S, FRANKA_H):
        fail(f"the Franka rollout's rewards have shape {tuple(rew.shape)}")
    if not bool(torch.isfinite(rew).all()):
        fail("non-finite rewards on the Franka rollout")
    phase_done("Franka rollout", t0)
    return err, train + counts["fixed"]


def cyberdog2_path(dev, stats):
    """B1 with CyberDog2's tables (13 bodies, 12 joints, 37 spheres, 4 feet)
    against plain (float64, as for the hexapod's light legs) at the walk
    family's fleet from near-standing states, two launches bit for bit (ms,
    plain ms and bound into ``stats``); then CYBER_ITERS iterations of
    ``cyber2_walk`` training at the fleet (B1 exactly CYBER_ITERS x 24).
    Returns the largest difference against plain and B1's launches."""
    import torch

    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import (STAND_HEIGHT, near_standing,
                                                                    task_step)

    t0 = time.perf_counter()
    step = task_step("cyber2_walk", dev)
    m, h = step.model, STAND_HEIGHT["cyberdog2"]
    log(f"CyberDog2 B1 (nb={m.nb} nj={m.nj} ng={m.ng} nf={step.nf}) block of "
        f"{pk.ENVS_PER_BLOCK} envs: {pk.block_shared_bytes(m.nb, m.nj, m.ng, step.nf)} bytes of "
        f"shared memory")
    states = near_standing(m, CYBER_B, 5, dev, height=h)
    err = compare_one_step("CyberDog2 B1", step, CYBER_B, states, stats, torch.float64)
    st, ep, act = states
    fz = step.plain(st, act, ep)[2].geom_forces[..., 2].sum(1)
    log(f"CyberDog2: {int((fz > 0).sum())} of {CYBER_B} robots touch the ground")
    bit_identical("CyberDog2 B1", step, CYBER_B, near_standing(m, CYBER_B, 3, dev, height=h))
    phase_done("CyberDog2 B1 vs plain", t0)

    t0 = time.perf_counter()
    train = training_path(dev, "cyber2_walk", 1, CYBER_ITERS)
    phase_done("CyberDog2 training path", t0)
    return err, train


def extensions_path(dev):
    """The RL extensions on anymal_c_flat at the fleet: recurrent PPO (an
    LSTM of 512 before each MLP) with RND for EXT_ITERS iterations (B1
    exactly EXT_ITERS x 24), its stateful inference policy and a save/load
    round trip; the recurrent policy with a symmetry_cfg is refused; then
    the MLP policy with RND and the left-right symmetry loss for EXT_ITERS
    iterations (B1 exactly EXT_ITERS x 24).  Returns B1's launches."""
    import tempfile

    import torch

    from extended_legged_gym_tpu_torch import robots  # noqa: F401
    from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner
    from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_symmetry_cfg
    from extended_legged_gym_tpu_torch.scripts.bench_train import RND_CFG, recurrent_train_cfg
    from extended_legged_gym_tpu_torch.utils.task_registry import task_registry

    t0 = time.perf_counter()
    cfg, _ = task_registry.get_cfgs("anymal_c_flat")
    cfg.env.num_envs, cfg.seed = FLEET, 2
    env, _ = task_registry.make_env("anymal_c_flat", env_cfg=cfg, device=dev)
    total = 0
    refused = False
    try:
        tc = recurrent_train_cfg(task_registry.get_cfgs("anymal_c_flat")[1])
        tc.algorithm.symmetry_cfg = anymal_c_symmetry_cfg()
        OnPolicyRunner(env, tc)
    except ValueError as e:
        refused = "symmetry" in str(e)
    log(f"recurrent policy with a symmetry_cfg refused: {refused}")
    if not refused:
        fail("the runner took symmetry_cfg with a recurrent policy")
    for name in ("recurrent + RND", "MLP + RND + symmetry"):
        tc = task_registry.get_cfgs("anymal_c_flat")[1]
        tc.seed = 2
        if name.startswith("recurrent"):
            recurrent_train_cfg(tc)
        else:
            tc.algorithm.rnd_cfg = dict(RND_CFG)
            tc.algorithm.symmetry_cfg = anymal_c_symmetry_cfg()
        with tempfile.TemporaryDirectory() as root:
            runner, _ = task_registry.make_alg_runner(env, train_cfg=tc, log_root=root)
            before = flat_params(runner.network.parameters())
            rnd_before = flat_params(runner.rnd.predictor.parameters())
            torch.cuda.synchronize()
            zero_launch_counts()
            runner.learn(EXT_ITERS, log_interval=1)
            torch.cuda.synchronize()
            counts = launch_counts()
            with open(os.path.join(runner.log_dir, "metrics.jsonl")) as f:
                rows = [json.loads(line) for line in f]
            want = EXT_ITERS * runner.num_steps_per_env
            log(f"{name} path: {env.num_envs} envs, policy {tc.runner.policy_class_name} "
                f"({tc.policy.rnn_type} {tc.policy.rnn_hidden_size} before "
                f"{tc.policy.actor_hidden_dims})" if runner.recurrent else
                f"{name} path: {env.num_envs} envs, policy {tc.runner.policy_class_name} "
                f"{tc.policy.actor_hidden_dims}, symmetry coef {runner.symmetry[2]}")
            log(f"  launches {counts} (want B1 {want}); losses "
                + " ".join(f"{r['loss']:.4g}" for r in rows) + "; rnd_loss "
                + " ".join(f"{r['rnd_loss']:.4g}" for r in rows) + "; nonfinite_skips "
                + " ".join(f"{r['nonfinite_skips']:g}" for r in rows) + "; iteration "
                + " ".join(f"{r['collection_s'] + r['update_s']:.3f} s = collection "
                           f"{r['collection_s']:.3f} + update {r['update_s']:.3f}" for r in rows))
            if counts["B1"] != want or counts["B2"] or counts["B1 torques-in"]:
                fail(f"the {name} path launched {counts} (want B1 {want} only)")
            if not all(math.isfinite(r["loss"]) and math.isfinite(r["rnd_loss"]) for r in rows):
                fail(f"non-finite loss or RND loss on the {name} path")
            if any(r["nonfinite_skips"] for r in rows):
                fail(f"the {name} path skipped updates for non-finite values")
            if torch.equal(before, flat_params(runner.network.parameters())) or torch.equal(
                    rnd_before, flat_params(runner.rnd.predictor.parameters())):
                fail(f"the {name} path left the policy or the RND predictor unchanged")
            total += counts["B1"]
            if runner.recurrent:
                obs = runner.env_state.obs
                policy = runner.get_inference_policy()
                a1, a2 = policy(obs), policy(obs)
                policy.reset(torch.ones(env.num_envs, dtype=torch.bool, device=dev))
                a3 = policy(obs)
                path = os.path.join(root, "roundtrip.pkl")
                runner.save(path)
                fresh = OnPolicyRunner(env, tc)
                fresh.load(path)
                a4 = fresh.get_inference_policy()(obs)
                log(f"  stateful inference policy: second call differs by "
                    f"{(a2 - a1).abs().max().item():.3g}, after reset equal {torch.equal(a1, a3)}; "
                    f"save/load round trip equal {torch.equal(a1, a4)}")
                if torch.equal(a1, a2) or not torch.equal(a1, a3) or not torch.equal(a1, a4):
                    fail("the recurrent inference policy does not carry, reset or round-trip")
    phase_done("RL extensions", t0)
    return total


def main():
    import torch

    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)

    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
    from extended_legged_gym_tpu_torch.physics import load_model
    from extended_legged_gym_tpu_torch.robots.anymal_c_traj import (
        AnymalCTrajGradSampling, anymal_c_traj_sampling_cfg)
    from extended_legged_gym_tpu_torch.scripts import bench_mpc
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import near_standing, rough_env
    from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
    from extended_legged_gym_tpu_torch.scripts.eval_policy import evaluate
    from extended_legged_gym_tpu_torch.scripts.eval_rough import eval_cfg, load_policy, run_eval
    from extended_legged_gym_tpu_torch.utils.device import resolve_device

    # ---------------- 1. device ----------------
    dev = resolve_device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind} x{count}")
    log(smi)
    phase_done("device", t0)

    # ---------------- 2. build ----------------
    t0 = time.perf_counter()
    pk.load_library()
    for line in pk.build_log().splitlines():
        if any(w in line for w in ("entry function", "registers", "spill", "stack frame")):
            log(f"ptxas: {line.strip()}")
    phase_done("build", t0)

    # ---------------- 3. B1 against plain ----------------
    t0 = time.perf_counter()
    cfg = anymal_c_traj_sampling_cfg(1)
    model = load_model(cfg.asset.file)
    step = AnymalCTrajGradSampling(cfg, device=dev).decimated_step
    log(f"B1 block of {pk.ENVS_PER_BLOCK} envs: "
        f"{pk.block_shared_bytes(model.nb, model.nj, model.ng, step.nf)} bytes of shared memory")
    flat_stats, flat_err = {}, 0.0
    for B in CHECK_B:
        flat_err = max(flat_err, compare_one_step("B1", step, B, near_standing(model, B, B, dev),
                                                  flat_stats))
    drift_check("B1", step, 776, near_standing(model, 776, 7, dev))
    bit_identical("B1", step, 1024, near_standing(model, 1024, 1, dev))
    bit_identical("B1", step, 4096, near_standing(model, 4096, 3, dev))
    log("no single PyTorch call computes this step; library_ms is null")
    phase_done("B1 vs plain", t0)

    # ---------------- 4. B2 against plain ----------------
    t0 = time.perf_counter()
    renv = rough_env(max(ROUGH_B), dev)
    rstep = renv.decimated_step
    if not rstep.rough:
        fail("the rough env's physics step is not B2")
    log(f"B2 block of {pk.ENVS_PER_BLOCK} envs: "
        f"{pk.block_shared_bytes(model.nb, model.nj, model.ng, rstep.nf, True)} bytes of shared memory")
    origins = renv.reset_all(seed=0).env_origins
    log(f"rough terrain {renv.terrain.shape[0]} x {renv.terrain.shape[1]} at "
        f"{renv.terrain.hscale:.3g} m; spawn levels 0..{int(renv.init_terrain_levels.max())}")
    rough_stats, rough_err = {}, 0.0
    for B in ROUGH_B:
        rough_err = max(rough_err, compare_one_step(
            "B2", rstep, B, near_standing(model, B, B, dev, origins), rough_stats))
    drift_check("B2", rstep, 32, near_standing(model, 32, 11, dev, origins))
    bit_identical("B2", rstep, 4096, near_standing(model, 4096, 2, dev, origins))
    log("no single PyTorch call computes this step; library_ms is null")
    phase_done("B2 vs plain", t0)

    # ---------------- 5. MPC path ----------------
    t0 = time.perf_counter()
    E, n_warm, n_cycles = 8, 6, 34
    cfg = anymal_c_traj_sampling_cfg(E)
    cfg.rl_warmstart.policy_checkpoint = CKPT
    cfg.commands.resampling_time = 1e9
    cfg.commands.ranges.lin_vel_x = [CMD, CMD]
    cfg.commands.ranges.lin_vel_y = [0.0, 0.0]
    cfg.commands.ranges.ang_vel_yaw = [0.0, 0.0]
    env = AnymalCTrajGradSampling(cfg, device=dev)
    env.setup_rl_warmstart()
    pk.DecimatedEnvStep.launches = pk.DecimatedEnvStep.rough_launches = 0
    state = env.reset_all(seed=0)
    nodes = env.init_trajectories_from_rl(state)
    vx, up, resets = [], [], 0
    for i in range(n_warm + n_cycles):
        state, nodes, _ = env.mpc_step(state, nodes, n_diffuse=6 if i < n_warm else None)
        if i >= n_warm:
            vx.append(state.base_lin_vel[:, 0])
            up.append(state.projected_gravity[:, 2])
            resets += int(state.reset_buf.sum())
    torch.cuda.synchronize()
    flat_launches = pk.DecimatedEnvStep.launches
    vx, up = torch.stack(vx), torch.stack(up)
    half = n_cycles // 2
    ratio = vx[half:].mean().item() / CMD
    upright = up[half:].mean().item()
    log(f"MPC path: {n_warm}+{n_cycles} mpc_step cycles, E={E}: achieved/command={ratio:.4f} "
        f"upright_mean={upright:.4f} resets={resets} B1 launches={flat_launches} "
        f"B2 launches={pk.DecimatedEnvStep.rough_launches}")
    if flat_launches <= 0:
        fail("the MPC path launched B1 no time")
    if not (torch.isfinite(vx).all() and torch.isfinite(up).all() and torch.isfinite(nodes).all()):
        fail("non-finite values on the MPC path")
    if not upright < -0.9:
        fail(f"robots did not stay upright (upright_mean {upright:.3f})")
    phase_done("MPC path", t0)

    # ---------------- 6. rough path ----------------
    t0 = time.perf_counter()
    policy = load_policy(ROUGH_CKPT, renv.num_obs, renv.num_actions, dev)
    cmd = torch.zeros(renv.num_envs, 4, device=dev)
    cmd[:, 0] = CMD
    with torch.no_grad():
        state = renv.reset_all(seed=0).replace(commands=cmd)
        pk.DecimatedEnvStep.launches = pk.DecimatedEnvStep.rough_launches = 0
        up, finite = [], True
        for _ in range(ROUGH_STEPS):
            state = renv.step(state, policy(state.obs)).replace(commands=cmd)
            up.append(state.projected_gravity[:, 2])
            finite = finite and bool(torch.isfinite(state.obs).all())
        torch.cuda.synchronize()
        rough_launches = pk.DecimatedEnvStep.rough_launches
        upright = torch.stack(up).mean().item()
        log(f"rough path: {ROUGH_STEPS} control steps, {renv.num_envs} envs, obs "
            f"{tuple(state.obs.shape)}: B2 launches={rough_launches} B1 launches="
            f"{pk.DecimatedEnvStep.launches} upright_mean={upright:.4f} obs finite={finite} "
            f"falls={int((state.reset_buf & ~state.time_out_buf).sum())} (last step)")
        if rough_launches != ROUGH_STEPS:
            fail(f"the rough path launched B2 {rough_launches} times, not {ROUGH_STEPS}")
        if not finite:
            fail("non-finite observations on the rough path")
        if not upright < -0.9:
            fail(f"rough-path robots did not stay upright (upright_mean {upright:.3f})")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(ROUGH_STEPS):
            state = renv.step(state, policy(state.obs)).replace(commands=cmd)
        torch.cuda.synchronize()
        sps = ROUGH_STEPS / (time.perf_counter() - t1)
    log(f"rough env at {renv.num_envs} envs, policy included: {sps:.2f} control steps/s "
        f"({sps * renv.num_envs:.0f} env-steps/s)")
    res = run_eval(ROUGH_CKPT, 32, 100, 50, CMD, max_init_level=2, seed=0, device=dev)
    log(f"short rough eval (32 envs, 50+100 steps, levels <= 2): achieved/command="
        f"{res['achieved_over_command']} upright_mean={res['upright_mean']} "
        f"falls={res['falls']} by type {res['falls_by_terrain_type']}")
    if not all(math.isfinite(res[k]) for k in ("achieved_over_command", "upright_mean")):
        fail("non-finite values in the short rough eval")
    phase_done("rough path", t0)

    # ---------------- 7. V-control routes ----------------
    t0 = time.perf_counter()
    venvs = (("flat_v", AnymalCTrajGradSampling(v_control(anymal_c_traj_sampling_cfg(V_FLAT_B)),
                                                device=dev), V_FLAT_B, None),
             ("rough_v", LeggedRobot(v_control(eval_cfg(V_ROUGH_B)), device=dev), V_ROUGH_B,
              origins))
    v_stats, v_err, v_launches = {}, {}, {}
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, venv, B, org in venvs:
        vstep = venv.substep
        if venv.decimated_step is not None or vstep.rough != (org is not None):
            fail(f"{name}: the V-control env does not run the per-substep route")
        st, ep, act = near_standing(model, B, 5, dev, org)
        v_stats[name] = {}
        v_err[name] = compare_one_step(name, vstep, B, (st, ep, 20.0 * act), v_stats[name])
        with torch.no_grad():
            state = venv.reset_all(seed=0)
            pk.EnvStep.launches = pk.EnvStep.rough_launches = 0
            pk.DecimatedEnvStep.launches = pk.DecimatedEnvStep.rough_launches = 0
            finite = True
            for _ in range(V_STEPS):
                a = torch.randn(B, venv.num_actions, device=dev, generator=gen)
                state = venv.step(state, a)
                finite = finite and bool(torch.isfinite(state.obs).all())
            torch.cuda.synchronize()
        v_launches[name] = pk.EnvStep.rough_launches if vstep.rough else pk.EnvStep.launches
        want = V_STEPS * venv.cfg.control.decimation
        log(f"{name} env: {V_STEPS} control steps, {B} envs: route launches={v_launches[name]} "
            f"(want {want}), fused launches B1={pk.DecimatedEnvStep.launches} "
            f"B2={pk.DecimatedEnvStep.rough_launches}, torques |max|="
            f"{state.torques.abs().max().item():.3g}, obs finite={finite}")
        if v_launches[name] != want:
            fail(f"{name}: the V route launched {v_launches[name]} times, not {want}")
        if pk.DecimatedEnvStep.launches or pk.DecimatedEnvStep.rough_launches:
            fail(f"{name}: the V-control env launched the fused control step")
        if not finite:
            fail(f"{name}: non-finite observations under V control")
    phase_done("V routes", t0)

    # ---------------- 8. training path ----------------
    t0 = time.perf_counter()
    train_launches = training_path(dev, "anymal_c_flat", 2, TRAIN_ITERS)
    phase_done("training path", t0)

    # ---------------- 9. rough training path ----------------
    t0 = time.perf_counter()
    rough_train_launches = training_path(dev, "anymal_c_rough", 1, ROUGH_TRAIN_ITERS)
    phase_done("rough training path", t0)

    # ---------------- 10-11. ray path and depth camera ----------------
    ray_launches = ray_path(dev)

    # ---------------- 12. estimator path ----------------
    est_launches = estimator_path(dev)

    # ---------------- 13. distillation path ----------------
    distill_launches = distill_path(dev)

    # ---------------- 14-16. ElSpider, SEA, RL extensions ----------------
    elspider_stats, sea_stats = {}, {}
    elspider_err, elspider_launches = elspider_path(dev, elspider_stats)
    sea_err, sea_launches = sea_path(dev, sea_stats)
    ext_launches = extensions_path(dev)

    # ---------------- 17-18. the fixed-base regime: Franka ----------------
    franka_stats = {}
    franka_err, franka_launches = franka_path(dev, franka_stats)

    # ---------------- 19. CyberDog2 on B1 ----------------
    cyber_stats = {}
    cyber_err, cyber_launches = cyberdog2_path(dev, cyber_stats)

    # ---------------- 20. flat evaluation ----------------
    t0 = time.perf_counter()
    res = evaluate("anymal_c_flat", FLAT_CKPT, CMD, envs=16, steps=100, warmup=50, device=dev)
    log(f"flat evaluation of the committed JAX checkpoint (16 envs, 50+100 steps): "
        f"achieved/command={res['achieved_over_command']} upright_mean={res['upright_mean']} "
        f"base_height_mean={res['base_height_mean']} falls={res['falls']}")
    if not all(math.isfinite(res[k]) for k in ("achieved_over_command", "upright_mean",
                                                "base_height_mean", "falls")):
        fail("non-finite values in the flat evaluation")
    if not res["upright_mean"] < -0.9:
        fail(f"flat evaluation: robots did not stay upright (upright_mean {res['upright_mean']})")
    phase_done("flat evaluation", t0)

    # ---------------- 21. timing ----------------
    t0 = time.perf_counter()
    solves, _ = bench_mpc.solve_latency(dev, n_solves=15)
    log(f"solve at E=1 (Nsample=127 Hsample=16 Hnode=4 Ndiffuse=2 polish=fd x2): "
        f"p50 {bench_mpc.percentile(solves, 50):.2f} ms, p90 {bench_mpc.percentile(solves, 90):.2f} ms "
        f"over {len(solves)} solves")
    rb_ms, rps = bench_mpc.rollout_throughput(dev, E=16, S=128, H=64)
    log(f"rollout_batch E=16 S=128 H=64: {rb_ms:.1f} ms, {rps:.1f} rollouts/s")
    phase_done("timing", t0)

    # ---------------- 22. result ----------------
    src = "extended_legged_gym_tpu_torch/csrc/physics_step.cu"
    kernels = []
    replaces = "extended_legged_gym_tpu/ops/physics_kernel.py:447"
    for name, launches, err, ks in (
            ("flat_decimated_physics_step",
             flat_launches + train_launches + distill_launches + ext_launches, flat_err,
             flat_stats[4096]),
            ("flat_decimated_physics_step_elspider_air", elspider_launches, elspider_err,
             elspider_stats[4096]),
            ("flat_physics_substep_sea_route", sea_launches, sea_err, sea_stats[FLEET]),
            ("fixed_base_decimated_physics_step_franka", franka_launches, franka_err,
             franka_stats[FRANKA_FLEET]),
            ("flat_decimated_physics_step_cyberdog2", cyber_launches, cyber_err,
             cyber_stats[CYBER_B]),
            ("rough_decimated_physics_step",
             rough_launches + ray_launches + rough_train_launches + est_launches, rough_err,
             rough_stats[4096]),
            ("flat_physics_substep_v_route", v_launches["flat_v"], v_err["flat_v"],
             v_stats["flat_v"][V_FLAT_B]),
            ("rough_physics_substep_v_route", v_launches["rough_v"], v_err["rough_v"],
             v_stats["rough_v"][V_ROUGH_B])):
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches, "max_abs_err": err, "ms": ks["ms"],
                        "plain_ms": ks["plain_ms"], "bound_ms": ks["bound_ms"],
                        "bound_by": ks["bound_by"], "library_ms": None})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
