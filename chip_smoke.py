#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints its seconds; the run fails rather than overrun):
1. device: require CUDA, print the card's name and power limit;
2. build: compile the fused physics kernel (csrc/physics_step.cu) with nvcc;
3. kernel against its plain version (physics/aba.py) on the card: one
   control step from seeded near-standing states with random actions at
   every batch the main path launches it with (8 x 128, 8 x 97, 8 x 3 and
   8 envs) and at 2048, then 25 control steps of drift at 8 x 97;
4. main path: ANYmal-C flat sampling MPC (RobotTrajGradSampling.mpc_step at
   the committed config, 8 envs, 0.7 m/s command, warm-started from the
   committed checkpoint), then the solve latency at 1 env and the rollout
   throughput at 16 envs x 128 samples x H=64, timed with CUDA events;
5. the kernel line (JSON) and the result line.

Exits non-zero, printing no result line, without CUDA or without the port.
Imports nothing of JAX or of the JAX package.
"""
import json
import os
import subprocess
import sys
import time

T_START = time.perf_counter()
TIME_LIMIT_S = 280.0            # the whole run, build included
PEAK_F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3
ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "logs/flat_anymal_c/Aug21_12-38-39_r5_ft4/model_final.pkl")
CMD = 0.7

# kernel against plain, one control step (tests/test_physics_kernel.py:66-84):
# positions integrate from matching velocities, so they are tight; velocities
# carry float32 accumulation-order noise through the contact solve
ONE_STEP_ATOL = dict(base_pos=1e-4, base_quat=1e-4, joint_pos=5e-4, base_lin_vel=2e-2,
                     base_ang_vel=2e-2, joint_vel=5e-2, contact_anchor=1e-4, foot_pos=1e-4)
# the main path's batches at E=8: sampling rollouts (8 x 128), fd polish
# (8 x 97), line search (8 x 3), the main env step (8); and the rollout cell's 2048
CHECK_B = (1024, 776, 24, 8, 2048)
# after 25 control steps (100 substeps) the stiction/contact dynamics amplify
# rounding differences (FMA contraction, summation order); the bounds are ~10x
# the divergence of the same code compiled for the host
DRIFT_ATOL = dict(base_pos=2e-2, base_quat=3e-2, joint_pos=0.1, base_lin_vel=0.1,
                  base_ang_vel=0.5, joint_vel=2.0)


def log(msg):
    print(msg, flush=True)


def phase_done(name, t0):
    now = time.perf_counter()
    log(f"[{name}] {now - t0:.2f} s (total {now - T_START:.1f} s)")
    if now - T_START > TIME_LIMIT_S:
        raise SystemExit(f"chip_smoke: over the {TIME_LIMIT_S:.0f} s limit after phase {name}")


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def main():
    import torch

    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
    from extended_legged_gym_tpu_torch.physics import EnvPhysParams, initial_state, load_model
    from extended_legged_gym_tpu_torch.robots.anymal_c_traj import (
        AnymalCTrajGradSampling, anymal_c_traj_sampling_cfg)
    from extended_legged_gym_tpu_torch.scripts import bench_mpc
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
        if "registers" in line or "spill" in line or "stack frame" in line:
            log(f"ptxas: {line.strip()}")
    phase_done("build", t0)

    # ---------------- 3. kernel against plain ----------------
    t0 = time.perf_counter()
    cfg = anymal_c_traj_sampling_cfg(1)
    model = load_model(cfg.asset.file)
    env_probe = AnymalCTrajGradSampling(cfg, device=dev)
    step = env_probe.decimated_step
    nj, ng, nf = model.nj, model.ng, step.nf

    def near_standing(B, seed):
        rng = np.random.default_rng(seed)
        t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
        st = initial_state(model, B, pos=(0.0, 0.0, 0.54), device=dev)
        st = st.replace(base_pos=st.base_pos + t(0.05 * rng.standard_normal((B, 3))),
                        joint_pos=st.joint_pos + t(0.1 * rng.standard_normal((B, nj))),
                        joint_vel=t(0.5 * rng.standard_normal((B, nj))),
                        base_lin_vel=t(0.3 * rng.standard_normal((B, 3))),
                        base_ang_vel=t(0.3 * rng.standard_normal((B, 3))))
        st = st.replace(contact_anchor=st.base_pos[:, None, :2].expand(B, ng, 2).contiguous())
        ep = EnvPhysParams(t(rng.uniform(0.5, 1.25, B)), t(rng.uniform(-1.0, 1.0, B)))
        return st, ep, t(rng.standard_normal((B, nj)))

    max_err, kernel_stats = 0.0, {}
    for B in CHECK_B:
        st, ep, act = near_standing(B, seed=B)
        sk, tk, rk = step.launch(st, act, ep)
        sp_, tp, rp = step.plain(st, act, ep)
        torch.cuda.synchronize()
        errs = {k: (getattr(sk, k) - getattr(sp_, k)).abs().max().item()
                for k in ONE_STEP_ATOL if k != "foot_pos"}
        errs["foot_pos"] = (rk.foot_pos - rp.foot_pos).abs().max().item()
        errs["tau_last"] = (tk - tp).abs().max().item()
        fz_k, fz_p = rk.geom_forces[..., 2].sum(1), rp.geom_forces[..., 2].sum(1)
        fz_ok = bool(((fz_k - fz_p).abs() <= 30.0 + 0.2 * fz_p.abs()).all())
        log(f"one step B={B}: " + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
            + f" fz_sum_max_diff={(fz_k - fz_p).abs().max().item():.3g} (rtol 0.2, atol 30)")
        for k, tol in ONE_STEP_ATOL.items():
            if not errs[k] <= tol:
                fail(f"kernel vs plain at B={B}: {k} differs by {errs[k]:.3g} > {tol}")
        if not fz_ok:
            fail(f"kernel vs plain at B={B}: vertical geom force sums disagree")
        max_err = max(max_err, *(errs[k] for k in ONE_STEP_ATOL))
        for out in (sk, sp_):
            if not all(torch.isfinite(getattr(out, k)).all() for k in ONE_STEP_ATOL if k != "foot_pos"):
                fail(f"non-finite state after one step at B={B}")
        kms = bench_mpc.cuda_ms(lambda: step.launch(st, act, ep), reps=20, warmup=3)
        pms = bench_mpc.cuda_ms(lambda: step.plain(st, act, ep), reps=3, warmup=1)
        nbytes = 4 * B * (2 * step.NS + 2 * nj + 2 + 3 * ng + 6 * nf) + 4 * (pk.TF_SIZE + pk.TI_SIZE)
        flops = B * pk.control_step_flops(model.nb, nj, ng, nf, step.decimation)
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
        kernel_stats[B] = dict(ms=kms, plain_ms=pms, bound_ms=max(t_bytes, t_ops),
                               bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"B1 at B={B}: kernel {kms:.4f} ms/launch, plain {pms:.3f} ms, bound "
            f"{max(t_bytes, t_ops) * 1e3:.3f} us ({flops:.3g} flop, {nbytes:.3g} bytes)")

    st, ep, act = near_standing(776, seed=7)
    act = 0.2 * act
    sk, sp_ = st, st
    for _ in range(25):
        sk = step.launch(sk, act, ep)[0]
        sp_ = step.plain(sp_, act, ep)[0]
    torch.cuda.synchronize()
    drift = {k: (getattr(sk, k) - getattr(sp_, k)).abs().max().item() for k in DRIFT_ATOL}
    log("drift after 25 control steps B=776: " + " ".join(f"{k}={v:.3g}" for k, v in drift.items()))
    for k, tol in DRIFT_ATOL.items():
        if not drift[k] <= tol:
            fail(f"25-step drift of {k} is {drift[k]:.3g} > {tol}")
    log("no single PyTorch call computes this step; library_ms is null")
    phase_done("kernel vs plain", t0)

    # ---------------- 4. main path ----------------
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
    pk.DecimatedEnvStep.launches = 0
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
    launches = pk.DecimatedEnvStep.launches
    vx, up = torch.stack(vx), torch.stack(up)
    half = n_cycles // 2
    ratio = vx[half:].mean().item() / CMD
    upright = up[half:].mean().item()
    log(f"main path: {n_warm}+{n_cycles} mpc_step cycles, E={E}: achieved/command={ratio:.4f} "
        f"upright_mean={upright:.4f} resets={resets} kernel launches={launches}")
    if launches <= 0:
        fail("the main path launched the physics kernel no time")
    if not (torch.isfinite(vx).all() and torch.isfinite(up).all() and torch.isfinite(nodes).all()):
        fail("non-finite values on the main path")
    if not upright < -0.9:
        fail(f"robots did not stay upright (upright_mean {upright:.3f})")
    phase_done("main path", t0)

    t0 = time.perf_counter()
    solves, _ = bench_mpc.solve_latency(dev, n_solves=15)
    log(f"solve at E=1 (Nsample=127 Hsample=16 Hnode=4 Ndiffuse=2 polish=fd x2): "
        f"p50 {bench_mpc.percentile(solves, 50):.2f} ms, p90 {bench_mpc.percentile(solves, 90):.2f} ms "
        f"over {len(solves)} solves")
    rb_ms, rps = bench_mpc.rollout_throughput(dev, E=16, S=128, H=64)
    log(f"rollout_batch E=16 S=128 H=64: {rb_ms:.1f} ms, {rps:.1f} rollouts/s")
    phase_done("timing", t0)

    # ---------------- 5. result ----------------
    ks = kernel_stats[1024]
    log(json.dumps({"kernels": [{
        "name": "flat_decimated_physics_step", "route": "cuda",
        "source": "extended_legged_gym_tpu_torch/csrc/physics_step.cu",
        "replaces": "extended_legged_gym_tpu/ops/physics_kernel.py:447",
        "launches": launches, "max_abs_err": max_err, "ms": ks["ms"],
        "plain_ms": ks["plain_ms"], "bound_ms": ks["bound_ms"], "bound_by": ks["bound_by"],
        "library_ms": None}]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
