"""CPU tests of the benchmark harness: a small run of each driver on the
program's plain physics, the work counts against hand sums, the metric
readers on a synthetic trace, the plain reference against the program, the
import rules, and a run that must fail for each planted fault.

    python -m pytest benchmark/tests -q -p no:cacheprovider -o addopts=""
"""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import check, flops
from benchmark.run import ROOT, load_cell, make_driver, run_cell
from benchmark.trace import TraceSummary

SMALL = {"train-rough-32k": dict(num_envs=8, check_rows_per_step=4),
         "mpc-e64-s4096": dict(num_envs=2, num_samples=5, check_rows_per_step=4)}
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def small_run(workload, seed=2 ** 31 + 5, traced=False):
    return run_cell(ROOT, workload, seed, 0.2, traced, "cpu", traffic_override=SMALL[workload],
                    log=lambda s: None, t_start=time.perf_counter())


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_small_run_prints_the_contract_line(workload):
    line = small_run(workload)
    assert list(line)[:5] == CONTRACT_KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    want = {m["name"] for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    for name, c in line["checks"].items():
        assert c["limit"] is not None and c["value"] <= c["limit"], name
    json.dumps(line)


def test_traced_small_run_reads_the_host_spans():
    line = small_run("train-rough-32k", traced=True)
    # no device on the CPU: the trace readers find nothing and stay silent
    assert set(line["metrics"]) == {"collect_ms.train", "update_ms.train"}
    assert "breakdown" not in line


def test_work_counts_against_hand_sums():
    # ANYmal-C: 13 bodies, 12 joints, 36 geoms, 4 feet, decimation 4
    per_sub = 13 * 12 + 407 + 129 * 13 + 864 * 12 + 247 * 36
    assert flops.control_step_flops(13, 12, 36, 4, 4) == 4 * per_sub + 4 * 45 + 36 * 76 == 88916
    assert flops.control_step_flops(13, 12, 36, 4, 4, rough=True) == (
        4 * (per_sub + 98 * 36) + 4 * 45 + 36 * 76 + 13 * 36) == 103496
    ns = 13 + 24 + 72
    assert flops.control_step_bytes(12, 36, 4, 4) == 4 * (2 * ns + 24 + 2 + 108 + 24) == 1504
    assert flops.control_step_bytes(12, 36, 4, 4, rough=True) == 1504 + 16 * 36 * 4
    macs = 235 * 512 + 512 * 256 + 256 * 128 + 128 * 12
    assert flops.mlp_flops(235, [512, 256, 128], 12) == 2 * macs + 2 * (512 + 256 + 128) + 12
    fwd = flops.mlp_flops(235, [512, 256, 128], 12) + flops.mlp_flops(235, [512, 256, 128], 1)
    assert flops.ppo_iteration_flops(10, 24, 5, 235, 12, [512, 256, 128]) == fwd * 10 * 25 + (
        3 * fwd * 10 * 24 * 5)


def _load_reader(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(
        ROOT, "benchmark", "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def synthetic_trace():
    s = 1_000_000_000                  # ns
    device = [("void decimated_step_kernel<true>(float)", 0, s // 10),
              ("elementwise_kernel", s // 10, 2 * s // 10),
              ("Memcpy HtoD", 3 * s // 10, 4 * s // 10),
              ("void decimated_step_kernel<false>(float)", 6 * s // 10, 7 * s // 10)]
    ranges = [("window", 0, s), ("collect", 0, 5 * s // 10), ("replan", 5 * s // 10, s),
              ("replan", 8 * s // 10, 9 * s // 10)]
    return TraceSummary(device, ranges)


def test_trace_summary():
    tr = synthetic_trace()
    assert tr.window_s == 1.0 and abs(tr.busy_s - 0.4) < 1e-12
    assert tr.kernel_count() == 3 and tr.range_count("replan") == 2
    assert abs(tr.kernel_seconds(["decimated_step_kernel"]) - 0.2) < 1e-12
    gaps = dict(tr.idle_gaps())
    assert abs(gaps["idle_in_collect"] - 0.1) < 1e-12
    assert abs(gaps["idle_in_replan"] - 0.5) < 1e-12
    assert tr.top_device_ops()[0][1] == pytest.approx(0.1)


def test_metric_readers_on_a_synthetic_trace():
    tr = synthetic_trace()
    ctx = dict(trace=tr, steps=2, window_s=1.0, counters=dict(physics_launches=206.0),
               spans=dict(collection_s=[0.2, 0.4], update_s=[0.1, 0.3], optimize_s=[0.5]),
               work=dict(physics_flops=67e9, physics_bytes=1e6, network_flops=67e10,
                         env_steps=1000, replan_env_steps=10, flops_per_env_step=67e6,
                         bytes_per_env_step=1.0))
    r = {n: _load_reader(n)(ctx) for n in (
        "collect_ms.train", "update_ms.train", "optimize_ms.mpc", "kernels_per_iter.train",
        "kernels_per_step.mpc", "device_idle.train", "device_idle.mpc", "physics_launches.mpc",
        "physics_roofline.train", "physics_roofline.mpc", "mfu.train", "mfu.mpc")}
    assert r["collect_ms.train"] == pytest.approx(300.0)
    assert r["update_ms.train"] == pytest.approx(200.0)
    assert r["optimize_ms.mpc"] == pytest.approx(500.0)
    assert r["kernels_per_iter.train"] == r["kernels_per_step.mpc"] == 1.5
    assert r["device_idle.train"] == r["device_idle.mpc"] == pytest.approx(60.0)
    assert r["physics_launches.mpc"] == 103.0
    # 2 iterations x 67 GFLOP over 67 TFLOP/s = 2 ms, over 0.2 s of the kernel
    assert r["physics_roofline.train"] == pytest.approx(1.0)
    # (2 x 1000 + 2 x 10) env steps x 67 MFLOP / 67 TFLOP/s = 2.02 ms over 0.2 s
    assert r["physics_roofline.mpc"] == pytest.approx(1.01)
    assert r["mfu.train"] == pytest.approx(100.0 * 2 * (67e10 + 67e9) / 67e12)
    assert r["mfu.mpc"] == pytest.approx(100.0 * 2020 * 67e6 / 67e12)
    empty = dict(ctx, trace=None, spans={}, counters={})
    assert all(_load_reader(n)(empty) is None for n in r)


def test_reference_terrain_and_step_match_the_program():
    """The reference's curriculum heightfield is the program's bit for bit."""
    from extended_legged_gym_tpu_torch.envs.legged_robot_config import LeggedRobotCfg
    from extended_legged_gym_tpu_torch.terrain.generator import Terrain
    from benchmark.reference.terrain import curriculum_ground

    _, _, config, _ = load_cell(ROOT, "train-rough-32k")
    tc = LeggedRobotCfg().terrain
    for k, v in config["terrain"].items():
        setattr(tc, k, v)
    seed = 12345
    prog = Terrain(tc, 16, seed=seed).to_device(tc.static_friction)
    ref = curriculum_ground(config["terrain"], seed)
    assert np.array_equal(prog.height, ref.height)
    assert (prog.hscale, prog.origin) == (ref.hscale, ref.origin)


def test_reference_ppo_init_matches_the_program():
    from extended_legged_gym_tpu_torch.models.networks import ActorCritic
    from benchmark.reference.ppo import init_params

    net = ActorCritic(235, 12, generator=torch.Generator().manual_seed(99))
    ref = init_params(235, 12, [512, 256, 128], 1.0, 99)
    prog = dict(net.named_parameters())
    assert list(prog) == list(ref)
    assert all(torch.equal(prog[k].detach(), ref[k]) for k in ref)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    base = os.path.join(ROOT, "benchmark", sub)
    for d, _, files in os.walk(base):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & {"jax", "jaxlib", "flax", "extended_legged_gym_tpu"}
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "extended_legged_gym_tpu_torch" not in set(_imports(path)), path


def test_without_a_card_the_run_fails_and_prints_nothing():
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "train-rough-32k", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_checkout_of_only_the_benchmark_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "train-rough-32k", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


# ------------------------------------------------------------ planted faults
def _half_loss(orig):
    def loss(cfg, mean, std, value, mb):
        n = mean.shape[0] // 2
        return orig(cfg, mean[:n], std, value[:n], {k: v[:n] for k, v in mb.items()})
    return loss


def _unchanged_update(orig):
    def update(m, s, r):
        return m
    return update


def _half_update(orig):
    def update(m, s, r):
        n = s.shape[1] // 2
        return orig(m, s[:, :n], r[:, :n])
    return update


def _patch_sampler_update(monkeypatch, make):
    from extended_legged_gym_tpu_torch.trajopt import sampling

    init = sampling.TrajGradSampling.__init__

    def patched(self, *a, **kw):
        init(self, *a, **kw)
        self.update_fn = make(self.update_fn)
    monkeypatch.setattr(sampling.TrajGradSampling, "__init__", patched)


def _altered_reward(monkeypatch):
    from extended_legged_gym_tpu_torch.envs.batch_rollout import RobotBatchRollout

    orig = RobotBatchRollout._compute_rollout_reward

    def altered(self, rs):
        rs, rew = orig(self, rs)
        return rs, rew + 0.1
    monkeypatch.setattr(RobotBatchRollout, "_compute_rollout_reward", altered)


@pytest.mark.parametrize("fault", ["train-unchanged", "train-half", "mpc-unchanged", "mpc-half",
                                   "mpc-altered"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    from extended_legged_gym_tpu_torch.rl import ppo

    if fault == "train-unchanged":
        monkeypatch.setattr(ppo.Adam, "step", lambda self, grads, lr, ok: None)
    elif fault == "train-half":
        monkeypatch.setattr(ppo, "_ppo_loss", _half_loss(ppo._ppo_loss))
    elif fault == "mpc-unchanged":
        _patch_sampler_update(monkeypatch, _unchanged_update)
    elif fault == "mpc-half":
        _patch_sampler_update(monkeypatch, _half_update)
    else:
        _altered_reward(monkeypatch)
    line = small_run("train-rough-32k" if fault.startswith("train") else "mpc-e64-s4096")
    assert line["correct"] is False, line["checks"]


# ------------------------------------------------------------ on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control computes its matrix products in TF32")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_control_is_not_correct(workload, card):
    """The reference in the program's place, its matrix products in TF32,
    fails at least one of the cell's limits; the program passes them."""
    _, _, config, traffic = load_cell(ROOT, workload)
    over = dict(SMALL[workload], num_envs=256) if workload.startswith("train") else dict(
        SMALL[workload], num_envs=4, num_samples=255)
    drv = make_driver(ROOT, config, dict(traffic, **over), 2 ** 31 + 11, card)
    drv.setup()
    drv.release()
    limits = check.load_limits(ROOT, workload)
    assert check.judge(drv.numbers(drv.candidate("program")), limits)
    assert not check.judge(drv.numbers(drv.candidate("control")), limits)


# ------------------------------------------------------------ across cards
@pytest.mark.parametrize("fault", ["", "exchange", "unchanged", "half"])
def test_data_parallel_cell_on_four_cpu_processes(fault):
    """``train-rough-dp4`` at 4 envs per rank over gloo: the ranks' shared
    update matches the reference's, and with the reductions left out, no
    step applied or half of each minibatch left out it does not."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
                           "--nproc_per_node", "4", "--master_addr", "127.0.0.1",
                           "--master_port", str(port), "-m", "benchmark.tests.dp_worker",
                           "--fault", fault], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["device"]["count"] == 4
    assert line["correct"] is (fault == ""), line["checks"]


def test_allreduce_reader():
    s = 1_000_000_000
    tr = TraceSummary([("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", 0, s // 100),
                       ("ncclDevKernel_Broadcast_RING_LL(x)", s // 10, 2 * s // 10)],
                      [("window", 0, s)])
    read = _load_reader("allreduce_ms.dp")
    assert read(dict(trace=tr, steps=2)) == pytest.approx(5.0)
    assert read(dict(trace=synthetic_trace(), steps=2)) is None
