"""The port must run where JAX is not installed: every module of
extended_legged_gym_tpu_torch (the rough-terrain modules, the PPO runner, the
task registry, the perception modules, the terrain estimator and
distillation modules and the train, eval, estimator and evidence scripts
among them), and chip_smoke.py, import with jax, jaxlib, flax, optax and the
JAX package blocked, and the committed warm-start, rough-terrain,
flat-training and ray-observation checkpoints (whose optimizer states pickle
optax objects) load, the flat one into the port's runner and the ray one into
a policy that acts on the ray task's 267-dim observation; the committed JAX
terrain estimator loads into the port's estimator and predicts the ray task's
32 distances, and the warm-start checkpoint's actor loads into a
student-teacher pair as its teacher; the actuator network, RND and the
recurrent policy modules import, the committed SEA and ElSpider checkpoints
load into their tasks' runners, and the SEA env steps; the small SPD solves,
the dynamics, the Franka and the CyberDog2 modules import and the
fixed-base Franka env and the CyberDog2 walk env step."""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = "logs/flat_anymal_c/Aug21_12-38-39_r5_ft4/model_final.pkl"
ROUGH_CKPT = "logs/rough_anymal_c/Aug21_13-00-24_r5_rough3/model_final.pkl"
FLAT_CKPT = "logs/flat_anymal_c/Aug21_16-29-23_r5_scratch/model_final.pkl"
RAY_CKPT = "logs/rough_raycast_anymal_c/Aug21_13-41-24_r5_rayc/model_final.pkl"
ESTIMATOR = "logs/terrain_estimator/anymal_c_rough_raycast/estimator_final.pkl"
SEA_CKPT = "logs/flat_sea_anymal_c/Aug21_07-18-55_r4_sea2/model_final.pkl"
ELSPIDER_CKPT = "logs/flat_elspider_air/Aug21_04-21-51_r4b/model_final.pkl"

SCRIPT = textwrap.dedent(f"""
    import importlib, importlib.abc, pkgutil, sys
    BLOCKED = {{"jax", "jaxlib", "flax", "optax", "extended_legged_gym_tpu"}}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {{name}}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, {ROOT!r})
    import extended_legged_gym_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for n in names:
        importlib.import_module(n)
    import chip_smoke
    from extended_legged_gym_tpu_torch.models.networks import ActorCritic, load_jax_checkpoint
    sd, _ = load_jax_checkpoint({CKPT!r})
    net = ActorCritic(48, 12, (128, 64, 32), (128, 64, 32))
    net.load_state_dict(sd)
    from extended_legged_gym_tpu_torch.scripts.eval_rough import load_policy
    for m in ("terrain.generator", "robots.anymal_c", "scripts.eval_rough", "rl.ppo",
              "rl.runner", "utils.task_registry", "utils.metrics", "scripts.train",
              "scripts.eval_policy", "scripts.record_training", "perception.patterns",
              "perception.raycast", "perception.depth_camera", "scripts.eval_raycast",
              "models.depth_backbone", "models.terrain_estimator", "models.student_teacher",
              "rl.terrain_estimator_runner", "rl.distillation", "rl.distillation_runner",
              "scripts.terrain_est_train", "scripts.terrain_est_play",
              "scripts.estimator_closed_loop", "scripts.evidence_artifacts",
              "models.actuator_net", "models.rnd", "robots.elspider_air", "scripts.bench_train",
              "scripts.bench_kernel", "ops.linalg", "physics.dynamics", "robots.franka",
              "robots.task_variants", "robots.cyberdog2", "robots.cyberdog2_standdance",
              "robots.cyberdog2_walk", "scripts.record_franka"):
        assert pkg.__name__ + "." + m in names, m
    from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner
    from extended_legged_gym_tpu_torch.utils.task_registry import get_args, task_registry
    env, _ = task_registry.make_env("anymal_c_flat", get_args(argv=["--num_envs", "2"]),
                                    device="cpu")
    runner, _ = task_registry.make_alg_runner(env, "anymal_c_flat", log_root="unused")
    assert runner.load({FLAT_CKPT!r})["iteration"] == 2000
    import torch
    for task, ckpt in (("anymal_c_flat_sea", {SEA_CKPT!r}), ("elspider_air_flat", {ELSPIDER_CKPT!r})):
        env, _ = task_registry.make_env(task, get_args(argv=["--num_envs", "2"]), device="cpu")
        runner, _ = task_registry.make_alg_runner(env, task, log_root="unused")
        runner.load(ckpt)
        s = env.step(env.reset_all(seed=0), runner.get_inference_policy()(env.reset_all(seed=0).obs))
        assert bool(torch.isfinite(s.obs).all()), task
    assert env.num_actions == 18
    env, _ = task_registry.make_env("franka", get_args(argv=["--num_envs", "2"]), device="cpu")
    s = env.step(env.reset_all(seed=0), torch.zeros(2, 7))
    assert env.model.fix_base and bool(torch.isfinite(s.obs).all())
    env, _ = task_registry.make_env("cyber2_walk", get_args(argv=["--num_envs", "2"]), device="cpu")
    s = env.step(env.reset_all(seed=0), torch.zeros(2, 12))
    assert s.obs.shape == (2, 141) and bool(torch.isfinite(s.obs).all())
    rough = load_policy({ROUGH_CKPT!r}, 235, 12, "cpu")(torch.zeros(1, 235))
    ray = load_policy({RAY_CKPT!r}, 267, 12, "cpu")(torch.zeros(1, 267))
    from extended_legged_gym_tpu_torch.models.networks import read_checkpoint
    from extended_legged_gym_tpu_torch.models.student_teacher import (
        StudentTeacher, load_teacher_from_actor_critic)
    from extended_legged_gym_tpu_torch.models.terrain_estimator import (
        TerrainEstimator, estimator_params_from_jax)
    est = estimator_params_from_jax(TerrainEstimator(32, 9, (16, 32)),
                                    read_checkpoint({ESTIMATOR!r})["params"])
    pred, _ = est(torch.zeros(2, 16, 32), torch.zeros(2, 9), est.initialize_carry((2,)))
    st = StudentTeacher(48, 48, 12, teacher_hidden_dims=(128, 64, 32))
    st = load_teacher_from_actor_critic(st, read_checkpoint({CKPT!r})["params"])
    assert torch.equal(st.evaluate_teacher(torch.ones(3, 48)), net.act_inference(torch.ones(3, 48)))
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("imported", len(names), "modules; actor", tuple(sd["actor.0.weight"].shape),
          "rough actions", tuple(rough.shape), "ray actions", tuple(ray.shape),
          "estimated rays", tuple(pred.shape))
""")


def test_port_imports_and_loads_checkpoint_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "actor (128, 48)" in proc.stdout and "rough actions (1, 12)" in proc.stdout
    assert "ray actions (1, 12)" in proc.stdout and "estimated rays (2, 32)" in proc.stdout
    n = int(proc.stdout.split("imported ")[1].split()[0])
    assert n >= 65


def test_chip_smoke_refuses_without_cuda():
    """Without a CUDA card, chip_smoke.py exits non-zero and prints no
    result line; with a card the test skips."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
