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
fixed-base Franka env and the CyberDog2 walk env step; the A1, Go2, ANYmal-B,
Cassie, ANYmal-C variant modules, the random walker and the Raibert planners
import, and every task of the LeggedRobot family and its variants steps (the
rough ones on a 2 x 2 grid); the triangle-mesh, SDF, confined, OBJ,
obstacle and stone modules and the percept, navigation and planning envs
import, and each of the 11 tasks they add steps (the confined arenas on the
engine route, 2 x 2 grids of 4 m); the iLQR, pose-adapt and gait-scheduler
modules import, a differentiable rollout and a one-iteration iLQR polish
run on the MPC task, the ElSpider MPC task's gait-scheduler rewards and an
el_mini_base_pose_ctrl env step, the registry holding all 59 tasks; the URDF,
reference-checkpoint, export, plot-logger, replay and torch.distributed
modules and the play, weak-scaling, parity and model-extraction scripts
import, the process joins no group where there is none to join, and the
flat runner exports its TorchScript and torch.export files; the metrics
writer's TensorBoard sink writes an event file, the quaternion, random and
spline helpers run, the actuator network's weights go through extract, save
and load into a network that acts, and the flat env steps with the CRBA
solver, an armature and the velocity limits off."""
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
              "robots.cyberdog2_walk", "scripts.record_franka", "robots.a1", "robots.go2",
              "robots.anymal_b", "robots.cassie", "robots.anymal_c_variants",
              "utils.random_walker", "utils.raibert_planner", "perception.trimesh",
              "perception.sdf", "terrain.confined", "terrain.mesh", "terrain.obstacles",
              "terrain.dynamic_obstacles", "envs.percept", "envs.navigation", "envs.plan_grad",
              "trajopt.riccati", "envs.pose_adapt", "utils.gait_scheduler", "physics.urdf",
              "rl.torch_compat", "utils.export", "utils.plot_logger", "utils.replay",
              "parallel", "parallel.distributed", "parallel.mesh", "scripts.play",
              "scripts.weak_scaling", "scripts.eval_parity", "scripts.diag_parity",
              "scripts.compare_reference_reward", "scripts.extract_robot_models",
              "scripts.dryrun_multichip"):
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
    for task in ("a1", "a1_flat", "go2_rough", "go2_flat", "anymal_b", "cassie",
                 "elspider_air_rough", "anymal_c_rough_teacher", "load_adapt_anymal_c",
                 "pose_anymal_c", "stand_anymal_c", "anymal_c_student", "pose_go2_flat",
                 "load_adapt_go2_flat", "stand_go2_flat", "pose_elspider_air_flat",
                 "foot_track_elspider_air_flat", "foot_track_elspider_air_hang"):
        cfg, _ = task_registry.get_cfgs(task)
        cfg.env.num_envs = 2
        cfg.terrain.num_rows = cfg.terrain.num_cols = 2
        cfg.terrain.terrain_length = cfg.terrain.terrain_width = 4.0
        env, _ = task_registry.make_env(task, env_cfg=cfg, device="cpu")
        s = env.step(env.reset_all(seed=0), torch.zeros(2, env.num_actions))
        assert bool(torch.isfinite(s.obs).all()) and bool(torch.isfinite(s.rew).all()), task
    for task in ("anymal_c_flat_obstacles", "anymal_c_nav_barrier", "anymal_c_plan_grad_sampling",
                 "anymal_c_percept", "anymal_c_nav", "anymal_c_timberpile_nav",
                 "elspider_air_plan_grad_sampling", "elspider_air_rough_raycast",
                 "elspider_air_nav", "elair_barrier_nav", "elair_timberpile_nav"):
        cfg, _ = task_registry.get_cfgs(task)
        cfg.env.num_envs = 2
        cfg.terrain.num_rows = cfg.terrain.num_cols = 2
        cfg.terrain.terrain_length = cfg.terrain.terrain_width = 4.0
        env, _ = task_registry.make_env(task, env_cfg=cfg, device="cpu")
        s = env.step(env.reset_all(seed=0), torch.zeros(2, env.num_actions))
        assert bool(torch.isfinite(s.obs).all()) and bool(torch.isfinite(s.rew).all()), task
        assert (env.engine_step is not None) == (task in {
            "anymal_c_timberpile_nav", "elair_barrier_nav", "elair_timberpile_nav"}), task
    cfg, _ = task_registry.get_cfgs("anymal_c_traj_grad_sampling")
    to = cfg.trajectory_opt
    to.num_samples, to.horizon_samples, to.horizon_nodes, to.polish_method = 2, 2, 1, "ilqr"
    env, _ = task_registry.make_env("anymal_c_traj_grad_sampling", env_cfg=cfg, device="cpu")
    nodes, info = env.optimize_all_trajectories(env.reset_all(seed=0), torch.zeros(1, 2, 12),
                                                n_diffuse=1)
    assert bool(torch.isfinite(nodes).all()) and float(info["polish_gain"]) >= 0.0
    for task in ("elspider_air_traj_grad_sampling", "el_mini_base_pose_ctrl"):
        cfg, _ = task_registry.get_cfgs(task)
        cfg.env.num_envs = 2
        env, _ = task_registry.make_env(task, env_cfg=cfg, device="cpu")
        s = env.step(env.reset_all(seed=0), torch.zeros(2, env.num_actions))
        assert bool(torch.isfinite(s.obs).all()) and bool(torch.isfinite(s.rew).all()), task
    assert len(task_registry.task_classes) == 59
    import tempfile
    from extended_legged_gym_tpu_torch.parallel.distributed import init_multi_host
    assert init_multi_host(device="cpu")["process_count"] == 1
    env, _ = task_registry.make_env("anymal_c_flat", get_args(argv=["--num_envs", "2"]),
                                    device="cpu")
    runner, _ = task_registry.make_alg_runner(env, "anymal_c_flat", log_root="unused")
    with tempfile.TemporaryDirectory() as d:
        files = runner.export_policy(d)
        assert [f.rsplit("/", 1)[1] for f in files] == ["policy_1.pt", "policy.pt2"]
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
    import os
    from extended_legged_gym_tpu_torch.utils.metrics import MetricsWriter
    with tempfile.TemporaryDirectory() as d:
        w = MetricsWriter(d, backend="tensorboard")
        w.write(0, {{"a": 1.0}})
        assert type(w.tb).__name__ == "SummaryWriter"
        w.close()
        assert any(f.startswith("events.out.tfevents") for f in os.listdir(d))
    from extended_legged_gym_tpu_torch.utils import math as m
    g = torch.Generator().manual_seed(0)
    q = m.ypr_to_quat(torch.tensor([0.3]), torch.tensor([0.2]), torch.tensor([0.1]))
    assert abs(float(m.quat_to_ypr(q)[0][0]) - 0.3) < 1e-5
    assert float(m.quat_box_minus(q, m.quat_identity((1,))).norm()) > 0.3
    assert float(m.torch_rand_sqrt_float(g, -1.0, 1.0, (8,)).abs().max()) <= 1.0
    assert m.uniform(g, 0.0, 1.0, (2, 3)).shape == (2, 3)
    assert m.spline_interp_matrix(4, 16, device="cpu").shape == (16, 4)
    assert m.cubic_hermite_evaluate(torch.ones(4, 2), [0.0, 1.0]).shape == (2, 2)
    assert m.linear_evaluate(torch.ones(2, 2), [0.5]).shape == (1, 2)
    from torch import nn
    from extended_legged_gym_tpu_torch.models import actuator_net as an

    class Sea(nn.Module):
        def __init__(self):
            super().__init__()
            self.lstm = nn.LSTM(2, 4, num_layers=2, batch_first=True)
            self.linear = nn.Linear(4, 1)
            self.register_buffer("in_scale", torch.tensor([2.0, 0.25]))
            self.register_buffer("out_scale", torch.tensor(20.0))

        def forward(self, x):
            return self.linear(self.lstm(x * self.in_scale)[0]) * self.out_scale

    with tempfile.TemporaryDirectory() as d:
        torch.jit.save(torch.jit.trace(Sea(), torch.ones(1, 1, 2)), d + "/sea.pt")
        an.save_weights_json(an.extract_weights(d + "/sea.pt"), d + "/sea.json")
        sea = an.ActuatorNetLSTM(an.load_weights_json(d + "/sea.json", device="cpu"))
        tau, _ = sea(torch.ones(3, 12, 2), sea.init_hidden((3, 12)))
        assert tau.shape == (3, 12) and bool(torch.isfinite(tau).all())
    cfg, _ = task_registry.get_cfgs("anymal_c_flat")
    cfg.env.num_envs = 2
    cfg.sim.solver, cfg.asset.armature, cfg.sim.enforce_dof_vel_limits = "crba", 0.05, False
    env, _ = task_registry.make_env("anymal_c_flat", env_cfg=cfg, device="cpu")
    s = env.step(env.reset_all(seed=0), torch.zeros(2, 12))
    assert env.engine_step is not None and bool(torch.isfinite(s.obs).all())
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
    assert n >= 88


def test_chip_smoke_refuses_without_cuda():
    """Without a CUDA card, chip_smoke.py exits non-zero and prints no
    result line; with a card the test skips."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
