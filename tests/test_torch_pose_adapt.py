"""Base-pose adaptation (envs/pose_adapt.py) against the JAX package.

Mirrors tests/test_pose_adapt.py on the port (the observation layout,
finite steps with contacts that resist the ground, forward tracking, the
wrench caps, the spawn clearance, the conformity term, the composite body),
then holds the port to the JAX env: the composite rigid body to 1e-6
relative, the spawn origins bit for bit for a seed, and N control steps of
``anymal_c_base_pose_adapt`` (mesh contacts) and ``el_mini_base_pose_ctrl``
from the same reset with the JAX draws (spawn jitter and yaw, commands,
pushes) injected; resampling, pushes and time-outs fire every few steps.
Poses to 1e-4, velocities to 1e-3, observations and rewards to 1e-3 (the
contact forces of the stiff penalty model amplify float32 rounding)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.envs.legged_robot_config import TerrainCfg as JTerrainCfg
from extended_legged_gym_tpu.envs.pose_adapt import BasePoseAdapt as JBasePoseAdapt
from extended_legged_gym_tpu.envs.pose_adapt import BasePoseAdaptCfg as JBasePoseAdaptCfg
from extended_legged_gym_tpu.physics.model import composite_rigid_body as jcomposite
from extended_legged_gym_tpu.physics.serialize import load_model as jload_model
from extended_legged_gym_tpu.robots import task_registry as jtask_registry
from extended_legged_gym_tpu.terrain.confined import TerrainConfined as JTerrainConfined
from extended_legged_gym_tpu_torch import robots  # noqa: F401
from extended_legged_gym_tpu_torch.envs.legged_robot_config import TerrainCfg
from extended_legged_gym_tpu_torch.envs.pose_adapt import BasePoseAdapt, BasePoseAdaptCfg
from extended_legged_gym_tpu_torch.physics.model import composite_rigid_body
from extended_legged_gym_tpu_torch.physics.serialize import load_model
from extended_legged_gym_tpu_torch.terrain.confined import TerrainConfined
from extended_legged_gym_tpu_torch.terrain.heightfield import sample_height
from extended_legged_gym_tpu_torch.utils.task_registry import task_registry
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

N_STEPS = 8


def _terrain(n, cls=TerrainConfined, cfg_cls=TerrainCfg, **kw):
    tc = cfg_cls()
    tc.num_rows = tc.num_cols = 2
    tc.terrain_length = tc.terrain_width = 4.0
    tc.border_size = 2.0
    return cls(tc, n, seed=0).to_device(attach_trimesh=False, **kw)


def _env(n=4, **overrides):
    cfg = BasePoseAdaptCfg()
    cfg.env.num_envs = n
    cfg.raycaster.ray_pattern = "spherical"
    cfg.raycaster.spherical_num_azimuth = 8
    cfg.raycaster.spherical_num_elevation = 4
    cfg.raycaster.max_distance = 4.0
    for k, v in overrides.items():
        obj = cfg
        for p in k.split(".")[:-1]:
            obj = getattr(obj, p)
        setattr(obj, k.split(".")[-1], v)
    return BasePoseAdapt(cfg, _terrain(n), device="cpu")


def test_obs_layout_is_derived():
    env = _env()
    assert env.num_obs == env.num_rays + 5 + 3
    s = env.reset_all(seed=0)
    assert s.obs.shape == (4, env.num_obs) and bool(torch.isfinite(s.obs).all())


def test_steps_finite_and_contact_resists_ground():
    env = _env()
    s = env.reset_all(seed=0)
    gen = torch.Generator().manual_seed(0)
    for _ in range(30):
        s = env.step(s, 0.3 * torch.randn(4, 6, generator=gen))
    assert bool(torch.isfinite(s.obs).all()) and bool(torch.isfinite(s.rew).all())
    ground = sample_height(env.terrain, s.pos[:, :2])
    assert bool((s.pos[:, 2] >= ground - 0.05).all())


def test_velocity_actions_track_forward():
    env = _env(**{"domain_rand.push_robots": False, "domain_rand.randomize_init_yaw": False})
    s = env.reset_all(seed=1)
    x0 = s.pos[:, 0].clone()
    a = torch.zeros(4, 6)
    a[:, 0] = 0.5
    for _ in range(60):
        s = env.step(s, a)
    assert bool((s.pos[:, 0] > x0 + 0.3).all())


def test_wrench_caps_hold():
    env = _env(**{"domain_rand.push_robots": False})
    s = env.step(env.reset_all(seed=2), torch.full((4, 6), 100.0))
    vmax = env.cfg.control.max_force / env.mass * env.dt + 1e-3
    assert bool((torch.linalg.norm(s.lin_vel, dim=-1) <= 3 * vmax).all())


def test_origins_have_clearance():
    env = _env()
    t = env.terrain
    ground, ceiling = np.asarray(t.height), np.asarray(t.ceiling)
    hs, (ox, oy) = float(t.hscale), (float(t.origin[0]), float(t.origin[1]))
    gi = np.clip(((env.origins[:, 0] - ox) / hs).astype(int), 0, ground.shape[0] - 1)
    gj = np.clip(((env.origins[:, 1] - oy) / hs).astype(int), 0, ground.shape[1] - 1)
    need = env.nominal_height * env.cfg.origins.height_clearance_factor
    assert (ceiling[gi, gj] - ground[gi, gj] >= need - 1e-6).all()


def test_conformity_prefers_nominal_height():
    env = _env(**{"domain_rand.push_robots": False})
    s = env.reset_all(seed=3)
    ground = sample_height(env.terrain, s.pos[:, :2])
    pos = s.pos.clone()
    pos[0, 2] = ground[0] + env.nominal_height
    pos[1, 2] = ground[1] + 4.0 * env.nominal_height
    s = env._update_percept(s.replace(pos=pos, quat=torch.tensor([0.0, 0, 0, 1]).repeat(4, 1)))
    rc = env.cfg.rewards
    rc.collision_penalty = rc.orientation_penalty = rc.lin_vel_tracking = 0.0
    rc.ang_vel_tracking = rc.downward_vel_reward = 0.0
    r = env._reward(s)
    assert float(r[0]) > float(r[1])


@pytest.mark.parametrize("robot", ["anymal_c", "elspider_air"])
def test_composite_rigid_body_matches_jax(robot):
    path = f"extended_legged_gym_tpu/robots/data/{robot}.json"
    for got, want in zip(composite_rigid_body(load_model(path)), jcomposite(jload_model(path))):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_origins_bit_identical_to_jax():
    """The rejection sampler on the same confined grid, seed 1 and seed 7."""
    for seed in (1, 7):
        cfg, jcfg = BasePoseAdaptCfg(), JBasePoseAdaptCfg()
        for c in (cfg, jcfg):
            c.env.num_envs, c.seed = 64, seed
            c.raycaster.spherical_num_azimuth, c.raycaster.spherical_num_elevation = 4, 2
        env = BasePoseAdapt(cfg, _terrain(64), device="cpu")
        jenv = JBasePoseAdapt(jcfg, _terrain(64, JTerrainConfined, JTerrainCfg))
        np.testing.assert_array_equal(env.origins, jenv.origins)


def _jax_draws(jenv, key):
    """The draws of one JAX step from ``key`` (envs/pose_adapt.py:399-420,
    :534-538): (resampled commands, push, spawn pose, reset commands)."""
    B, m = jenv.num_envs, jenv.cfg.domain_rand.max_push_vel_xy
    key, k_cmd, k_push = jax.random.split(key, 3)
    push = jax.random.uniform(k_push, (B, 2), minval=-m, maxval=m)
    _, k1, k2 = jax.random.split(key, 3)
    return (jenv._sample_commands(k_cmd, B), push, jenv._spawn(k1, B),
            jenv._sample_commands(k2, B))


def _inject(env, commands, pushes, spawns):
    t = lambda x: torch.as_tensor(np.array(x))
    env._draw_commands = lambda: t(commands.pop(0))
    env._draw_push = lambda: t(pushes.pop(0))
    env._draw_spawn = lambda: tuple(t(x) for x in spawns.pop(0))


@pytest.mark.parametrize("task", ["anymal_c_base_pose_adapt", "el_mini_base_pose_ctrl"])
def test_steps_match_jax_with_draws_injected(task):
    jcfg, _ = jtask_registry.get_cfgs(task)
    cfg, _ = task_registry.get_cfgs(task)
    for c in (cfg, jcfg):
        c.env.num_envs = 4
        c.env.episode_length_s = 0.125            # time-outs after 5 steps
        c.commands.resampling_time = 0.05         # resampling every 2 steps
        c.domain_rand.push_interval_s = 0.075     # pushes every 3 steps
    jenv = jtask_registry.task_classes[task](jcfg)
    env, _ = task_registry.make_env(task, env_cfg=cfg, device="cpu")
    assert env.terrain.contact_trimesh and jenv.terrain.contact_trimesh
    np.testing.assert_array_equal(env.origins, jenv.origins)
    np.testing.assert_allclose(env.mass, jenv.mass, rtol=1e-6)

    key = jax.random.PRNGKey(0)
    js = jenv.reset_all(key)
    k1, k2, _ = jax.random.split(key, 3)
    _inject(env, [jenv._sample_commands(k2, 4)], [], [jenv._spawn(k1, 4)])
    s = env.reset_all()
    step, draws = jax.jit(jenv.step), jax.jit(lambda k: _jax_draws(jenv, k))
    actions = np.random.default_rng(0).uniform(-1.0, 1.0, (N_STEPS, 4, 6)).astype(np.float32)
    resets = 0
    for i in range(N_STEPS):
        cmd, push, spawn, cmd2 = draws(js.key)
        _inject(env, [cmd, cmd2], [push], [spawn])
        js = step(js, jnp.asarray(actions[i]))
        s = env.step(s, torch.as_tensor(actions[i]))
        resets += int(np.asarray(js.reset_buf).sum())
        for k, tol in (("pos", 1e-4), ("quat", 1e-4), ("lin_vel", 1e-3), ("ang_vel", 1e-3),
                       ("commands", 0.0), ("obs", 1e-3), ("rew", 1e-3),
                       ("base_contact_force", 1e-2)):
            np.testing.assert_allclose(getattr(s, k).numpy(), np.asarray(getattr(js, k)),
                                       atol=tol, err_msg=f"{task} step {i} {k}")
        np.testing.assert_array_equal(s.reset_buf.numpy(), np.asarray(js.reset_buf))
        np.testing.assert_array_equal(s.episode_length.numpy(), np.asarray(js.episode_length))
    assert resets > 0
    for k in ("count", "return_sum", "length_sum"):
        np.testing.assert_allclose(s.episode_metrics[k].item(),
                                   float(js.episode_metrics[k]), rtol=1e-4, err_msg=k)
