"""The navigation, kinematic-planning and perception envs against the JAX
package (mirrors tests/test_nav_plan_percept.py), and the registry's 59
tasks.

Nav commands to 1e-5 (the goal teleport makes them vanish to 1e-5), a nav
step of ``anymal_c_nav``, ``elspider_air_nav`` and ``anymal_c_nav_barrier``
(B2's plain step on a 2 x 2 grid) from the JAX reset state: states to 5e-3,
observations to 1e-2, rewards to 1e-3 (tests/test_torch_env.py's).  The
planning rollouts (E=2, S=4, H=9, Euler and RK4) to 1e-4 in rewards, the
kinematic main step to 1e-5 in poses.  The percept observation (rays and
the SDF of the base and shanks) and its ``sdf_clearance`` term to 1e-4
(tests/test_torch_percept_tasks.py steps the spherical-ray tasks).  Every
task builds at 2 envs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.envs.percept import RobotBatchRolloutPercept as JPercept
from extended_legged_gym_tpu.envs.percept import RobotPerceptCfg as JPerceptCfg
from extended_legged_gym_tpu.robots import task_registry as jtask_registry
from extended_legged_gym_tpu.robots.anymal_c_traj import anymal_c_traj_sampling_cfg as jtraj_cfg
from extended_legged_gym_tpu.utils.config import class_to_dict as jclass_to_dict
from extended_legged_gym_tpu_torch import robots  # noqa: F401
from extended_legged_gym_tpu_torch.envs.percept import RobotBatchRolloutPercept, RobotPerceptCfg
from extended_legged_gym_tpu_torch.robots.anymal_c_traj import anymal_c_traj_sampling_cfg
from extended_legged_gym_tpu_torch.robots.task_variants import _copy_sections
from extended_legged_gym_tpu_torch.utils.config import class_to_dict
from extended_legged_gym_tpu_torch.utils.task_registry import task_registry
from torch_family import small, to_port
from torch_parity import PHYS, one_torch_thread  # noqa: F401 (autouse)

E = 2
NEW_TASKS = ("anymal_c_flat_obstacles", "anymal_c_nav_barrier", "anymal_c_plan_grad_sampling",
             "anymal_c_percept", "anymal_c_nav", "anymal_c_timberpile_nav",
             "elspider_air_plan_grad_sampling", "elspider_air_rough_raycast", "elspider_air_nav",
             "elair_barrier_nav", "elair_timberpile_nav")


def shrink(cfg, n=E):
    small(cfg, n)
    if hasattr(cfg, "trajectory_opt"):
        cfg.trajectory_opt.num_samples, cfg.trajectory_opt.horizon_samples = 3, 3
    return cfg


def task_pair(task, n=E):
    """(JAX env on its ABA solver, port env on the CPU) of ``task`` at ``n``
    envs (a 2 x 2 grid of 4 m subterrains where it has one)."""
    jcfg = shrink(jtask_registry.get_cfgs(task)[0], n)
    jcfg.sim.solver = "aba"
    cfg = shrink(task_registry.get_cfgs(task)[0], n)
    env, _ = task_registry.make_env(task, env_cfg=cfg, device="cpu")
    return jtask_registry.task_classes[task](jcfg), env


def assert_step_matches(jenv, env, js, actions, err=""):
    js2 = jax.jit(jenv.step)(js, jnp.asarray(actions))
    s2 = env.step(to_port(js), torch.as_tensor(actions))
    for name in PHYS:
        np.testing.assert_allclose(getattr(s2.phys, name).numpy(),
                                   np.asarray(getattr(js2.phys, name)), atol=5e-3,
                                   err_msg=f"{err} {name}")
    np.testing.assert_allclose(s2.obs.numpy(), np.asarray(js2.obs), atol=1e-2, err_msg=err)
    np.testing.assert_allclose(s2.rew.numpy(), np.asarray(js2.rew), atol=1e-3, err_msg=err)
    np.testing.assert_allclose(s2.commands.numpy(), np.asarray(js2.commands), atol=1e-5)
    return js2, s2


def test_registry_holds_the_new_tasks():
    assert len(task_registry.task_classes) == 59
    assert set(NEW_TASKS) <= set(task_registry.task_classes) <= set(jtask_registry.task_classes)
    for task in NEW_TASKS:
        assert (task_registry.task_classes[task].__name__
                == jtask_registry.task_classes[task].__name__), task
        cfg, _ = task_registry.get_cfgs(task)
        jcfg, _ = jtask_registry.get_cfgs(task)
        for sec in ("env", "terrain", "control", "commands", "obstacle_gen", "rewards"):
            ours, theirs = class_to_dict(getattr(cfg, sec)), jclass_to_dict(getattr(jcfg, sec))
            assert {k: v for k, v in ours.items() if k in theirs} == \
                {k: theirs[k] for k in ours if k in theirs}, (task, sec)


@pytest.mark.parametrize("task", NEW_TASKS)
def test_every_new_task_builds_and_steps(task):
    cfg = shrink(task_registry.get_cfgs(task)[0])
    env, _ = task_registry.make_env(task, env_cfg=cfg, device="cpu")
    s = env.step(env.reset_all(seed=0), torch.zeros(E, env.num_actions))
    assert bool(torch.isfinite(s.obs).all()) and bool(torch.isfinite(s.rew).all())


def test_nav_commands_point_to_the_goal():
    jenv, env = task_pair("anymal_c_nav")
    js = jenv.reset_all(jax.random.PRNGKey(0))
    js = js.replace(commands=js.commands.at[:, :3].set(jnp.array([[0.2, -0.1, 0.3]])))
    s = to_port(js)
    for smooth in (0.9, 0.0):
        jenv.cfg.navi_opt.cmd_smooth_factor = env.cfg.navi_opt.cmd_smooth_factor = smooth
        cmds = env.nav_commands(s)
        np.testing.assert_allclose(cmds.numpy(), np.asarray(jenv.nav_commands(js)), atol=1e-5)
    assert (cmds[:, 0] > 0.2).all() and not bool(env.goal_reached(s).any())
    goal = torch.tensor(env.cfg.navi_opt.goal_pos) + s.env_origins * torch.tensor([1.0, 1.0, 0.0])
    s2 = s.replace(phys=s.phys.replace(base_pos=goal))
    assert bool(env.goal_reached(s2).all())
    assert float(env.nav_commands(s2)[:, :3].abs().max()) < 1e-5
    # a turned base: the command rotates into its frame
    q = torch.tensor([0.0, 0.0, np.sin(0.4), np.cos(0.4)]).expand(E, 4)
    jq = jnp.asarray(q.numpy())
    np.testing.assert_allclose(
        env.nav_commands(s.replace(phys=s.phys.replace(base_quat=q))).numpy(),
        np.asarray(jenv.nav_commands(js.replace(phys=js.phys.replace(base_quat=jq)))), atol=1e-5)


@pytest.mark.parametrize("task", ["anymal_c_nav", "elspider_air_nav", "anymal_c_nav_barrier"])
def test_nav_step_matches_jax(task):
    jenv, env = task_pair(task)
    js = jenv.reset_all(jax.random.PRNGKey(1))
    start = to_port(js).phys.base_pos.numpy()[:, :2] - env.cfg.navi_opt.start_pos[:2]
    np.testing.assert_allclose(start, np.asarray(js.env_origins)[:, :2], atol=1e-6)
    a = (0.3 * np.random.default_rng(1).standard_normal((E, env.num_actions))).astype(np.float32)
    assert_step_matches(jenv, env, js, a, task)
    if task == "anymal_c_nav_barrier":
        assert env.decimated_step.rough and env.num_height_points == 187


@pytest.mark.parametrize("task", ["anymal_c_plan_grad_sampling", "elspider_air_plan_grad_sampling"])
@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_plan_grad_rollout_and_apply(task, method):
    jenv, env = task_pair(task)
    jenv.cfg.planning.integration_method = env.cfg.planning.integration_method = method
    js = jenv.reset_all(jax.random.PRNGKey(2))
    s = to_port(js)
    D = env.num_actions
    rng = np.random.default_rng(2)
    us = rng.uniform(-2.0, 2.0, (E, 4, 9, D)).astype(np.float32)
    us[..., 0] += 0.5
    r = env.rollout_batch(s, torch.as_tensor(us))
    jr = jax.jit(jenv.rollout_batch)(js, jnp.asarray(us))
    assert r.shape == (E, 4, 9)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-4)
    u = np.zeros((E, D), np.float32)
    u[:, 0] = 1.0
    u[:, 3:6] = rng.uniform(-1.0, 1.0, (E, 3))
    u[:, 6:] = rng.uniform(-3.0, 3.0, (E, D - 6))
    s2, js2 = env.apply_plan_step(s, torch.as_tensor(u)), jenv.apply_plan_step(js, jnp.asarray(u))
    for k in ("base_pos", "base_quat", "joint_pos"):
        np.testing.assert_allclose(getattr(s2.phys, k).numpy(), np.asarray(getattr(js2.phys, k)),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(s2.projected_gravity.numpy(), np.asarray(js2.projected_gravity),
                               atol=1e-5)
    s3, js3 = env.step(s, torch.as_tensor(u)), jenv.step(js, jnp.asarray(u))
    for k in ("obs", "rew"):
        np.testing.assert_allclose(getattr(s3, k).numpy(), np.asarray(getattr(js3, k)), atol=1e-5)
    assert s3.obs.shape == (E, env.num_obs)


def percept_pair():
    """The ANYmal-C MPC config with 4 x 2 spherical rays and the SDF of the
    base and the shanks in the observation (48 + 8 + 5 x 4)."""
    out = []
    for Cfg, traj, Env in ((JPerceptCfg, jtraj_cfg, JPercept),
                           (RobotPerceptCfg, anymal_c_traj_sampling_cfg, RobotBatchRolloutPercept)):
        cfg = _copy_sections(Cfg(), traj(E), extra=("trajectory_opt",))
        cfg.raycaster.enable_raycast = True
        cfg.raycaster.ray_pattern = "spherical"
        cfg.raycaster.spherical_num_azimuth, cfg.raycaster.spherical_num_elevation = 4, 2
        cfg.raycaster.max_distance = 5.0
        cfg.sdf.enable_sdf = True
        cfg.sdf.query_bodies = ["base", "SHANK"]
        cfg.env.num_observations = 48 + 8 + 5 * 4
        cfg.rewards.scales.sdf_clearance = 1.0
        if Env is JPercept:
            cfg.sim.solver = "aba"
            out.append(Env(cfg))
        else:
            out.append(Env(cfg, device="cpu"))
    return out


def test_percept_obs_include_rays_and_sdf():
    jenv, env = percept_pair()
    js = jenv.reset_all(jax.random.PRNGKey(3))
    s = to_port(js)
    obs = env._compute_observations(s)
    assert obs.shape == (E, env.num_obs)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jenv._compute_observations(js)), atol=1e-4)
    assert float(env.raycast_obs(s).max()) > 0.1
    res, jres = env.sdf_query_bodies(s), jenv.sdf_query_bodies(js)
    for k in ("sdf", "gradient", "nearest"):
        np.testing.assert_allclose(getattr(res, k).numpy(), np.asarray(getattr(jres, k)), atol=1e-4)
    assert bool(((res.sdf[:, 0] > 0.2) & (res.sdf[:, 0] < 0.9)).all())
    # shanks pushed under the ground: the clearance term is negative
    p = s.phys.replace(base_pos=s.phys.base_pos - torch.tensor([0.0, 0.0, 0.6]))
    jp = js.phys.replace(base_pos=js.phys.base_pos - jnp.array([0.0, 0.0, 0.6]))
    term = env._reward_sdf_clearance(s.replace(phys=p), None)
    np.testing.assert_allclose(term.numpy(),
                               np.asarray(jenv._reward_sdf_clearance(js.replace(phys=jp), None)),
                               atol=1e-4)
    assert float(term.max()) < 0.0
