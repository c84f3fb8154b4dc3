"""Passive stone obstacles against the JAX package: the spawn with the JAX
draws injected, the stone dynamics on a plane and on a heightfield, the
robot coupling, and the env and rollout integration (mirrors
tests/test_dynamic_obstacles.py).

Tolerances: a spawn from the same draws to 1e-6 (types, counts and the
active mask exactly); stone dynamics to 1e-4 m and 1e-3 m/s after 40
substeps (stone-stone contacts amplify float32 ordering differences, so
longer runs are checked for settling, not against JAX); coupling forces to
1e-3 N relative 1e-5.  The env (``anymal_c_flat_obstacles`` at 4 envs, the
ABA solver) is held to tests/test_torch_env.py's state tolerances (5e-3)
through a reset, every env's stones to 1e-4 (the re-spawn's draws
injected); rollout rewards of 2 mains x 3 samples x 7 steps with a stone on
env 0's base to 1e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.envs.batch_rollout import RobotBatchRollout as JRobotBatchRollout
from extended_legged_gym_tpu.robots.task_variants import anymal_c_batch_rollout_flat_cfg
from extended_legged_gym_tpu.terrain import dynamic_obstacles as jdo
from extended_legged_gym_tpu.terrain import heightfield as jhf
from extended_legged_gym_tpu_torch.envs.batch_rollout import (RobotBatchRollout,
                                                              RobotBatchRolloutCfg)
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_flat_cfg
from extended_legged_gym_tpu_torch.robots.task_variants import _copy_sections
from extended_legged_gym_tpu_torch.terrain import dynamic_obstacles as do
from extended_legged_gym_tpu_torch.terrain import heightfield as hf
from torch_family import make_pair, to_port
from torch_parity import PHYS, one_torch_thread  # noqa: F401 (autouse)

E = 4


def jax_draws(key, n_env, cfg) -> do.StoneDraws:
    """The draws of ``jdo.generate_stones(key, ...)``, made the same way."""
    M = int(cfg.max_stones)
    ks = jax.random.split(key, 18)
    u = lambda k, lo, hi, *s: jax.random.uniform(k, (n_env, M) + s, minval=lo, maxval=hi)
    kv, kq, kc, kf = jax.random.split(ks[15], 4)
    k1, k2 = jax.random.split(kf)
    probs = jnp.asarray(cfg.type_probabilities, jnp.float32)
    d = dict(
        count=jax.random.randint(ks[0], (n_env,), cfg.min_stones, M + 1),
        stone_type=jax.random.categorical(ks[1], jnp.log(probs)[None, None, :], shape=(n_env, M)),
        box_size=u(ks[2], *cfg.box_size_range, 3), sphere_radius=u(ks[3], *cfg.sphere_radius_range),
        capsule_radius=u(ks[4], *cfg.capsule_radius_range),
        capsule_length=u(ks[5], *cfg.capsule_length_range), density=u(ks[6], *cfg.density_range),
        spawn_radius=u(ks[7], *cfg.spawn_radius_range), spawn_angle=u(ks[8], 0.0, 2.0 * jnp.pi),
        spawn_height=u(ks[9], *cfg.spawn_height_range),
        cluster=jax.random.bernoulli(ks[10], cfg.cluster_probability, (n_env, M)),
        parent_u=jax.random.uniform(ks[11], (n_env, M)),
        cluster_radius=u(ks[12], *cfg.cluster_radius_range),
        cluster_angle=u(ks[13], 0.0, 2.0 * jnp.pi),
        cluster_dist_u=jax.random.uniform(ks[16], (n_env, M)), cluster_dz=u(ks[14], -0.1, 0.1),
        vel_xy=u(kv, *cfg.initial_horizontal_vel_range, 2),
        vel_z=u(ks[17], *cfg.initial_vertical_vel_range),
        quat_normal=jax.random.normal(kq, (n_env, M, 4)),
        color=jax.random.randint(kc, (n_env, M), 0, len(jdo.STONE_COLORS)),
        friction=u(k1, *cfg.friction_range), restitution=u(k2, *cfg.restitution_range))
    t = {k: torch.as_tensor(np.array(v)) for k, v in d.items()}
    for k in ("count", "stone_type", "color"):
        t[k] = t[k].to(torch.int64)
    return do.StoneDraws(**t)


def to_port_stones(js) -> do.StoneState:
    t = {f: torch.as_tensor(np.array(getattr(js, f))) for f in
         ("pos", "vel", "ang_vel", "quat", "radius", "half_extents", "mass", "inv_inertia",
          "friction", "restitution", "stone_type", "color", "active")}
    t["stone_type"], t["color"] = t["stone_type"].to(torch.int64), t["color"].to(torch.int64)
    return do.StoneState(**t)


def assert_stones_close(s, js, atol=1e-6, vel_atol=None, err=""):
    for f in ("stone_type", "color", "active"):
        np.testing.assert_array_equal(getattr(s, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=err + f)
    for f in ("pos", "quat", "radius", "half_extents", "mass", "inv_inertia", "friction",
              "restitution"):
        np.testing.assert_allclose(getattr(s, f).numpy(), np.asarray(getattr(js, f)), atol=atol,
                                   rtol=1e-6, err_msg=err + f)
    for f in ("vel", "ang_vel"):
        np.testing.assert_allclose(getattr(s, f).numpy(), np.asarray(getattr(js, f)),
                                   atol=vel_atol or atol, rtol=1e-6, err_msg=err + f)


@pytest.fixture(scope="module")
def cfgs():
    return jdo.DynamicObstacleConfig(enable=True), do.DynamicObstacleConfig(enable=True)


def test_spawn_from_jax_draws(cfgs):
    jcfg, cfg = cfgs
    robot = np.array([[1.0, -2.0, 0.5], [0.0, 0.0, 0.4], [3.0, 1.0, 0.6], [-2.0, 2.0, 0.5],
                      [0.5, 0.5, 0.5], [9.0, -9.0, 1.0]], np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        js = jdo.generate_stones(key, jnp.asarray(robot), jcfg)
        s = do.generate_stones(torch.as_tensor(robot), cfg, draws=jax_draws(key, 6, jcfg))
        assert_stones_close(s, js, err=f"seed {seed} ")
        assert (np.asarray(js.active).sum(1) >= cfg.min_stones).all()


def test_port_draws_shapes_and_ranges(cfgs):
    _, cfg = cfgs
    robot = torch.tensor([[1.0, -2.0, 0.5]]).repeat(64, 1)
    gen = torch.Generator().manual_seed(0)
    st = do.generate_stones(robot, cfg, gen)
    M = cfg.max_stones
    assert st.pos.shape == (64, M, 3) and st.active.shape == (64, M)
    counts = st.active.sum(1)
    assert int(counts.min()) >= cfg.min_stones and int(counts.max()) <= M
    act = st.active
    d = torch.linalg.norm(st.pos[..., :2] - robot[:, None, :2], dim=-1)
    assert float(d[act].max()) <= cfg.spawn_radius_range[1] + cfg.cluster_radius_range[1] + 1e-5
    sph = act & (st.stone_type == do.SPHERE)
    assert float(st.radius[sph].min()) >= cfg.sphere_radius_range[0] - 1e-6
    assert abs(float((st.stone_type[act] == do.BOX).float().mean()) - 0.6) < 0.1
    assert torch.allclose(torch.linalg.norm(st.quat, dim=-1), torch.ones(64, M), atol=1e-5)


def rough_pair():
    rng = np.random.default_rng(0)
    g = (0.15 * rng.standard_normal((40, 40))).astype(np.float32)
    return (jhf.from_numpy(g, 0.25, origin=(-5.0, -5.0), friction=0.7),
            hf.from_numpy(g, 0.25, origin=(-5.0, -5.0), friction=0.7))


@pytest.mark.parametrize("ground", ["plane", "rough"])
def test_step_stones_match(cfgs, ground):
    jcfg, cfg = cfgs
    if ground == "plane":
        jterrain, terrain = jhf.flat_terrain(size=40.0), hf.flat_terrain()
    else:
        jterrain, terrain = rough_pair()
    robot = np.zeros((4, 3), np.float32)
    robot[:, 2] = 0.5
    key = jax.random.PRNGKey(1)
    js = jdo.generate_stones(key, jnp.asarray(robot), jcfg)
    # drop them low and close so contacts, bounces and stone pairs happen early
    pos = np.array(js.pos)
    pos[..., :2] *= 0.3
    pos[..., 2] = 0.05 + 0.1 * np.arange(pos.shape[1])[None, :] / pos.shape[1]
    js = js.replace(pos=jnp.asarray(pos))
    s = to_port_stones(js)
    js = jax.jit(lambda st: jdo.step_stones(st, jterrain, 0.005, jcfg, n_substeps=40))(js)
    s = do.step_stones(s, terrain, 0.005, cfg, n_substeps=40)
    assert_stones_close(s, js, atol=1e-4, vel_atol=1e-3)


def test_stones_fall_and_settle(cfgs):
    """12 s on a plane: every active stone rests near the ground, slowly."""
    _, cfg = cfgs
    robot = torch.zeros(4, 3)
    robot[:, 2] = 0.5
    st = do.generate_stones(robot, cfg, torch.Generator().manual_seed(1))
    st = do.step_stones(st, hf.flat_terrain(), 0.005, cfg, n_substeps=2400)
    act, z, r = st.active, st.pos[..., 2], st.radius
    assert bool(torch.isfinite(st.pos).all())
    assert bool((z[act] <= 3.0 * r.max() + r[act] + 0.05).all()) and bool((z[act] >= -0.06).all())
    assert float(torch.linalg.norm(st.vel, dim=-1)[act].max()) < 0.25


def test_robot_coupling_and_reset(cfgs):
    jcfg, cfg = cfgs
    key = jax.random.PRNGKey(2)
    robot = np.array([[0.0, 0.0, 0.5], [1.0, 1.0, 0.5]], np.float32)
    js = jdo.generate_stones(key, jnp.asarray(robot), jcfg)
    pos = np.array(js.pos)
    pos[:, 0] = robot + [0.1, 0.0, 0.0]              # a stone on each base
    pos[1, 1] = robot[1] + [0.0, 0.0, 0.0]           # and one exactly on a centre
    js = js.replace(pos=jnp.asarray(pos), active=js.active.at[:, :2].set(True))
    rng = np.random.default_rng(3)
    spos = (robot[:, None, :] + 0.2 * rng.standard_normal((2, 5, 3))).astype(np.float32)
    spos[:, 0] = robot                                # the base spheres
    svel = rng.standard_normal((2, 5, 3)).astype(np.float32)
    rad = np.array([0.3, 0.05, 0.05, 0.05, 0.05], np.float32)
    jf, js2 = jdo.stone_robot_forces(js, jnp.asarray(spos), jnp.asarray(rad), 0.02, jcfg,
                                     sphere_vel=jnp.asarray(svel))
    f, s2 = do.stone_robot_forces(to_port_stones(js), torch.as_tensor(spos), torch.as_tensor(rad),
                                  0.02, cfg, sphere_vel=torch.as_tensor(svel))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-3)
    assert_stones_close(s2, js2, atol=1e-6, vel_atol=1e-5)
    assert float(torch.linalg.norm(f[:, 0], dim=-1).min()) > 0.0
    # a masked re-spawn: only env 0's stones change
    key2 = jax.random.PRNGKey(7)
    mask = np.array([True, False])
    jr = jdo.reset_stones(js2, key2, jnp.asarray(robot), jnp.asarray(mask), jcfg)
    r = do.reset_stones(s2, torch.as_tensor(robot), torch.as_tensor(mask), cfg,
                        draws=jax_draws(key2, 2, jcfg))
    assert_stones_close(r, jr, atol=1e-6, vel_atol=1e-5)
    assert torch.equal(r.pos[1], s2.pos[1]) and not torch.equal(r.pos[0], s2.pos[0])


@pytest.fixture(scope="module")
def obstacle_envs():
    """The JAX and port ``anymal_c_flat_obstacles`` envs at 4 envs and the
    JAX state after 6 steps of random actions from its reset."""
    jenv, env = make_pair("anymal_c_flat_obstacles")
    js = jenv.reset_all(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    jstep = jax.jit(jenv.step)
    for _ in range(6):
        js = jstep(js, jnp.asarray((0.3 * rng.standard_normal((E, 12))).astype(np.float32)))
    return jenv, env, jstep, js


def test_env_step_with_stones_through_a_reset(obstacle_envs):
    """Env 0 times out; a stone sits 2 cm inside env 1's base sphere (the
    base feels it, which terminates env 1).  Two steps of the same actions:
    the envs not reset match, and every env's stones match (the re-spawns
    from the JAX draws)."""
    jenv, env, jstep, js = obstacle_envs
    el = np.asarray(js.episode_length).copy()
    el[0] = jenv.max_episode_length
    st = js.stones
    # 2 cm into the base sphere, from above
    up = float(jenv._obstacle_sphere_radius[0] + st.radius[1, 0]) - 0.02
    st = st.replace(pos=st.pos.at[1, 0].set(js.phys.base_pos[1] + jnp.array([0.0, 0.0, up])),
                    vel=st.vel.at[1, 0].set(0.0), active=st.active.at[1, 0].set(True))
    js = js.replace(episode_length=jnp.asarray(el, js.episode_length.dtype), stones=st)
    s = to_port(js).replace(stones=to_port_stones(js.stones))
    rng = np.random.default_rng(1)
    fresh = np.zeros(E, bool)
    for k in range(2):
        a = (0.3 * rng.standard_normal((E, 12))).astype(np.float32)
        k_reset = jax.random.split(js.key, 6)[3]
        draws = jax_draws(jax.random.split(k_reset)[1], E, jenv.obstacle_cfg)
        env._draw_stones = lambda d=draws: d
        js, s = jstep(js, jnp.asarray(a)), env.step(s, torch.as_tensor(a))
        np.testing.assert_array_equal(s.reset_buf.numpy(), np.asarray(js.reset_buf))
        fresh |= s.reset_buf.numpy()
        keep = ~fresh
        for name in PHYS:
            np.testing.assert_allclose(getattr(s.phys, name)[keep].numpy(),
                                       np.asarray(getattr(js.phys, name))[keep], atol=5e-3,
                                       err_msg=f"step {k} {name}")
        np.testing.assert_allclose(s.geom_forces[keep].numpy(), np.asarray(js.geom_forces)[keep],
                                   rtol=1e-3, atol=0.5)
        np.testing.assert_allclose(s.rew[keep].numpy(), np.asarray(js.rew)[keep], atol=1e-3)
        assert_stones_close(s.stones, js.stones, atol=1e-4, vel_atol=1e-3, err=f"step {k} ")
        if k == 0:
            # env 0 timed out; the stone on env 1's base terminates it
            assert bool(s.reset_buf[0]) and keep[2:].all()
            assert float(torch.linalg.norm(s.geom_forces[1, env._base_geom])) > 1.0


def rollout_pair():
    jcfg = anymal_c_batch_rollout_flat_cfg(num_main_envs=2)
    cfg = _copy_sections(RobotBatchRolloutCfg(), anymal_c_flat_cfg())
    cfg.env.num_envs = 2
    cfg.rewards.multi_stage_rewards = False
    for c in (jcfg, cfg):
        c.obstacle_gen.enable_obstacles = True
        c.obstacle_gen.min_obstacles, c.obstacle_gen.max_obstacles = 2, 4
        c.rewards.only_positive_rewards = False
        c.domain_rand.randomize_friction = c.domain_rand.randomize_base_mass = False
        c.domain_rand.push_robots = c.noise.add_noise = False
    jcfg.sim.solver = "aba"
    return JRobotBatchRollout(jcfg), RobotBatchRollout(cfg, device="cpu")


def test_rollouts_anticipate_stones():
    """A stone parked on env 0's base changes env 0's candidate rewards, not
    env 1's; both match JAX."""
    jenv, env = rollout_pair()
    js = jenv.reset_all(jax.random.PRNGKey(0))
    S, H1 = 3, 7
    us = (0.2 * np.random.default_rng(2).standard_normal((2, S, H1, 12))).astype(np.float32)
    far = js.stones.replace(pos=js.stones.pos + jnp.array([100.0, 0.0, 0.0]))
    near = js.stones.replace(
        pos=js.stones.pos.at[0, 0].set(js.phys.base_pos[0] + jnp.array([0.15, 0.0, 0.0])),
        active=js.stones.active.at[0, 0].set(True), vel=jnp.zeros_like(js.stones.vel))
    rews = {}
    for name, st in (("far", far), ("near", near)):
        jr = jax.jit(jenv.rollout_batch)(js.replace(stones=st), jnp.asarray(us))
        s = to_port(js).replace(stones=to_port_stones(st))
        r = env.rollout_batch(s, torch.as_tensor(us))
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-3, err_msg=name)
        rews[name] = r
    assert float((rews["near"][0] - rews["far"][0]).abs().max()) > 1e-4
    np.testing.assert_allclose(rews["near"][1].numpy(), rews["far"][1].numpy(), atol=1e-5)
