"""Terrain-curriculum promotion against the JAX env, and rough training.

The anymal_c_rough env on a 4 x 4 generated grid (4 m subterrains), 16 envs,
curriculum on: states are built from one JAX reset with hand-placed bases,
commands and levels, so that the reset moves envs up, moves them down
(clipped at level 0), keeps them, and sends envs past the top row to a
random level; some envs that would move are not reset.  The JAX random
levels (``randint`` on the command key) and spawn offsets (the first split
of the reset key) are recomputed and injected through ``_draw_random_levels``
and ``_draw_spawn_offset``.  Levels and origins must equal the JAX env's
exactly, the reset base positions to 1e-6.  The same holds through a whole
step in which every env times out (physics agrees to 5e-3, the bases sit far
from the promotion thresholds).  Then the rough task's training config builds
through the registry, and two port runner iterations at 64 envs give a finite
loss and move levels."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.envs.legged_robot import LeggedRobot as JLeggedRobot
from extended_legged_gym_tpu.robots.anymal_c import anymal_c_rough_cfg as janymal_c_rough_cfg
from extended_legged_gym_tpu_torch import robots  # noqa: F401  (populates the registry)
from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_rough_cfg
from extended_legged_gym_tpu_torch.utils.task_registry import task_registry
from torch_parity import PHYS, to_torch_state

E = 16


def small_grid(cfg, envs=E):
    cfg.env.num_envs = envs
    cfg.terrain.num_rows = cfg.terrain.num_cols = 4
    cfg.terrain.terrain_length = cfg.terrain.terrain_width = 4.0
    cfg.terrain.border_size = 2.0
    cfg.terrain.max_init_terrain_level = 3
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.randomize_friction = cfg.domain_rand.randomize_base_mass = False
    return cfg


@pytest.fixture(scope="module")
def envs():
    jc = small_grid(janymal_c_rough_cfg())
    jc.sim.solver = "aba"
    jenv = JLeggedRobot(jc)
    env = LeggedRobot(small_grid(anymal_c_rough_cfg()), device="cpu")
    assert env.cfg.terrain.curriculum and not env.cfg.terrain.freeze_terrain_levels
    assert env.max_terrain_level == jenv.max_terrain_level == 4
    return jenv, env


# per env: (level, base displacement from the origin in m, |command| in m/s, reset?)
# subterrain 4 m: up past 2 m; down when short of |cmd| * 20 s * 0.5
CASES = [
    (1, 2.8, 0.5, True),    # up
    (2, 3.2, 0.0, True),    # up
    (3, 2.6, 0.8, True),    # past the top row: random level
    (3, 3.0, 0.2, True),    # past the top row: random level
    (2, 0.3, 0.5, True),    # down
    (1, 1.0, 1.0, True),    # down
    (0, 0.2, 0.7, True),    # down, clipped at 0
    (3, 1.2, 0.05, True),   # stays (1.2 m > 0.5 m commanded)
    (2, 1.5, 0.0, True),    # stays (no command)
    (0, 1.9, 0.1, True),    # stays
    (1, 2.9, 0.5, False),   # would move up, not reset
    (3, 0.1, 0.9, False),   # would move down, not reset
    (2, 0.4, 0.6, True),    # down
    (0, 2.4, 0.3, True),    # up
    (1, 1.7, 0.15, True),   # stays
    (3, 2.2, 0.0, True),    # past the top row: random level
]


def placed_state(jenv, key):
    """A JAX reset with the levels, bases and commands of CASES."""
    js = jenv.reset_all(key)
    lv = np.array([c[0] for c in CASES], np.int32)
    types = np.asarray(js.terrain_types)
    origins = np.asarray(jenv.terrain_origins)[lv, types]
    ang = np.linspace(0.0, 2 * np.pi, E, endpoint=False)
    pos = np.array(js.phys.base_pos)
    disp = np.array([c[1] for c in CASES])
    pos[:, 0] = origins[:, 0] + disp * np.cos(ang)
    pos[:, 1] = origins[:, 1] + disp * np.sin(ang)
    pos[:, 2] = origins[:, 2] + 0.6
    cmd = np.zeros((E, 4), np.float32)
    speed = np.array([c[2] for c in CASES], np.float32)
    cmd[:, 0], cmd[:, 1] = speed * 0.6, speed * 0.8
    js = js.replace(terrain_levels=jnp.asarray(lv), env_origins=jnp.asarray(origins),
                    commands=jnp.asarray(cmd),
                    phys=js.phys.replace(base_pos=jnp.asarray(pos)))
    mask = np.array([c[3] for c in CASES])
    return js, mask


def inject(env, k_levels, k_reset):
    """The JAX env's random levels and spawn offsets, in the port."""
    levels = np.array(jax.random.randint(k_levels, (E,), 0, 4))
    offset = np.array(jax.random.uniform(jax.random.split(k_reset, 4)[0], (E, 2),
                                         minval=-0.5, maxval=0.5))
    env._draw_random_levels = lambda: torch.as_tensor(levels, dtype=torch.int64)
    env._draw_spawn_offset = lambda: torch.as_tensor(offset)
    return levels


def test_reset_promotion_matches_jax(envs):
    jenv, env = envs
    js, mask = placed_state(jenv, jax.random.PRNGKey(0))
    k_reset, k_cmd = jax.random.split(jax.random.PRNGKey(1))
    rand = inject(env, k_cmd, k_reset)
    jout = jenv._reset_envs(js, k_reset, k_cmd, jnp.asarray(mask))
    out = env._reset_envs(to_torch_state(js), torch.as_tensor(mask))

    before = np.asarray(js.terrain_levels)
    want = np.asarray(jout.terrain_levels)
    np.testing.assert_array_equal(out.terrain_levels.numpy(), want)
    np.testing.assert_array_equal(out.env_origins.numpy(), np.asarray(jout.env_origins))
    np.testing.assert_allclose(out.phys.base_pos.numpy(), np.asarray(jout.phys.base_pos),
                               atol=1e-6)
    # every kind of move happened: up, down, clipped at 0, kept, past the top
    # (where the injected draw decides), and none where the mask is off
    top = mask & (before == 3) & (np.array([c[1] for c in CASES]) > 2.0)
    assert ((want == before + 1) & mask).any() and ((want == before - 1) & mask).any()
    assert ((want == before) & mask & (before > 0)).any()
    assert (mask & (before == 0) & (want == 0)).any()
    np.testing.assert_array_equal(want[top], rand[top])
    np.testing.assert_array_equal(want[~mask], before[~mask])
    assert ((rand[top] != 3)).any() and top.sum() == 3
    # the reset envs stand on their new origins
    off = (out.phys.base_pos - out.env_origins).numpy()
    assert np.allclose(off[mask, 2], 0.6) and (np.abs(off[mask, :2]) <= 0.5).all()


def test_step_with_timeouts_promotes_as_jax(envs):
    """One whole step in which every env times out: the resets run the
    curriculum on the bases the physics moved."""
    jenv, env = envs
    js, _ = placed_state(jenv, jax.random.PRNGKey(2))
    js = js.replace(episode_length=jnp.full((E,), jenv.max_episode_length, jnp.int32))
    _, _, _, k_reset, k_cmd2, _ = jax.random.split(js.key, 6)
    inject(env, k_cmd2, k_reset)
    a = (0.1 * np.random.default_rng(0).standard_normal((E, 12))).astype(np.float32)
    jout = jax.jit(jenv.step)(js, jnp.asarray(a))
    out = env.step(to_torch_state(js), torch.as_tensor(a))
    assert np.asarray(jout.time_out_buf).all() and out.time_out_buf.all()
    np.testing.assert_array_equal(out.terrain_levels.numpy(), np.asarray(jout.terrain_levels))
    np.testing.assert_array_equal(out.env_origins.numpy(), np.asarray(jout.env_origins))
    np.testing.assert_allclose(out.phys.base_pos.numpy(), np.asarray(jout.phys.base_pos),
                               atol=1e-6)
    assert not np.array_equal(np.asarray(jout.terrain_levels), np.asarray(js.terrain_levels))
    for k in PHYS[1:]:
        assert np.isfinite(getattr(out.phys, k).numpy()).all(), k


def test_rough_training_cfg_builds_and_trains():
    env_cfg, train_cfg = task_registry.get_cfgs("anymal_c_rough")
    assert env_cfg.terrain.curriculum and not env_cfg.terrain.freeze_terrain_levels
    assert env_cfg.domain_rand.push_robots and env_cfg.noise.add_noise
    assert train_cfg.policy.actor_hidden_dims == [512, 256, 128]
    assert train_cfg.policy.critic_hidden_dims == [512, 256, 128]
    env_cfg = small_grid(env_cfg, envs=64)
    env_cfg.noise.add_noise = True
    env_cfg.domain_rand.push_robots = True
    env_cfg.env.episode_length_s = 0.4      # every env resets inside an iteration
    env, _ = task_registry.make_env("anymal_c_rough", env_cfg=env_cfg, device="cpu")
    runner = OnPolicyRunner(env, train_cfg)
    levels0 = runner.env_state.terrain_levels.clone()
    for _ in range(2):
        m = runner.train_iteration()
        assert np.isfinite(float(m["loss"])) and float(m["nonfinite_skips"]) == 0
    levels = runner.env_state.terrain_levels
    assert (levels != levels0).any()
    assert int(levels.min()) >= 0 and int(levels.max()) < env.max_terrain_level
    assert float(m["terrain_level"]) == pytest.approx(float(levels.float().mean()))
    origins = env._compute_env_origins(levels, runner.env_state.terrain_types)
    assert torch.equal(runner.env_state.env_origins, origins)
