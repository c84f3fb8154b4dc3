"""The anymal_c_flat env with what training switches on (friction and base
mass randomization, pushes, observation noise) and its episode accumulators,
against the JAX env with the ABA solver, on the CPU at 4 envs.

The JAX reset state (its randomized friction and mass included) is carried
into the port; the draws of a step (push velocities, observation noise) are
recomputed from the JAX state's key as the JAX env splits it and injected
into the port through ``_draw_push_vel`` / ``_draw_obs_noise``.  Tolerances
are those of tests/test_torch_env.py: states 5e-3, observations 1e-2,
rewards 1e-3 absolute; the noise vector and the push exactly; episode
metrics 1e-4 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.envs.legged_robot import LeggedRobot as JLeggedRobot
from extended_legged_gym_tpu.robots.anymal_c import anymal_c_flat_cfg as janymal_c_flat_cfg
from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_flat_cfg
from torch_parity import PHYS, to_torch_state

E = 4


@pytest.fixture(scope="module")
def envs():
    jc = janymal_c_flat_cfg()
    jc.env.num_envs = E
    jc.sim.solver = "aba"
    c = anymal_c_flat_cfg()
    c.env.num_envs = E
    jenv = JLeggedRobot(jc)
    return jenv, LeggedRobot(c, device="cpu"), jax.jit(jenv.step)


def inject_jax_draws(env, jenv, js):
    """Make the port env's next step draw what the JAX env's step draws from
    ``js.key`` (``_post_physics_step`` splits it into cmd, push, reset, cmd2,
    noise)."""
    _, _, k_push, _, _, k_noise = jax.random.split(js.key, 6)
    m = jenv.cfg.domain_rand.max_push_vel_xy
    push = np.asarray(jax.random.uniform(k_push, (E, 2), minval=-m, maxval=m))
    u = np.asarray(jax.random.uniform(k_noise, (E, jenv.num_obs)))
    env._draw_push_vel = lambda: torch.as_tensor(push)
    env._draw_obs_noise = lambda shape: torch.as_tensor(2.0 * u - 1.0)
    return push


def test_config_matches_jax(envs):
    jenv, env, _ = envs
    assert env.cfg.domain_rand.randomize_friction and env.cfg.domain_rand.randomize_base_mass
    assert env.cfg.domain_rand.push_robots and env.cfg.noise.add_noise
    assert env.reward_names == jenv.reward_names
    np.testing.assert_allclose(env.reward_scale_table.numpy(), jenv.reward_scale_table, rtol=1e-7)
    assert env.push_interval == jenv.push_interval == 750
    assert env.num_obs == 48 and env.max_episode_length == jenv.max_episode_length


def test_noise_scale_vec_matches_jax(envs):
    jenv, env, _ = envs
    np.testing.assert_array_equal(env.noise_scale_vec.numpy(), np.asarray(jenv.noise_scale_vec))


@pytest.mark.parametrize("common_step", [749, 100])
def test_step_with_injected_draws_matches_jax(envs, common_step):
    """One step from the JAX reset state (randomized friction and mass) with
    the JAX push velocities and noise: at common_step 749 -> 750 the push
    fires, at 100 -> 101 it does not."""
    jenv, env, jstep = envs
    js = jenv.reset_all(jax.random.PRNGKey(5))
    js = js.replace(common_step=jnp.asarray(common_step, jnp.int32))
    assert float(jnp.std(js.env_params.friction_scale)) > 0
    assert float(jnp.abs(js.env_params.base_mass_delta).max()) > 0.5
    s = to_torch_state(js)
    push = inject_jax_draws(env, jenv, js)
    a = (0.3 * np.random.default_rng(0).standard_normal((E, 12))).astype(np.float32)
    js = jstep(js, jnp.asarray(a))
    s = env.step(s, torch.as_tensor(a))
    assert not bool(np.asarray(js.reset_buf).any())
    assert int(s.common_step) == int(js.common_step) == common_step + 1
    for k in PHYS:
        np.testing.assert_allclose(getattr(s.phys, k).numpy(), np.asarray(getattr(js.phys, k)),
                                   atol=5e-3, err_msg=k)
    pushed = np.allclose(s.phys.base_lin_vel[:, :2].numpy(), push)
    assert pushed == (common_step + 1 == 750)
    np.testing.assert_allclose(s.obs.numpy(), np.asarray(js.obs), atol=1e-2)
    np.testing.assert_allclose(s.rew.numpy(), np.asarray(js.rew), atol=1e-3)


def test_push_fires_every_push_interval_only():
    """Stepping common_step 745 -> 756 and 1495 -> 1502: the base xy velocity
    is overwritten exactly when the counter reaches 750 and 1500."""
    c = anymal_c_flat_cfg()
    c.env.num_envs = 2
    c.noise.add_noise = False
    env = LeggedRobot(c, device="cpu")
    env._draw_push_vel = lambda: torch.full((2, 2), 7.0)
    s = env.reset_all(seed=0)
    for start, n in ((745, 11), (1495, 7)):
        s = s.replace(common_step=torch.tensor(start))
        for _ in range(n):
            s = env.step(s, torch.zeros(2, 12))
            hit = bool((s.phys.base_lin_vel[:, :2] == 7.0).all())
            assert hit == (int(s.common_step) % 750 == 0), int(s.common_step)


def test_friction_from_64_buckets_and_mass_in_range():
    c = anymal_c_flat_cfg()
    c.env.num_envs = 512
    env = LeggedRobot(c, device="cpu")
    ep = env.reset_all(seed=1).env_params
    f, m = ep.friction_scale, ep.base_mass_delta
    lo, hi = c.domain_rand.friction_range
    assert 32 < len(torch.unique(f)) <= 64
    assert bool(((f >= lo) & (f < hi)).all())
    assert bool(((m >= -5.0) & (m < 5.0)).all()) and float(m.std()) > 2.0
    # the draws stay with the env for its lifetime: a step keeps them
    s = env.step(env.reset_all(seed=1), torch.zeros(512, 12))
    assert torch.equal(s.env_params.friction_scale, f)


def test_eval_protocol_draws_nothing_new():
    """With randomization, pushes and noise off (the evaluation protocol) the
    env's random stream is the one it had before they were ported: the same
    seed gives the same reset state as a fresh generator's first draws."""
    c = anymal_c_flat_cfg()
    c.env.num_envs = 3
    c.domain_rand.randomize_friction = c.domain_rand.randomize_base_mass = False
    c.domain_rand.push_robots = c.noise.add_noise = False
    env = LeggedRobot(c, device="cpu")
    s = env.reset_all(seed=4)
    assert bool((s.env_params.friction_scale == 1).all() and (s.env_params.base_mass_delta == 0).all())
    g = torch.Generator().manual_seed(4)
    lin = torch.rand((3, 3), generator=g) - 0.5
    np.testing.assert_allclose(s.phys.base_lin_vel.numpy(), lin.numpy() + 0.0, atol=1e-7)


def test_episode_metrics_match_jax(envs):
    """Two of four envs time out on this step: the finished episodes' count,
    return, length and per-term sums are folded in as the JAX
    ``_reset_envs`` does, and ``zero_episode_metrics`` has the JAX keys."""
    jenv, env, jstep = envs
    assert set(env.zero_episode_metrics()) == set(jenv.zero_episode_metrics())
    js = jenv.reset_all(jax.random.PRNGKey(6))
    a = (0.3 * np.random.default_rng(1).standard_normal((E, 12))).astype(np.float32)
    for _ in range(3):
        js = jstep(js, jnp.asarray(a))
    js = js.replace(episode_length=js.episode_length.at[1:3].set(jenv.max_episode_length))
    s = to_torch_state(js)
    inject_jax_draws(env, jenv, js)
    js = jstep(js, jnp.asarray(a))
    s = env.step(s, torch.as_tensor(a))
    assert s.time_out_buf.tolist() == [False, True, True, False]
    em, jem = s.episode_metrics, js.episode_metrics
    assert set(em) == set(jem)
    assert float(em["count"]) == float(jem["count"]) == 2.0
    for k in em:
        np.testing.assert_allclose(float(em[k]), float(jem[k]), rtol=1e-4, atol=1e-7, err_msg=k)
