"""Whole steps of the plain LeggedRobot family against the JAX package, on
the CPU, through a reset: ``a1``, ``go2_rough``, ``cassie`` and
``elspider_air_rough`` (B2's plain step on each robot's 2 x 2 grid), 4 envs
each (tests/test_torch_legged_variant_steps.py runs the variants).

The JAX env (ABA solver) takes a few steps of random actions from its reset;
its state, privileged observation and base accelerations included, is
carried into the port.  Env 0 then times out; both envs take the same two
steps of random actions and must reset the same envs; the envs not reset
keep matching.  Tolerances are tests/test_torch_env.py's: states 5e-3,
observations and privileged observations 1e-2 (the height scan is scaled by
5), rewards and episode sums 1e-3 absolute; the accelerations 1e-2 relative
plus 1e-2 absolute (a velocity difference over one control step)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_family import make_pair, to_port
from torch_parity import PHYS

E = 4
TASKS = ("a1", "go2_rough", "cassie", "elspider_air_rough")


def jax_pair_after_steps(task, base_z=None):
    """The task's (task, JAX env, port env, jitted JAX step, JAX state after
    4 steps of random actions from its reset), the base starting at
    ``base_z`` where given."""
    jenv, env = make_pair(task, base_z=base_z)
    jstep = jax.jit(jenv.step)
    js = jenv.reset_all(jax.random.PRNGKey(4))
    rng = np.random.default_rng(0)
    for _ in range(4):
        js = jstep(js, jnp.asarray((0.3 * rng.standard_normal((E, env.num_actions)))
                                   .astype(np.float32)))
    return task, jenv, env, jstep, js


@pytest.fixture(scope="module", params=TASKS)
def envs(request):
    return jax_pair_after_steps(request.param)


def steps_through_a_reset(task, jenv, env, jstep, js):
    """Env 0 times out; two steps of the same random actions in both envs;
    the states of the envs not reset must match."""
    el = np.asarray(js.episode_length).copy()
    el[0] = jenv.max_episode_length
    js = js.replace(episode_length=jnp.asarray(el, js.episode_length.dtype))
    s = to_port(js)
    rng = np.random.default_rng(1)
    fresh = np.zeros(E, bool)
    for k in range(2):
        a = (0.3 * rng.standard_normal((E, env.num_actions))).astype(np.float32)
        js, s = jstep(js, jnp.asarray(a)), env.step(s, torch.as_tensor(a))
        np.testing.assert_array_equal(s.reset_buf.numpy(), np.asarray(js.reset_buf))
        np.testing.assert_array_equal(s.time_out_buf.numpy(), np.asarray(js.time_out_buf))
        fresh |= s.reset_buf.numpy()
        keep = ~fresh
        assert fresh[0] and keep.any()
        for name in PHYS:
            np.testing.assert_allclose(getattr(s.phys, name)[keep].numpy(),
                                       np.asarray(getattr(js.phys, name))[keep], atol=5e-3,
                                       err_msg=f"{task} step {k} {name}")
        np.testing.assert_allclose(s.obs[keep].numpy(), np.asarray(js.obs)[keep], atol=1e-2)
        np.testing.assert_allclose(s.rew[keep].numpy(), np.asarray(js.rew)[keep], atol=1e-3)
        for n, v in js.episode_sums.items():
            np.testing.assert_allclose(s.episode_sums[n][keep].numpy(), np.asarray(v)[keep],
                                       atol=1e-3, err_msg=n)
        if env.num_privileged_obs:
            assert s.privileged_obs.shape == (E, env.num_privileged_obs)
            np.testing.assert_allclose(s.privileged_obs[keep].numpy(),
                                       np.asarray(js.privileged_obs)[keep], atol=1e-2)
        if hasattr(env, "acc_ema"):
            for n in ("base_lin_acc", "base_ang_acc"):
                np.testing.assert_allclose(getattr(s, n)[keep].numpy(),
                                           np.asarray(getattr(js, n))[keep], rtol=1e-2,
                                           atol=1e-2, err_msg=n)
        np.testing.assert_array_equal(s.episode_length[fresh].numpy(),
                                      np.asarray(js.episode_length)[fresh])
        if env.model.fix_base:
            np.testing.assert_array_equal(s.phys.base_pos[keep].numpy(),
                                          np.asarray(js.phys.base_pos)[keep])
            assert float(s.phys.base_lin_vel.abs().max()) == 0.0
    assert set(s.episode_sums) == set(js.episode_sums)
    assert set(s.episode_metrics) == set(js.episode_metrics)


def test_steps_through_a_reset_match_jax(envs):
    steps_through_a_reset(*envs)
