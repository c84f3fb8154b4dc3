"""The port's env (reset, step, observations, rewards) against the JAX env
with the ABA solver, at 2 main envs.

The JAX reset state is carried into the port (JAX PRNG draws cannot be
reproduced in torch); actions come from a numpy seed.  Tolerances after up
to three control steps: states 5e-3, observations 1e-2 (joint velocities are
scaled by 0.05 but base velocities by 2), rewards 1e-3 absolute."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.robots.anymal_c_traj import AnymalCTrajGradSampling as JEnv
from extended_legged_gym_tpu.robots.anymal_c_traj import anymal_c_traj_sampling_cfg as jcfg
from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
from extended_legged_gym_tpu_torch.robots.anymal_c_traj import (AnymalCTrajGradSampling,
                                                               anymal_c_traj_sampling_cfg)
from torch_parity import PHYS, to_torch_state

E = 2


@pytest.fixture(scope="module")
def envs():
    c = jcfg(E)
    c.sim.solver = "aba"
    jenv = JEnv(c)
    env = AnymalCTrajGradSampling(anymal_c_traj_sampling_cfg(E), device="cpu")
    return jenv, env, jax.jit(jenv.step)


def test_reset_all_shapes_and_ranges(envs):
    jenv, env, _ = envs
    s = env.reset_all(seed=3)
    js = jenv.reset_all(jax.random.PRNGKey(0))
    for k in ("obs", "commands", "foot_positions", "geom_forces", "feet_air_time"):
        assert tuple(getattr(s, k).shape) == tuple(getattr(js, k).shape), k
    np.testing.assert_allclose(s.phys.base_pos.numpy(), np.asarray(js.phys.base_pos), atol=1e-6)
    assert set(s.episode_sums) == set(js.episode_sums)
    assert env.reward_names == jenv.reward_names
    np.testing.assert_allclose(env.reward_scales.numpy(), np.asarray(jenv.reward_scale_table[0]))
    ddp = env.default_dof_pos.numpy()
    jp = s.phys.joint_pos.numpy() / np.where(ddp == 0, 1, ddp)
    assert ((jp >= 0.5) & (jp <= 1.5) | (ddp == 0)).all()
    assert (s.phys.base_lin_vel.abs() <= 0.5).all() and (s.commands[:, 0].abs() <= 1.5).all()
    # observations from the same state agree
    np.testing.assert_allclose(env._compute_observations(to_torch_state(js)).numpy(),
                               np.asarray(js.obs), atol=1e-6)


def test_step_matches_jax(envs):
    jenv, env, jstep = envs
    js = jenv.reset_all(jax.random.PRNGKey(1))
    s = to_torch_state(js)
    rng = np.random.default_rng(0)
    for i in range(3):
        a = (0.3 * rng.standard_normal((E, 12))).astype(np.float32)
        js = jstep(js, jnp.asarray(a))
        s = env.step(s, torch.as_tensor(a))
        assert not bool(np.asarray(js.reset_buf).any())
        for k in PHYS:
            np.testing.assert_allclose(getattr(s.phys, k).numpy(), np.asarray(getattr(js.phys, k)),
                                       atol=5e-3, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(s.obs.numpy(), np.asarray(js.obs), atol=1e-2, err_msg=f"obs {i}")
        np.testing.assert_allclose(s.rew.numpy(), np.asarray(js.rew), atol=1e-3, err_msg=f"rew {i}")
        for k in ("torques", "foot_positions", "projected_gravity"):
            np.testing.assert_allclose(getattr(s, k).numpy(), np.asarray(getattr(js, k)),
                                       atol=0.5 if k == "torques" else 5e-3, err_msg=k)
        np.testing.assert_array_equal(s.last_contacts.numpy(), np.asarray(js.last_contacts))
        np.testing.assert_allclose(s.feet_air_time.numpy(), np.asarray(js.feet_air_time), atol=1e-6)
        assert (s.episode_length.numpy() == np.asarray(js.episode_length)).all()
        for k in s.episode_sums:
            np.testing.assert_allclose(s.episode_sums[k].numpy(), np.asarray(js.episode_sums[k]),
                                       atol=1e-3, err_msg=k)


def test_timeout_resets_env(envs):
    """An env past the episode length terminates, is re-drawn and its
    bookkeeping zeroed, as in the JAX env."""
    jenv, env, jstep = envs
    js = jenv.reset_all(jax.random.PRNGKey(2))
    js = js.replace(episode_length=js.episode_length.at[1].set(jenv.max_episode_length))
    s = to_torch_state(js)
    a = np.zeros((E, 12), np.float32)
    js = jstep(js, jnp.asarray(a))
    s = env.step(s, torch.as_tensor(a))
    np.testing.assert_array_equal(s.reset_buf.numpy(), np.asarray(js.reset_buf))
    np.testing.assert_array_equal(s.time_out_buf.numpy(), np.asarray(js.time_out_buf))
    assert s.reset_buf.tolist() == [False, True]
    assert s.episode_length.tolist() == np.asarray(js.episode_length).tolist() == [1, 0]
    np.testing.assert_allclose(s.rew.numpy(), np.asarray(js.rew), atol=1e-3)
    np.testing.assert_allclose(s.obs[0].numpy(), np.asarray(js.obs[0]), atol=1e-2)
    assert s.episode_return[1] == 0.0 and s.feet_air_time[1].abs().sum() == 0.0
    np.testing.assert_allclose(s.phys.base_pos[1].numpy(), np.asarray(js.phys.base_pos[1]), atol=1e-6)


@pytest.mark.parametrize("name", ["gaits", "air_time", "upright", "yaw", "vel", "ang_vel",
                                  "height", "energy", "alive"])
def test_dial_mpc_reward_terms_match(envs, name):
    """The ANYmal-C task's own reward terms (unscaled by the committed
    config) on a stepped state, with the same contact context."""
    jenv, env, jstep = envs
    js = jenv.reset_all(jax.random.PRNGKey(3))
    rng = np.random.default_rng(1)
    for _ in range(3):
        js = jstep(js, jnp.asarray((0.3 * rng.standard_normal((E, 12))).astype(np.float32)))
    s = to_torch_state(js)
    ctx = env._contact_context(s)
    jctx = {k: jnp.asarray(v.numpy()) for k, v in ctx.items()}
    want = np.asarray(getattr(jenv, f"_reward_{name}")(js, jctx))
    got = getattr(env, f"_reward_{name}")(s, ctx).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def v_control(cfg):
    """V control with gains the explicit substep keeps stable: a velocity
    P gain and a small D gain on the joint acceleration."""
    cfg.control.control_type = "V"
    cfg.control.stiffness = {"HAA": 10.0, "HFE": 10.0, "KFE": 10.0}
    cfg.control.damping = {"HAA": 0.01, "HFE": 0.01, "KFE": 0.01}
    return cfg


def test_v_control_step_matches_jax():
    """V control on flat ground, 4 envs, three control steps: the port env
    (per-substep torques from the control step's ``last_dof_vel``, one
    physics launch per substep) against the JAX env with the ABA solver."""
    n = 4
    c = v_control(jcfg(n))
    c.sim.solver = "aba"
    jenv = JEnv(c)
    env = AnymalCTrajGradSampling(v_control(anymal_c_traj_sampling_cfg(n)), device="cpu")
    assert env.decimated_step is None and not env.substep.rough
    jstep = jax.jit(jenv.step)
    js = jenv.reset_all(jax.random.PRNGKey(4))
    s = to_torch_state(js)
    rng = np.random.default_rng(2)
    before = pk.EnvStep.launches, pk.DecimatedEnvStep.launches
    for i in range(3):
        a = rng.standard_normal((n, 12)).astype(np.float32)
        js = jstep(js, jnp.asarray(a))
        s = env.step(s, torch.as_tensor(a))
        assert not bool(np.asarray(js.reset_buf).any())
        for k in PHYS:
            np.testing.assert_allclose(getattr(s.phys, k).numpy(), np.asarray(getattr(js.phys, k)),
                                       atol=5e-3, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(s.torques.numpy(), np.asarray(js.torques), atol=0.5)
        np.testing.assert_allclose(s.obs.numpy(), np.asarray(js.obs), atol=1e-2, err_msg=f"obs {i}")
        np.testing.assert_allclose(s.rew.numpy(), np.asarray(js.rew), atol=1e-3, err_msg=f"rew {i}")
    assert float(s.torques.abs().max()) > 1.0                       # the V torques act
    # the CPU path runs the plain version: no kernel launch counted
    assert (pk.EnvStep.launches, pk.DecimatedEnvStep.launches) == before
