"""The port's sampling MPC against the JAX package (ABA solver) at a small
size: E=1 main env, S=8 samples, H=4 dense steps (Hnode=2).

The sampling noise of trajopt/sampling.py:109 is drawn from the JAX key the
JAX run uses and injected into the port, so both optimize over the same
samples.  Rewards to 1e-3 absolute; node trajectories to 2e-3 (the softmax
weights at temperature 0.1 amplify reward differences)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.robots.anymal_c_traj import AnymalCTrajGradSampling as JEnv
from extended_legged_gym_tpu.robots.anymal_c_traj import anymal_c_traj_sampling_cfg as jcfg
from extended_legged_gym_tpu_torch.robots.anymal_c_traj import (AnymalCTrajGradSampling,
                                                               anymal_c_traj_sampling_cfg)
from test_torch_env import to_torch_state

E, NS, HS, HN = 1, 7, 4, 2
CKPT = "logs/flat_anymal_c/Aug21_12-38-39_r5_ft4/model_final.pkl"


def _small(cfg):
    to = cfg.trajectory_opt
    to.num_samples, to.horizon_samples, to.horizon_nodes = NS, HS, HN
    to.num_diffuse_steps, to.polish_iters = 1, 1
    cfg.rl_warmstart.policy_checkpoint = CKPT
    return cfg


@pytest.fixture(scope="module")
def envs():
    c = _small(jcfg(E))
    c.sim.solver = "aba"
    jenv = JEnv(c)
    env = AnymalCTrajGradSampling(_small(anymal_c_traj_sampling_cfg(E)), device="cpu")
    js = jenv.reset_all(jax.random.PRNGKey(0))
    return jenv, env, js, to_torch_state(js)


def test_rollout_batch_rewards_match(envs):
    jenv, env, js, s = envs
    us = (0.5 * np.random.default_rng(0).standard_normal((E, NS + 1, HS + 1, 12))).astype(np.float32)
    want = np.asarray(jax.jit(jenv.rollout_batch)(js, jnp.asarray(us)))
    got = env.rollout_batch(s, torch.as_tensor(us)).numpy()
    assert got.shape == (E, NS + 1, HS + 1)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_optimize_all_trajectories_matches(envs):
    """One diffusion step + one fd polish iteration with injected noise."""
    jenv, env, js, s = envs
    nodes = (0.2 * np.random.default_rng(1).standard_normal((E, HN + 1, 12))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jnodes, jinfo = jax.jit(jenv.optimize_all_trajectories)(js, jnp.asarray(nodes), key)
    noise = np.stack([np.asarray(jax.random.normal(k, (E, NS, HN + 1, 12)))
                      for k in jax.random.split(key, 1)])
    tnodes, info = env.optimize_all_trajectories(s, torch.as_tensor(nodes),
                                                 noise=torch.as_tensor(noise))
    np.testing.assert_allclose(info["rew_mean"].numpy(), np.asarray(jinfo["rew_mean"]), atol=1e-3)
    np.testing.assert_allclose(info["polish_gain"].numpy(), np.asarray(jinfo["polish_gain"]), atol=2e-3)
    np.testing.assert_allclose(tnodes.numpy(), np.asarray(jnodes), atol=2e-3)
    # the executing node stays pinned (up to the rounding of the weighted mean)
    np.testing.assert_allclose(tnodes[:, 0].numpy(), nodes[:, 0], atol=1e-6)


def test_warmstart_rollout_matches(envs):
    """init_trajectories_from_rl: the loaded actor rolled through the
    rollout env, fitted to nodes."""
    jenv, env, js, s = envs
    jenv.setup_rl_warmstart()
    env.setup_rl_warmstart()
    want = np.asarray(jax.jit(jenv.init_trajectories_from_rl)(js))
    got = env.init_trajectories_from_rl(s).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)
