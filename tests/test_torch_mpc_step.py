"""One full MPC cycle (optimize -> execute -> shift with the warm-start
policy's tail) of the port against the JAX package (ABA solver) at E=2 main
envs, S=8 samples, H=4 dense steps.

The JAX cycle's sampling noise is re-drawn from its own key and injected into
the port.  The executed step and the shifted plan are compared to 2e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from extended_legged_gym_tpu.robots.anymal_c_traj import AnymalCTrajGradSampling as JEnv
from extended_legged_gym_tpu.robots.anymal_c_traj import anymal_c_traj_sampling_cfg as jcfg
from extended_legged_gym_tpu_torch.robots.anymal_c_traj import (AnymalCTrajGradSampling,
                                                               anymal_c_traj_sampling_cfg)
from test_torch_env import PHYS, to_torch_state
from test_torch_mpc import CKPT

E, NS, HS, HN, ND = 2, 7, 4, 2, 1


def _small(cfg):
    to = cfg.trajectory_opt
    to.num_samples, to.horizon_samples, to.horizon_nodes = NS, HS, HN
    to.num_diffuse_steps, to.polish_iters = ND, 1
    cfg.rl_warmstart.policy_checkpoint = CKPT
    return cfg


def test_mpc_step_matches_jax():
    c = _small(jcfg(E))
    c.sim.solver = "aba"
    jenv = JEnv(c)
    jenv.setup_rl_warmstart()
    env = AnymalCTrajGradSampling(_small(anymal_c_traj_sampling_cfg(E)), device="cpu")
    env.setup_rl_warmstart()
    js = jenv.reset_all(jax.random.PRNGKey(4))
    s = to_torch_state(js)
    nodes = (0.2 * np.random.default_rng(5).standard_normal((E, HN + 1, 12))).astype(np.float32)
    key = jax.random.PRNGKey(6)

    js2, jnodes, _ = jax.jit(jenv.mpc_step)(js, jnp.asarray(nodes), key)
    k_opt, _ = jax.random.split(key)
    noise = np.stack([np.asarray(jax.random.normal(k, (E, NS, HN + 1, 12)))
                      for k in jax.random.split(k_opt, ND)])

    optimize = env.optimize_all_trajectories
    env.optimize_all_trajectories = lambda state, nd, generator=None, n_diffuse=None: optimize(
        state, nd, generator, n_diffuse=n_diffuse, noise=torch.as_tensor(noise))
    s2, tnodes, _ = env.mpc_step(s, torch.as_tensor(nodes))
    assert not bool(np.asarray(js2.reset_buf).any()) and not bool(s2.reset_buf.any())
    for k in PHYS:
        np.testing.assert_allclose(getattr(s2.phys, k).numpy(), np.asarray(getattr(js2.phys, k)),
                                   atol=2e-3, err_msg=k)
    np.testing.assert_allclose(s2.actions.numpy(), np.asarray(js2.actions), atol=2e-3)
    np.testing.assert_allclose(s2.rew.numpy(), np.asarray(js2.rew), atol=1e-3)
    np.testing.assert_allclose(tnodes.numpy(), np.asarray(jnodes), atol=2e-3)
