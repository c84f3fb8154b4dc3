"""The ANYdrive actuator network and the SEA-actuated flat task against the
JAX package, on the CPU: the LSTM over 10 steps of carried hidden state; the
``anymal_c_flat_sea`` env (the JAX env on its ABA engine, the port's on the
plain version of its torques-in route) over several control steps with the
same actions, through a reset that zeroes the reset env's hidden state; the
committed SEA checkpoint's actions.

Tolerances: the LSTM's hidden state 1e-6 absolute (the same float32
products), its torque 1e-6 times the output scale 20 (a torque of 20 N m has
an ulp of 1.9e-6); the env's
states 5e-3, observations 1e-2 and rewards 1e-3 absolute
(tests/test_torch_env.py's), the hidden state 1e-3; actions 1e-5."""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.envs.legged_robot import LeggedRobot as JLeggedRobot
from extended_legged_gym_tpu.models.actuator_net import ActuatorNetLSTM as JActuatorNetLSTM
from extended_legged_gym_tpu.models.networks import ActorCritic as JActorCritic
from extended_legged_gym_tpu.robots.anymal_c import anymal_c_flat_sea_cfg as janymal_c_flat_sea_cfg
from extended_legged_gym_tpu_torch import robots  # noqa: F401
from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
from extended_legged_gym_tpu_torch.models.actuator_net import ActuatorNetLSTM
from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_flat_sea_cfg, anymal_c_ppo_cfg
from torch_parity import PHYS, to_torch_state

NET = "extended_legged_gym_tpu/robots/data/anydrive_v3_lstm.json"
SEA_CKPT = "logs/flat_sea_anymal_c/Aug21_07-18-55_r4_sea2/model_final.pkl"
E = 4


def test_lstm_matches_jax_over_carried_steps():
    jnet, net = JActuatorNetLSTM.from_json(NET), ActuatorNetLSTM.from_json(NET)
    assert (net.num_layers, net.hidden) == (jnet.num_layers, jnet.hidden) == (2, 8)
    rng = np.random.default_rng(0)
    jh, h = jnet.init_hidden((E, 12)), net.init_hidden((E, 12))
    for _ in range(10):
        x = (rng.standard_normal((E, 12, 2)) * [0.3, 4.0]).astype(np.float32)
        jtau, jh = jnet(jnp.asarray(x), jh)
        tau, h = net(torch.as_tensor(x), h)
        np.testing.assert_allclose(tau.numpy(), np.asarray(jtau), atol=20 * 1e-6)
        for a, b in zip(h, jh):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert float(np.abs(np.asarray(jh[1])).max()) > 0.1       # the cell state moved


def quiet(cfg):
    cfg.env.num_envs = E
    cfg.noise.add_noise = False
    cfg.domain_rand.randomize_friction = cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.push_robots = False
    return cfg


@pytest.fixture(scope="module")
def envs():
    jc = quiet(janymal_c_flat_sea_cfg())
    jc.sim.solver = "aba"
    jenv = JLeggedRobot(jc)
    return jenv, LeggedRobot(quiet(anymal_c_flat_sea_cfg()), device="cpu"), jax.jit(jenv.step)


def with_hidden(s, js):
    return s.replace(actuator_hidden=tuple(torch.as_tensor(np.array(h))
                                           for h in js.actuator_hidden))


def test_env_routes_the_network_through_the_torques_in_step(envs):
    _, env, _ = envs
    assert env.actuator_net is not None and env.decimated_step is None
    assert isinstance(env.substep, pk.EnvStep) and not env.substep.rough
    s = env.reset_all(seed=0)
    assert tuple(s.actuator_hidden[0].shape) == (E, 12, 2, 8)


def test_sea_env_matches_jax_through_a_reset(envs):
    """Five control steps from the JAX reset state with the same actions,
    then a step in which env 0 times out: the port's hidden state is zeroed
    for env 0 only, as the JAX env's is, and the other envs keep matching."""
    jenv, env, jstep = envs
    js = jenv.reset_all(jax.random.PRNGKey(3))
    s = with_hidden(to_torch_state(js), js)
    rng = np.random.default_rng(1)
    for k in range(6):
        if k == 5:
            el = js.episode_length.at[0].set(jenv.max_episode_length)
            js = js.replace(episode_length=el)
            s = s.replace(episode_length=torch.as_tensor(np.array(el)).to(torch.int64))
        a = (0.5 * rng.standard_normal((E, 12))).astype(np.float32)
        js = jstep(js, jnp.asarray(a))
        s = env.step(s, torch.as_tensor(a))
        keep = slice(1, E) if k == 5 else slice(0, E)
        for name in PHYS:
            np.testing.assert_allclose(getattr(s.phys, name)[keep].numpy(),
                                       np.asarray(getattr(js.phys, name))[keep], atol=5e-3,
                                       err_msg=f"step {k} {name}")
        for a_, b_ in zip(s.actuator_hidden, js.actuator_hidden):
            np.testing.assert_allclose(a_[keep].numpy(), np.asarray(b_)[keep], atol=1e-3)
        np.testing.assert_allclose(s.torques.numpy(), np.asarray(js.torques), atol=5e-2)
        np.testing.assert_allclose(s.obs[keep].numpy(), np.asarray(js.obs)[keep], atol=1e-2)
        np.testing.assert_allclose(s.rew.numpy(), np.asarray(js.rew), atol=1e-3)
    assert bool(s.reset_buf[0]) and bool(np.asarray(js.reset_buf)[0])
    assert not bool(s.reset_buf[1:].any())
    for a_, b_ in zip(s.actuator_hidden, js.actuator_hidden):
        assert float(a_[0].abs().max()) == float(np.abs(np.asarray(b_)[0]).max()) == 0.0
        assert float(a_[1:].abs().max()) > 0.0


def test_committed_sea_checkpoint_acts_as_in_jax(envs):
    _, env, _ = envs
    runner = OnPolicyRunner(env, anymal_c_ppo_cfg("flat_sea_anymal_c"))
    payload = runner.load(SEA_CKPT)
    assert payload["iteration"] == runner.iteration
    with open(SEA_CKPT, "rb") as f:
        params = pickle.load(f)["params"]
    jnet = JActorCritic(num_actions=12, actor_hidden_dims=(128, 64, 32),
                        critic_hidden_dims=(128, 64, 32))
    obs = np.random.default_rng(2).standard_normal((32, 48)).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(obs), method=jnet.act_inference))
    got = runner.get_inference_policy()(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
