"""The warm-start actor carried across by load_jax_checkpoint against the JAX
ActorCritic on the committed checkpoint (float32, 1e-5)."""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.models.networks import ActorCritic as JActorCritic
from extended_legged_gym_tpu_torch.models.networks import ActorCritic, load_jax_checkpoint

CKPT = "logs/flat_anymal_c/Aug21_12-38-39_r5_ft4/model_final.pkl"


@pytest.fixture(scope="module")
def nets():
    jnet = JActorCritic(num_actions=12, actor_hidden_dims=(128, 64, 32),
                        critic_hidden_dims=(128, 64, 32), activation="elu")
    with open(CKPT, "rb") as f:
        params = pickle.load(f)["params"]
    net = ActorCritic(48, 12, (128, 64, 32), (128, 64, 32), "elu")
    state_dict, obs_norm = load_jax_checkpoint(CKPT)
    assert obs_norm is None
    net.load_state_dict(state_dict)
    return jnet, params, net


def test_actor_matches_jax(nets):
    jnet, params, net = nets
    obs = np.random.default_rng(0).standard_normal((64, 48)).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(obs), method=jnet.act_inference))
    with torch.no_grad():
        got = net.act_inference(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_critic_and_std_match_jax(nets):
    jnet, params, net = nets
    obs = np.random.default_rng(1).standard_normal((8, 48)).astype(np.float32)
    _, jstd, jval = jnet.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        val = net.critic(torch.as_tensor(obs))[..., 0].numpy()
    np.testing.assert_allclose(val, np.asarray(jval), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(net.log_std.exp().detach().numpy(), np.asarray(jstd), rtol=1e-6)
