"""Recurrent PPO against the JAX package, on the CPU at a small size: the
recurrent actor-critic (LSTM and GRU) on JAX parameters over carried steps
with resets; ``ppo_update_recurrent`` with the JAX minibatch permutations
injected; one recurrent runner iteration (GRU, anymal_c_flat with the ABA
solver, 16 envs, T = 8) against the JAX runner's with its action noise and
permutations injected; checkpoints both ways, with the RND state.

Tolerances: the network 1e-5 absolute over 5 steps; the update 1e-4 of each
tensor's largest magnitude and the losses 1e-4 relative
(tests/test_torch_ppo.py's full-update bounds); the runner iteration
tests/test_torch_runner.py's (step reward 1e-4, parameters 2e-3 of each
tensor's largest magnitude, losses 1e-3 relative, learning rate 1e-6
relative); the checkpoint round trips 1e-5 on actions."""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.envs.legged_robot import LeggedRobot as JLeggedRobot
from extended_legged_gym_tpu.models.networks import ActorCriticRecurrent as JACR
from extended_legged_gym_tpu.models.networks import gaussian_log_prob as jlog_prob
from extended_legged_gym_tpu.models.networks import rnn_carry as jrnn_carry
from extended_legged_gym_tpu.rl import ppo as jppo
from extended_legged_gym_tpu.rl.runner import OnPolicyRunner as JRunner
from extended_legged_gym_tpu.robots.anymal_c import anymal_c_flat_cfg as janymal_c_flat_cfg
from extended_legged_gym_tpu.robots.anymal_c import anymal_c_ppo_cfg as janymal_c_ppo_cfg
from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
from extended_legged_gym_tpu_torch.models.networks import (ActorCriticRecurrent, flax_tree,
                                                           load_jax_checkpoint, mask_carry,
                                                           params_from_jax, params_to_jax)
from extended_legged_gym_tpu_torch.rl import ppo
from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_flat_cfg, anymal_c_ppo_cfg
from torch_parity import to_torch_state

OBS, A, H, HID = 10, 4, 16, (32, 16)
T, B = 8, 16


def jnp_(x):
    return jnp.asarray(np.asarray(x))


def to_t(c):
    return tuple(torch.as_tensor(np.array(x)) for x in c) if isinstance(c, tuple) \
        else torch.as_tensor(np.array(c))


def both_nets(rnn_type, seed=0):
    jnet = JACR(num_actions=A, actor_hidden_dims=HID, critic_hidden_dims=HID,
                rnn_hidden_size=H, rnn_type=rnn_type)
    ca = jrnn_carry(rnn_type, H, (1,))
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS)), ca, ca, jnp.zeros((1, OBS)))
    net = ActorCriticRecurrent(OBS, A, HID, HID, rnn_hidden_size=H, rnn_type=rnn_type)
    net.load_state_dict(params_from_jax(jax.device_get(params)))
    return jnet, params, net


def assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), (path, sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{path}/{k}")


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_network_matches_jax_over_carried_steps(rnn_type):
    """Five steps, the carries zeroed for the envs a random done hits; the
    flax tree of the port's module is the JAX parameter tree."""
    jnet, params, net = both_nets(rnn_type)
    assert_trees_equal(flax_tree(net), jax.device_get(params)["params"])
    rng = np.random.default_rng(1)
    jc = (jrnn_carry(rnn_type, H, (B,)),) * 2
    c = net.initialize_carries((B,))
    for _ in range(5):
        x = rng.standard_normal((B, OBS)).astype(np.float32)
        jm, js, jv, jca, jcc = jnet.apply(params, jnp_(x), jc[0], jc[1], jnp_(x))
        m, s, v, ca, cc = net(torch.as_tensor(x), c[0], c[1], torch.as_tensor(x))
        np.testing.assert_allclose(m.detach().numpy(), np.asarray(jm), atol=1e-5)
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), atol=1e-5)
        for a_, b_ in zip(jax.tree.leaves((ca, cc)), jax.tree.leaves((jca, jcc))):
            np.testing.assert_allclose(a_.detach().numpy(), np.asarray(b_), atol=1e-5)
        d = rng.random(B) < 0.3
        keep = jnp_(1.0 - d)[:, None]
        jc = jax.tree.map(lambda h: h * keep, (jca, jcc))
        c = tuple(mask_carry(x_, torch.as_tensor(d)) for x_ in (ca, cc))
    mean, carry = net.act_inference(torch.as_tensor(x), c[0])
    np.testing.assert_allclose(mean.detach().numpy(),
                               np.asarray(jnet.apply(params, jnp_(x), jc[0], jc[1], jnp_(x))[0]),
                               atol=1e-5)


def test_ppo_update_recurrent_matches_jax():
    """5 epochs x 4 minibatches of 4 envs, each replaying the 8-step window
    from random window-start carries with resets where episodes ended."""
    jnet, params, net = both_nets("lstm", seed=3)
    rng = np.random.default_rng(5)
    obs = rng.standard_normal((T, B, OBS)).astype(np.float32)
    dones = rng.random((T, B)) < 0.15
    c0 = tuple(0.3 * rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    carries0 = (c0, tuple(0.5 * x for x in c0))
    ca, cc = jax.tree.map(jnp_, carries0)
    rows = {k: [] for k in ("mu", "values", "actions", "log_probs")}
    for t in range(T):
        m, s, v, ca, cc = jnet.apply(params, jnp_(obs[t]), ca, cc, jnp_(obs[t]))
        act = m + s * jnp_(rng.standard_normal((B, A)).astype(np.float32))
        for k, x in (("mu", m), ("values", v), ("actions", act),
                     ("log_probs", jlog_prob(m, s, act))):
            rows[k].append(x)
        keep = jnp_(1.0 - dones[t])[:, None]
        ca, cc = jax.tree.map(lambda h: h * keep, (ca, cc))
    st = {k: jnp.stack(v) for k, v in rows.items()}
    batch = jppo.Transition(obs=jnp_(obs), critic_obs=jnp_(obs), actions=st["actions"],
                            rewards=jnp_(rng.standard_normal((T, B)).astype(np.float32)),
                            dones=jnp_(dones), values=st["values"], log_probs=st["log_probs"],
                            mu=st["mu"], sigma=jnp.broadcast_to(s, (T, A)))
    adv, ret = jppo.compute_gae(batch.rewards, batch.dones, batch.values,
                                jnp_(rng.standard_normal(B).astype(np.float32)), 0.99, 0.95)
    jcfg = jppo.PPOConfig(learning_rate=1e-3)
    opt = jppo.make_optimizer(jcfg)
    key = jax.random.PRNGKey(13)
    jst, jm = jppo.ppo_update_recurrent(
        jnet, jcfg, jppo.PPOState(params, opt.init(params), jnp.asarray(1e-3)), batch,
        jax.tree.map(jnp_, carries0), adv, ret, key, opt)

    cfg = ppo.PPOConfig(learning_rate=1e-3)
    perms = [torch.tensor(np.asarray(jax.random.permutation(k, B)))
             for k in jax.random.split(key, cfg.num_learning_epochs)]
    tb = ppo.Transition(**{k: torch.as_tensor(np.array(getattr(batch, k)))
                           for k in ppo.Transition.__dataclass_fields__})
    lr, m = ppo.ppo_update_recurrent(
        net, cfg, ppo.Adam(net.parameters(), cfg.max_grad_norm), tb,
        tuple(to_t(c) for c in carries0), torch.as_tensor(np.array(adv)),
        torch.as_tensor(np.array(ret)), torch.tensor(1e-3), perms=perms)
    want = jax.device_get(jst.params)["params"]
    got = flax_tree(net)
    for k in ("memory_a", "memory_c", "actor", "critic", "log_std"):
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want[k]),
                                jax.tree_util.tree_leaves(got[k])):
            np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), err_msg=f"{k}{path}")
    for k in ("loss", "value_loss", "surrogate_loss", "entropy", "kl"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(lr), float(jm["learning_rate"]), rtol=1e-6)
    assert float(m["nonfinite_skips"]) == 0.0


def quiet(cfg):
    cfg.env.num_envs = B
    cfg.noise.add_noise = False
    cfg.domain_rand.randomize_friction = cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.push_robots = False
    return cfg


def small(tc, rnd=False):
    tc.seed = 3
    tc.runner.num_steps_per_env = T
    tc.runner.policy_class_name = "ActorCriticRecurrent"
    tc.policy.rnn_type, tc.policy.rnn_hidden_size = "gru", H
    tc.policy.actor_hidden_dims = tc.policy.critic_hidden_dims = list(HID)
    if rnd:
        tc.algorithm.rnd_cfg = {"weight": 0.5, "hidden_dims": [16, 16], "num_outputs": 8}
    return tc


@pytest.fixture(scope="module")
def jax_runner():
    jc = quiet(janymal_c_flat_cfg())
    jc.sim.solver = "aba"
    return JRunner(JLeggedRobot(jc), small(janymal_c_ppo_cfg()))


@pytest.fixture(scope="module")
def env():
    return LeggedRobot(quiet(anymal_c_flat_cfg()), device="cpu")


def port_from_jax(env, ts, rnd=False):
    runner = OnPolicyRunner(env, small(anymal_c_ppo_cfg(), rnd))
    runner.env_state = to_torch_state(ts.env_state)
    runner.network.load_state_dict(params_from_jax(jax.device_get(ts.ppo.params)))
    runner.carries = tuple(to_t(c) for c in ts.carries)
    return runner


def test_recurrent_iteration_matches_jax(jax_runner, env):
    ts0 = jax_runner.state
    ts1, jm = jax_runner._train_iter(ts0)
    runner = port_from_jax(env, ts0)
    _, k_collect, k_update = jax.random.split(ts0.key, 3)
    noise = torch.as_tensor(np.stack([np.asarray(jax.random.normal(k, (B, 12)))
                                      for k in jax.random.split(k_collect, T)]))
    perms = [torch.tensor(np.asarray(jax.random.permutation(k, B)))
             for k in jax.random.split(k_update, runner.ppo_cfg.num_learning_epochs)]
    m = runner.train_iteration(action_noise=noise, perms=perms)
    np.testing.assert_allclose(float(m["mean_step_reward"]), float(jm["mean_step_reward"]),
                               atol=1e-4)
    for k in ("loss", "value_loss", "surrogate_loss", "entropy", "kl"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(float(m["learning_rate"]), float(jm["learning_rate"]), rtol=1e-6)
    assert set(m) >= set(jm)
    want = jax.device_get(ts1.ppo.params)["params"]
    got = params_to_jax(runner.network)["params"]
    for k in want:
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want[k]),
                                jax.tree_util.tree_leaves(got[k])):
            np.testing.assert_allclose(g, w, atol=2e-3 * np.abs(w).max(), err_msg=f"{k}{path}")
    # the carries at the window's end, as the JAX runner's
    np.testing.assert_allclose(runner.carries[0].numpy(), np.asarray(ts1.carries[0]), atol=1e-3)


def test_symmetry_with_a_recurrent_policy_is_refused(env):
    """The JAX runner drops symmetry_cfg silently for a recurrent policy
    (its recurrent update takes no symmetry term); the port refuses it."""
    tc = small(anymal_c_ppo_cfg())
    tc.algorithm.symmetry_cfg = {"obs_perm": list(range(48)), "obs_signs": [1.0] * 48,
                                 "act_perm": list(range(12)), "act_signs": [1.0] * 12}
    with pytest.raises(ValueError, match="symmetry"):
        OnPolicyRunner(env, tc)


def test_checkpoints_both_ways(jax_runner, env, tmp_path):
    """The port's recurrent checkpoint (with RND) is read by the JAX runner,
    whose policy then acts as the port's over two carried steps; the JAX
    runner's checkpoint loads into the port; the port's RND state comes back
    whole."""
    port = port_from_jax(env, jax_runner.state, rnd=True)
    port.train_iteration()
    path = str(tmp_path / "model_1.pkl")
    port.save(path)
    jr = JRunner(jax_runner.env, small(janymal_c_ppo_cfg()))
    jr.load(path)
    obs = np.random.default_rng(0).standard_normal((2, B, 48)).astype(np.float32)
    jpol, pol = jr.get_inference_policy(), port.get_inference_policy()
    jc = jr.initial_carries(B)
    for t in range(2):
        ja, jc = jpol(jnp_(obs[t]), jc)
        np.testing.assert_allclose(pol(torch.as_tensor(obs[t])).numpy(), np.asarray(ja), atol=1e-5)

    fresh = OnPolicyRunner(env, small(anymal_c_ppo_cfg(), rnd=True))
    fresh.load(path)
    for name in ("target", "predictor"):
        for a_, b_ in zip(getattr(port.rnd, name).parameters(),
                          getattr(fresh.rnd, name).parameters()):
            assert torch.equal(a_, b_)
    assert int(fresh.rnd.step) == int(port.rnd.step) == T
    assert torch.equal(fresh.rnd.state_norm.var, port.rnd.state_norm.var)
    assert torch.equal(fresh.rnd_optimizer.mu, port.rnd_optimizer.mu)

    jpath = str(tmp_path / "jax.pkl")
    jax_runner.save(jpath)
    sd, _ = load_jax_checkpoint(jpath)
    back = OnPolicyRunner(env, small(anymal_c_ppo_cfg()))
    back.load(jpath)
    assert all(torch.equal(back.network.state_dict()[k], v) for k, v in sd.items())
    with open(jpath, "rb") as f:
        jparams = pickle.load(f)["params"]
    assert_trees_equal(params_to_jax(back.network)["params"], jax.device_get(jparams)["params"])
