"""The port's PPO (GAE, the update with adaptive-KL learning rate, global-norm
clipping, Adam and the non-finite guard) and RunningNorm against the JAX
package's, on the CPU at a small size: T = 8 steps of 16 envs, 10-dim
observations, 4 actions, [32, 16] actor and critic.

The parameters start from a flax initialisation carried across by
``params_from_jax``; the JAX update's minibatch permutations are recomputed
from its key (``jax.random.split(key, epochs)``, then
``jax.random.permutation``) and injected into the port.

Tolerances: GAE 1e-5 absolute; one minibatch step 1e-6 absolute on the
parameters; the full 5 x 4 update 1e-4 of each tensor's largest magnitude
(float32 sums in another order, moved through 20 Adam steps) and the same
final learning rate to 1e-6 relative; RunningNorm 1e-5 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.models.networks import ActorCritic as JActorCritic
from extended_legged_gym_tpu.models.networks import RunningNorm as JRunningNorm
from extended_legged_gym_tpu.models.networks import gaussian_log_prob as jlog_prob
from extended_legged_gym_tpu.rl import ppo as jppo
from extended_legged_gym_tpu_torch.models.networks import (ActorCritic, RunningNorm,
                                                           params_from_jax, params_to_jax)
from extended_legged_gym_tpu_torch.rl import ppo

T, B, OBS, A, HID = 8, 16, 10, 4, (32, 16)


def jax_perms(key, epochs, n):
    return [np.asarray(jax.random.permutation(k, n)) for k in jax.random.split(key, epochs)]


def make_batch(seed, params, jnet, nan_reward=False):
    """A collected batch from the JAX network on seeded observations (the
    actions drawn around its mean), with GAE from the JAX function."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((T, B, OBS)).astype(np.float32)
    mean, std, value = jnet.apply(params, jnp.asarray(obs))
    actions = mean + std * jnp.asarray(rng.standard_normal((T, B, A)).astype(np.float32))
    rewards = rng.standard_normal((T, B)).astype(np.float32)
    if nan_reward:
        rewards[3, 5] = np.nan
    dones = rng.random((T, B)) < 0.1
    batch = jppo.Transition(obs=jnp.asarray(obs), critic_obs=jnp.asarray(obs), actions=actions,
                            rewards=jnp.asarray(rewards), dones=jnp.asarray(dones), values=value,
                            log_probs=jlog_prob(mean, std, actions), mu=mean,
                            sigma=jnp.broadcast_to(std, (T, A)))
    last_value = jnp.asarray(rng.standard_normal(B).astype(np.float32))
    adv, ret = jppo.compute_gae(batch.rewards, batch.dones, batch.values, last_value, 0.99, 0.95)
    return batch, adv, ret


def to_torch_batch(batch):
    t = lambda x: torch.as_tensor(np.array(x))
    return ppo.Transition(**{k: t(getattr(batch, k)) for k in ppo.Transition.__dataclass_fields__})


def run_both(cfg_kw, seed=0, nan_reward=False, mutate=None):
    """One ``ppo_update`` of each package from the same parameters and batch:
    ``(jax params, port params, jax metrics, port metrics)``."""
    jnet = JActorCritic(num_actions=A, actor_hidden_dims=HID, critic_hidden_dims=HID)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS)), jnp.zeros((1, OBS)))
    batch, adv, ret = make_batch(seed, params, jnet, nan_reward)
    if mutate is not None:
        batch = mutate(batch)
    jcfg = jppo.PPOConfig(**cfg_kw)
    opt = jppo.make_optimizer(jcfg)
    st = jppo.PPOState(params=params, opt_state=opt.init(params),
                       learning_rate=jnp.asarray(jcfg.learning_rate))
    key = jax.random.PRNGKey(seed + 100)
    jst, jm = jppo.ppo_update(jnet, jcfg, st, batch, adv, ret, key, opt)

    net = ActorCritic(OBS, A, HID, HID)
    net.load_state_dict(params_from_jax(jax.device_get(params)))
    cfg = ppo.PPOConfig(**cfg_kw)
    adam = ppo.Adam(net.parameters(), cfg.max_grad_norm)
    lr, m = ppo.ppo_update(net, cfg, adam, to_torch_batch(batch), torch.as_tensor(np.array(adv)),
                           torch.as_tensor(np.array(ret)), torch.tensor(cfg.learning_rate),
                           perms=[torch.tensor(p) for p in
                                  jax_perms(key, cfg.num_learning_epochs, T * B)])
    return jax.device_get(jst.params), params_to_jax(net), jm, m, jax.device_get(params)


def leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_compute_gae_matches_jax():
    rng = np.random.default_rng(0)
    rewards = rng.standard_normal((T, B)).astype(np.float32)
    values = rng.standard_normal((T, B)).astype(np.float32)
    last = rng.standard_normal(B).astype(np.float32)
    dones = rng.random((T, B)) < 0.2
    timeouts = dones & (rng.random((T, B)) < 0.5)
    # the runner folds the timeout bootstrap into the rewards before GAE
    rewards = rewards + 0.99 * values * timeouts
    ja, jr = jppo.compute_gae(jnp.asarray(rewards), jnp.asarray(dones), jnp.asarray(values),
                              jnp.asarray(last), 0.99, 0.95)
    a, r = ppo.compute_gae(torch.as_tensor(rewards), torch.as_tensor(dones),
                           torch.as_tensor(values), torch.as_tensor(last), 0.99, 0.95)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5)


def test_one_minibatch_step_matches_jax():
    jp, tp, jm, m, p0 = run_both(dict(num_learning_epochs=1, num_mini_batches=1))
    for (path, want), (_, got), (_, start) in zip(leaves(jp), leaves(tp), leaves(p0)):
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=str(path))
        assert np.abs(want - start).max() > 1e-5, path                 # the step moved it
    for k in ("loss", "value_loss", "surrogate_loss", "entropy", "kl"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", ["small_steps", "large_kl"])
def test_full_update_matches_jax(case):
    """5 epochs x 4 minibatches.  From a learning rate of 1e-5 the KL stays
    small and the rate rises; with the stored means shifted the KL is large
    and it falls from 1e-3."""
    def shift(batch):
        return batch._replace(mu=batch.mu + 0.5)

    lr0 = 1e-5 if case == "small_steps" else 1e-3
    jp, tp, jm, m, _ = run_both(dict(learning_rate=lr0), seed=1,
                                mutate=shift if case == "large_kl" else None)
    for (path, want), (_, got) in zip(leaves(jp), leaves(tp)):
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), err_msg=str(path))
    lr = float(m["learning_rate"])
    np.testing.assert_allclose(lr, float(jm["learning_rate"]), rtol=1e-6)
    assert (lr > lr0) if case == "small_steps" else (lr < lr0), lr       # the rate moved
    assert float(m["nonfinite_skips"]) == float(jm["nonfinite_skips"]) == 0.0


def test_nonfinite_reward_skips_the_step_in_both():
    """A NaN reward makes every minibatch's loss non-finite (advantages are
    normalised over the batch): both packages skip all 20 steps and leave
    the parameters as they were."""
    jp, tp, jm, m, p0 = run_both(dict(), seed=2, nan_reward=True)
    assert float(m["nonfinite_skips"]) == float(jm["nonfinite_skips"]) == 20.0
    for (path, want), (_, got), (_, start) in zip(leaves(jp), leaves(tp), leaves(p0)):
        np.testing.assert_array_equal(want, start, err_msg=str(path))
        np.testing.assert_array_equal(got, start, err_msg=str(path))


def test_adam_guard_keeps_state_on_skip():
    net = ActorCritic(OBS, A, HID, HID)
    adam = ppo.Adam(net.parameters(), 1.0)
    before = adam.flat_params().clone()
    grads = [torch.ones_like(p) for p in adam.params]
    adam.step(grads, torch.tensor(1e-3), torch.tensor(False))
    assert torch.equal(adam.flat_params(), before) and float(adam.count) == 0.0
    assert float(adam.mu.abs().sum()) == 0.0
    adam.step(grads, torch.tensor(1e-3), torch.tensor(True))
    assert float(adam.count) == 1.0 and not torch.equal(adam.flat_params(), before)


def test_running_norm_matches_jax():
    """Two updates and a normalisation; the variance is the population one
    (``jnp.var``, ddof 0; ``torch.var`` would default to ddof 1)."""
    rng = np.random.default_rng(3)
    x1 = (3.0 + 2.0 * rng.standard_normal((T, B, OBS))).astype(np.float32)
    x2 = (1.0 + 0.5 * rng.standard_normal((T, B, OBS))).astype(np.float32)
    jn = JRunningNorm.create(OBS).update(jnp.asarray(x1)).update(jnp.asarray(x2))
    tn = RunningNorm.create(OBS).update(torch.as_tensor(x1)).update(torch.as_tensor(x2))
    np.testing.assert_allclose(tn.mean.numpy(), np.asarray(jn.mean), rtol=1e-5)
    np.testing.assert_allclose(tn.var.numpy(), np.asarray(jn.var), rtol=1e-5)
    assert float(tn.count) == float(jn.count) == 2 * T * B
    np.testing.assert_allclose(tn.normalize(torch.as_tensor(x2)).numpy(),
                               np.asarray(jn.normalize(jnp.asarray(x2))), rtol=1e-5, atol=1e-5)
    # past ``until`` the statistics stay
    frozen = RunningNorm.create(OBS, until=1).update(torch.as_tensor(x1))
    assert torch.equal(frozen.update(torch.as_tensor(x2)).mean, frozen.mean)


def test_initialisation_is_flax_lecun_normal():
    """Zero biases, log_std = log(init_noise_std), weights a truncated normal
    (|w| <= 2 sigma) with standard deviation sqrt(1 / fan_in), as flax's."""
    net = ActorCritic(48, 12, (128, 64, 32), (128, 64, 32), init_noise_std=0.8,
                      generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(net.log_std.detach().numpy(), np.log(0.8), rtol=1e-6)
    jnet = JActorCritic(num_actions=12, actor_hidden_dims=(128, 64, 32),
                        critic_hidden_dims=(128, 64, 32))
    jp = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 48)), jnp.zeros((1, 48)))["params"]
    for m, (path, jk) in zip([m for m in net.modules() if isinstance(m, torch.nn.Linear)],
                             [(p, v) for p, v in leaves(jp) if "kernel" in str(p)]):
        w, fan_in = m.weight.detach().numpy(), m.weight.shape[1]
        assert not m.bias.detach().any()
        sigma = np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert np.abs(w).max() <= 2 * sigma + 1e-6
        if w.size >= 2000:           # the sample std of a layer, within 5% of flax's
            np.testing.assert_allclose(w.std(), np.sqrt(1.0 / fan_in), rtol=0.05)
            np.testing.assert_allclose(np.asarray(jk).std(), np.sqrt(1.0 / fan_in), rtol=0.05)
