"""RND and symmetry augmentation against the JAX package, on the CPU at a
small size (10-dim states, (16, 16) -> 8 networks; T = 8 steps of 16 envs,
4 actions, [32, 16] actor and critic for PPO).

The RND networks start from the JAX module's initialisation
(``load_flax_tree``); the PPO minibatch permutations are recomputed from the
JAX key and injected.  Tolerances: the intrinsic rewards and normalizers
1e-5 relative plus 1e-6 absolute; the weight schedules 1e-7 relative; one
predictor Adam step 1e-6 absolute on the parameters, its loss 1e-5
relative; the 5 x 4 PPO update with the symmetry term 1e-4 of each tensor's
largest magnitude and the losses 1e-4 relative (tests/test_torch_ppo.py's
full-update bounds)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from extended_legged_gym_tpu.models.networks import ActorCritic as JActorCritic
from extended_legged_gym_tpu.models.networks import gaussian_log_prob as jlog_prob
from extended_legged_gym_tpu.models.rnd import RandomNetworkDistillation as JRND
from extended_legged_gym_tpu.rl import ppo as jppo
from extended_legged_gym_tpu_torch.models.networks import (ActorCritic, load_flax_tree,
                                                           params_from_jax, params_to_jax)
from extended_legged_gym_tpu_torch.models.rnd import RandomNetworkDistillation
from extended_legged_gym_tpu_torch.rl import ppo
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_symmetry_cfg

S, OUT, HID_RND = 10, 8, (16, 16)
T, B, A, HID = 8, 16, 4, (32, 16)


def both_rnd(weight=0.5, schedule=None):
    jr = JRND(num_states=S, num_outputs=OUT, hidden_dims=HID_RND, weight=weight,
              weight_schedule=schedule)
    js = jr.init(jax.random.PRNGKey(7))
    r = RandomNetworkDistillation(S, OUT, HID_RND, weight, schedule)
    load_flax_tree(r.target, jax.device_get(js.target_params)["params"])
    load_flax_tree(r.predictor, jax.device_get(js.predictor_params)["params"])
    return jr, js, r


def states(seed, n=32):
    return (2.0 + 3.0 * np.random.default_rng(seed).standard_normal((n, S))).astype(np.float32)


def test_intrinsic_reward_and_normalizers_match_jax():
    """Three calls: each updates the state normalizer before normalizing and
    the reward normalizer before scaling; the step counts the calls."""
    jr, js, r = both_rnd()
    assert not any(p.requires_grad for p in r.target.parameters())
    for k in range(3):
        x = states(k)
        jrew, js = jr.intrinsic_reward(js, jnp.asarray(x))
        rew = r.intrinsic_reward(torch.as_tensor(x))
        np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), rtol=1e-5, atol=1e-6)
        for norm, jnorm in ((r.state_norm, js.state_norm), (r.reward_norm, js.reward_norm)):
            np.testing.assert_allclose(norm.mean.numpy(), np.asarray(jnorm.mean), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(norm.var.numpy(), np.asarray(jnorm.var), rtol=1e-5,
                                       atol=1e-6)
            assert float(norm.count) == float(jnorm.count)
    assert int(r.step) == int(js.step) == 3
    assert float(rew.abs().max()) > 0.1


@pytest.mark.parametrize("schedule", [
    None, {"mode": "step", "final_step": 5, "final_value": 0.1},
    {"mode": "linear", "initial_step": 2, "final_step": 12, "final_value": 2.0}],
    ids=["constant", "step", "linear"])
def test_weight_schedules_match_jax(schedule):
    jr, _, r = both_rnd(weight=0.5, schedule=schedule)
    got = [float(r.weight_at(torch.tensor(k))) for k in (0, 2, 4, 5, 7, 12, 30)]
    want = [float(jr._weight_at(jnp.asarray(k, jnp.int32))) for k in (0, 2, 4, 5, 7, 12, 30)]
    np.testing.assert_allclose(got, want, rtol=1e-7)
    assert len(set(got)) == {None: 1, "step": 2, "linear": 5}[schedule and schedule["mode"]]


def test_predictor_step_matches_jax():
    """One Adam step (optax.adam, no clipping) on the predictor loss over a
    flattened window, with the state normalizer as collection left it."""
    jr, js, r = both_rnd()
    for k in range(2):
        x = states(k)
        _, js = jr.intrinsic_reward(js, jnp.asarray(x))
        r.intrinsic_reward(torch.as_tensor(x))
    window = states(9, 64)
    opt = optax.adam(1e-3)
    loss_fn = lambda p: jr.predictor_loss(p, js, jnp.asarray(window))
    jloss, grads = jax.value_and_grad(loss_fn)(js.predictor_params)
    upd, _ = opt.update(grads, opt.init(js.predictor_params), js.predictor_params)
    jparams = jax.device_get(optax.apply_updates(js.predictor_params, upd))["params"]

    adam = ppo.Adam(r.predictor.parameters(), float("inf"))
    loss = r.predictor_loss(torch.as_tensor(window))
    adam.step(torch.autograd.grad(loss, adam.params), torch.tensor(1e-3), torch.tensor(True))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for k in range(3):
        lin = getattr(r.predictor, f"Dense_{k}")
        np.testing.assert_allclose(lin.weight.detach().numpy().T, jparams[f"Dense_{k}"]["kernel"],
                                   atol=1e-6)
        np.testing.assert_allclose(lin.bias.detach().numpy(), jparams[f"Dense_{k}"]["bias"],
                                   atol=1e-6)


def test_anymal_symmetry_cfg_is_an_involution():
    """Mirroring twice is the identity; the mirror swaps left and right legs
    and flips the lateral components."""
    sc = anymal_c_symmetry_cfg()
    obs_m, act_m = (ppo.make_mirror_fns(sc[f"{k}_perm"], sc[f"{k}_signs"]) for k in ("obs", "act"))
    x = torch.randn(5, 48, generator=torch.Generator().manual_seed(0))
    a = torch.randn(5, 12, generator=torch.Generator().manual_seed(1))
    assert torch.equal(obs_m(obs_m(x)), x) and torch.equal(act_m(act_m(a)), a)
    assert torch.equal(obs_m(x)[:, 1], -x[:, 1]) and torch.equal(obs_m(x)[:, 10], -x[:, 10])


def test_ppo_update_with_symmetry_matches_jax():
    """5 epochs x 4 minibatches with the symmetry term (coef 0.5) of a
    random permutation and sign flips of the observation and the actions."""
    rng = np.random.default_rng(4)
    obs_perm, act_perm = rng.permutation(10), rng.permutation(A)
    obs_signs = rng.choice([-1.0, 1.0], 10).astype(np.float32)
    act_signs = rng.choice([-1.0, 1.0], A).astype(np.float32)
    jsym = (jppo.make_mirror_fns(obs_perm, obs_signs), jppo.make_mirror_fns(act_perm, act_signs),
            0.5)
    sym = (ppo.make_mirror_fns(obs_perm, obs_signs), ppo.make_mirror_fns(act_perm, act_signs), 0.5)

    jnet = JActorCritic(num_actions=A, actor_hidden_dims=HID, critic_hidden_dims=HID)
    params = jnet.init(jax.random.PRNGKey(1), jnp.zeros((1, 10)), jnp.zeros((1, 10)))
    obs = rng.standard_normal((T, B, 10)).astype(np.float32)
    mean, std, value = jnet.apply(params, jnp.asarray(obs))
    actions = mean + std * jnp.asarray(rng.standard_normal((T, B, A)).astype(np.float32))
    batch = jppo.Transition(obs=jnp.asarray(obs), critic_obs=jnp.asarray(obs), actions=actions,
                            rewards=jnp.asarray(rng.standard_normal((T, B)).astype(np.float32)),
                            dones=jnp.asarray(rng.random((T, B)) < 0.1), values=value,
                            log_probs=jlog_prob(mean, std, actions), mu=mean,
                            sigma=jnp.broadcast_to(std, (T, A)))
    adv, ret = jppo.compute_gae(batch.rewards, batch.dones, batch.values,
                                jnp.asarray(rng.standard_normal(B).astype(np.float32)), 0.99, 0.95)
    jcfg = jppo.PPOConfig(learning_rate=1e-3)
    opt = jppo.make_optimizer(jcfg)
    key = jax.random.PRNGKey(11)
    jst, jm = jppo.ppo_update(jnet, jcfg, jppo.PPOState(params, opt.init(params),
                                                         jnp.asarray(1e-3)),
                              batch, adv, ret, key, opt, symmetry=jsym)

    net = ActorCritic(10, A, HID, HID)
    net.load_state_dict(params_from_jax(jax.device_get(params)))
    cfg = ppo.PPOConfig(learning_rate=1e-3)
    perms = [torch.tensor(np.asarray(jax.random.permutation(k, T * B)))
             for k in jax.random.split(key, cfg.num_learning_epochs)]
    tb = ppo.Transition(**{k: torch.as_tensor(np.array(getattr(batch, k)))
                           for k in ppo.Transition.__dataclass_fields__})
    lr, m = ppo.ppo_update(net, cfg, ppo.Adam(net.parameters(), cfg.max_grad_norm), tb,
                           torch.as_tensor(np.array(adv)), torch.as_tensor(np.array(ret)),
                           torch.tensor(1e-3), perms=perms, symmetry=sym)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jax.device_get(jst.params)),
                                 jax.tree_util.tree_leaves(params_to_jax(net))):
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), err_msg=str(path))
    for k in ("loss", "value_loss", "surrogate_loss", "kl"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(lr), float(jm["learning_rate"]), rtol=1e-6)
