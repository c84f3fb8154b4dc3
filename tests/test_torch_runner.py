"""The slice as a whole: one OnPolicyRunner iteration of the port against one
``_train_iteration`` of the JAX runner on the anymal_c_flat env (ABA solver),
16 envs, T = 8 steps, [32, 16] actor and critic, also with a privileged
critic (56 inputs); then the checkpoint bridge in both directions, the task
registry and the train and eval scripts.

The iteration starts from the JAX runner's env state and parameters.  The
action noise is recomputed from the JAX key splits (``split(key, 3)``, then
``split(k_collect, T)`` and one ``normal`` per step) and the minibatch
permutations from ``k_update``; both are injected.  Noise, randomization and
pushes are off and no env resets, so the env draws nothing that is used.

Tolerances: the collected batch's step reward 1e-4 absolute (the physics
agrees to 5e-3 after a few steps, tests/test_torch_env.py); the parameters
after the update 2e-3 of each tensor's largest magnitude (20 Adam steps on
data that differ in the last digits; Adam's first steps move every parameter
by about the learning rate whatever its gradient's size); the losses 1e-3
relative; the learning rate 1e-6 relative.  The checkpoint round trip holds
actions to 1e-5."""
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.envs.legged_robot import LeggedRobot as JLeggedRobot
from extended_legged_gym_tpu.rl.runner import OnPolicyRunner as JRunner
from extended_legged_gym_tpu.robots.anymal_c import anymal_c_flat_cfg as janymal_c_flat_cfg
from extended_legged_gym_tpu.robots.anymal_c import anymal_c_ppo_cfg as janymal_c_ppo_cfg
from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
from extended_legged_gym_tpu_torch.models.networks import params_from_jax, params_to_jax
from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_flat_cfg, anymal_c_ppo_cfg
from torch_parity import to_torch_state

B, T, HID = 16, 8, [32, 16]
JAX_CKPT = "logs/flat_anymal_c/Aug21_16-29-23_r5_scratch/model_final.pkl"


def quiet(cfg):
    cfg.env.num_envs = B
    cfg.noise.add_noise = False
    cfg.domain_rand.randomize_friction = cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.push_robots = False
    return cfg


def small(tc, empirical=False):
    tc.seed = 3
    tc.runner.num_steps_per_env = T
    tc.runner.empirical_normalization = empirical
    tc.policy.actor_hidden_dims = tc.policy.critic_hidden_dims = list(HID)
    return tc


@pytest.fixture(scope="module")
def jax_runner():
    jc = quiet(janymal_c_flat_cfg())
    jc.sim.solver = "aba"
    return JRunner(JLeggedRobot(jc), small(janymal_c_ppo_cfg()))


@pytest.fixture(scope="module")
def env():
    return LeggedRobot(quiet(anymal_c_flat_cfg()), device="cpu")


def port_from_jax(env, ts, empirical=False):
    """A port runner holding the JAX runner's env state and parameters."""
    runner = OnPolicyRunner(env, small(anymal_c_ppo_cfg(), empirical))
    runner.env_state = to_torch_state(ts.env_state)
    runner.network.load_state_dict(params_from_jax(jax.device_get(ts.ppo.params)))
    return runner


def jax_draws(ts, epochs):
    """The action noise and minibatch permutations of the JAX iteration."""
    _, k_collect, k_update = jax.random.split(ts.key, 3)
    noise = np.stack([np.asarray(jax.random.normal(k, (B, 12)))
                      for k in jax.random.split(k_collect, T)])
    perms = [torch.tensor(np.asarray(jax.random.permutation(k, T * B)))
             for k in jax.random.split(k_update, epochs)]
    return torch.as_tensor(noise), perms


def test_iteration_matches_jax(jax_runner, env):
    ts0 = jax_runner.state
    ts1, jm = jax_runner._train_iter(ts0)
    runner = port_from_jax(env, ts0)
    noise, perms = jax_draws(ts0, runner.ppo_cfg.num_learning_epochs)
    m = runner.train_iteration(action_noise=noise, perms=perms)
    assert not bool(np.asarray(ts1.env_state.reset_buf).any()) and float(m["episodes_done"]) == 0
    np.testing.assert_allclose(float(m["mean_step_reward"]), float(jm["mean_step_reward"]),
                               atol=1e-4)
    for k in ("loss", "value_loss", "surrogate_loss", "entropy", "kl"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-3, err_msg=k)
    for k in ("learning_rate", "action_std"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6, err_msg=k)
    assert float(m["nonfinite_skips"]) == float(jm["nonfinite_skips"]) == 0
    assert float(m["reward_stage"]) == float(jm["reward_stage"]) == 0
    assert set(m) >= set(jm)
    want = jax.tree_util.tree_leaves_with_path(jax.device_get(ts1.ppo.params))
    got = jax.tree_util.tree_leaves(params_to_jax(runner.network))
    for (path, w), g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=2e-3 * np.abs(w).max(), err_msg=str(path))
    assert runner.iteration == int(ts1.iteration) == 1


PRIV = 56          # the 48-dim observation zero-padded: a critic wider than the actor


def test_iteration_with_a_privileged_critic_matches_jax(tmp_path):
    """The same iteration with ``env.num_privileged_obs`` set: the critic is
    sized by and reads the privileged observation (the noise-free
    observation padded with zeros, zero after the reset), in both packages;
    the checkpoint round-trips the wider critic."""
    from torch_family import to_port

    jc = quiet(janymal_c_flat_cfg())
    jc.sim.solver = "aba"
    jc.env.num_privileged_obs = PRIV
    jrunner = JRunner(JLeggedRobot(jc), small(janymal_c_ppo_cfg()))
    cfg = quiet(anymal_c_flat_cfg())
    cfg.env.num_privileged_obs = PRIV
    penv = LeggedRobot(cfg, device="cpu")
    ts0 = jrunner.state
    ts1, jm = jrunner._train_iter(ts0)
    runner = OnPolicyRunner(penv, small(anymal_c_ppo_cfg()))
    assert runner.network.critic[0].in_features == PRIV
    runner.env_state = to_port(ts0.env_state)
    assert float(runner.env_state.privileged_obs.abs().max()) == 0.0
    runner.network.load_state_dict(params_from_jax(jax.device_get(ts0.ppo.params)))
    noise, perms = jax_draws(ts0, runner.ppo_cfg.num_learning_epochs)
    m = runner.train_iteration(action_noise=noise, perms=perms)
    np.testing.assert_allclose(runner.env_state.privileged_obs.numpy(),
                               np.asarray(ts1.env_state.privileged_obs), atol=1e-2)
    assert float(runner.env_state.privileged_obs[:, 48:].abs().max()) == 0.0
    for k in ("loss", "value_loss", "surrogate_loss", "entropy", "kl"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-3, err_msg=k)
    want = jax.tree_util.tree_leaves_with_path(jax.device_get(ts1.ppo.params))
    got = jax.tree_util.tree_leaves(params_to_jax(runner.network))
    for (path, w), g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=2e-3 * np.abs(w).max(), err_msg=str(path))
    path = tmp_path / "priv.pkl"
    runner.save(str(path))
    fresh = OnPolicyRunner(penv, small(anymal_c_ppo_cfg()))
    fresh.load(str(path))
    es = runner.env_state
    with torch.no_grad():
        assert torch.equal(runner.network.evaluate(es.privileged_obs),
                           fresh.network.evaluate(es.privileged_obs))
        assert torch.equal(runner.get_inference_policy()(es.obs),
                           fresh.get_inference_policy()(es.obs))


def test_stage_advances_as_in_jax(jax_runner, env):
    """Every env times out on the iteration's first step with an episode
    return of 5: the episodes that ended average above the threshold 3.0 and
    both runners advance the reward stage to 1 after the update.  (The envs
    re-drawn at the reset differ between the packages, so only the episode
    metrics and the stage are compared.)"""
    ts0 = jax_runner.state
    es = ts0.env_state
    es = es.replace(episode_length=jnp.full_like(es.episode_length, jax_runner.env.max_episode_length),
                    episode_return=jnp.full_like(es.episode_return, 5.0))
    ts0 = ts0.replace(env_state=es)
    _, jm = jax_runner._train_iter(ts0)
    runner = port_from_jax(env, ts0)
    noise, perms = jax_draws(ts0, runner.ppo_cfg.num_learning_epochs)
    m = runner.train_iteration(action_noise=noise, perms=perms)
    assert float(m["episodes_done"]) == float(jm["episodes_done"]) == B
    for k in ("mean_reward", "mean_episode_length", "episode/rew_tracking_lin_vel",
              "episode/rew_base_height"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert float(m["mean_reward"]) > 3.0
    assert float(m["reward_stage"]) == float(jm["reward_stage"]) == 1.0
    assert int(runner.env_state.reward_stage) == 1


def test_checkpoint_is_read_by_the_jax_runner(jax_runner, env, tmp_path):
    """The port saves (empirical normalization on, so ``obs_norm`` is a
    normalizer with statistics); the JAX runner loads it and its inference
    policy gives the port's actions."""
    runner = port_from_jax(env, jax_runner.state, empirical=True)
    runner.train_iteration()
    path = str(tmp_path / "model_1.pkl")
    runner.save(path)
    with open(path, "rb") as f:
        payload = pickle.load(f)
    assert payload["opt_state"] is None and payload["iteration"] == 1
    assert type(payload["obs_norm"]).__module__ == "extended_legged_gym_tpu.models.networks"
    jc = quiet(janymal_c_flat_cfg())
    jc.sim.solver = "aba"
    jr = JRunner(JLeggedRobot(jc), small(janymal_c_ppo_cfg(), empirical=True))
    jr.load(path)
    obs = np.random.default_rng(0).standard_normal((32, 48)).astype(np.float32)
    want = np.asarray(jr.get_inference_policy()(jnp.asarray(obs)))
    got = runner.get_inference_policy()(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert int(jr.state.iteration) == 1


def test_port_resumes_its_own_checkpoint(env, jax_runner, tmp_path):
    """Parameters, Adam state, learning rate, normalizer, iteration and reward
    stage come back; the next iteration from the loaded runner equals the
    next one from the saved runner."""
    a = port_from_jax(env, jax_runner.state, empirical=True)
    a.train_iteration()
    a.env_state = a.env_state.replace(reward_stage=torch.tensor(1))
    path = str(tmp_path / "model_1.pkl")
    a.save(path)
    b = OnPolicyRunner(env, small(anymal_c_ppo_cfg(), empirical=True))
    b.load(path)
    b.env_state = a.env_state
    assert b.iteration == 1 and int(b.env_state.reward_stage) == 1
    assert float(b.learning_rate) == pytest.approx(float(a.learning_rate), rel=1e-7)
    assert torch.equal(b.optimizer.mu, a.optimizer.mu) and float(b.optimizer.count) == 20
    assert torch.equal(b.obs_norm.var, a.obs_norm.var)
    noise = torch.randn(T, B, 12, generator=torch.Generator().manual_seed(0))
    perms = [torch.randperm(T * B, generator=torch.Generator().manual_seed(e)) for e in range(5)]
    env.generator.manual_seed(0)            # the two runners share the env: same resets
    ma = a.train_iteration(action_noise=noise, perms=perms)
    env.generator.manual_seed(0)
    mb = b.train_iteration(action_noise=noise, perms=perms)
    assert float(ma["loss"]) == float(mb["loss"])
    assert torch.equal(a.optimizer.flat_params(), b.optimizer.flat_params())


def test_port_loads_committed_jax_checkpoint(env):
    """The TRAIN_r5 checkpoint's policy in the port acts as in the JAX
    package, and its learning rate and iteration come with it."""
    from extended_legged_gym_tpu.models.networks import ActorCritic as JActorCritic

    runner = OnPolicyRunner(env, anymal_c_ppo_cfg())
    payload = runner.load(JAX_CKPT)
    assert runner.iteration == payload["iteration"] == 2000
    np.testing.assert_allclose(float(runner.learning_rate), payload["learning_rate"], rtol=1e-7)
    jnet = JActorCritic(num_actions=12, actor_hidden_dims=(128, 64, 32),
                        critic_hidden_dims=(128, 64, 32))
    with open(JAX_CKPT, "rb") as f:
        params = pickle.load(f)["params"]
    obs = np.random.default_rng(1).standard_normal((32, 48)).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(obs), method=jnet.act_inference))
    got = runner.get_inference_policy()(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("what", ["recurrent", "rnd", "symmetry", "warmstart", "export"])
def test_not_ported_raises(env, what, tmp_path):
    """A policy class the port lacks raises NotImplementedError.  The entries
    that raised before they were ported now run: the RL extensions (the
    recurrent policy, RND, symmetry) build their runner
    (tests/test_torch_recurrent.py and tests/test_torch_rnd_symmetry.py hold
    them to the JAX package), the reference warm start fails only on a
    missing file, naming it, and the export writes its files
    (tests/test_torch_torch_compat.py and tests/test_torch_export.py hold
    both to the JAX package)."""
    from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_symmetry_cfg

    tc = small(anymal_c_ppo_cfg())
    if what == "recurrent":
        tc.runner.policy_class_name = "ActorCriticRecurrent"
        assert OnPolicyRunner(env, tc).recurrent
        tc.runner.policy_class_name = "ActorCriticTransformer"
    if what == "rnd":
        tc.algorithm.rnd_cfg = {"weight": 1.0}
        assert OnPolicyRunner(env, tc).rnd is not None
        return
    if what == "symmetry":
        tc.algorithm.symmetry_cfg = anymal_c_symmetry_cfg()
        assert OnPolicyRunner(env, tc).symmetry is not None
        return
    if what == "warmstart":
        with pytest.raises(FileNotFoundError, match="policy.pt"):
            OnPolicyRunner(env, tc).warmstart_from_reference(str(tmp_path / "policy.pt"))
        return
    if what == "export":
        files = OnPolicyRunner(env, tc).export_policy(str(tmp_path / "policy"))
        assert [os.path.basename(f) for f in files] == ["policy_1.pt", "policy.pt2"]
        assert all(os.path.getsize(f) > 0 for f in files)
        return
    with pytest.raises(NotImplementedError):
        OnPolicyRunner(env, tc)


def test_train_and_eval_scripts_on_cpu(tmp_path, monkeypatch):
    """scripts/train.py through the registry (8 envs, 2 iterations, written
    under ./logs), --resume from it, then scripts/eval_policy.py on the
    resumed run's checkpoint: one JSON line with the JAX script's keys."""
    from extended_legged_gym_tpu_torch.scripts import eval_policy, train
    from extended_legged_gym_tpu_torch.utils.task_registry import get_args, get_load_path

    monkeypatch.chdir(tmp_path)
    argv = ["--num_envs", "8", "--max_iterations", "2", "--device", "cpu", "--seed", "2",
            "--experiment_name", "flat_torch_test", "--run_name", "a"]
    last = train.train(get_args(argv=argv))
    assert np.isfinite(last["loss"]) and last["nonfinite_skips"] == 0
    with open(next((tmp_path / "logs" / "flat_torch_test").glob("*_a")) / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2]
    last = train.train(get_args(argv=argv[:-1] + ["b", "--resume", "--max_iterations", "1"]))
    ckpt = get_load_path("logs/flat_torch_test")
    assert ckpt.endswith("model_final.pkl") and "_b" in ckpt
    out = eval_policy.evaluate("anymal_c_flat", ckpt, envs=4, steps=5, warmup=2, device="cpu")
    assert out["iteration"] == 3 and out["card"] == "cpu"
    for k in ("achieved_over_command", "upright_mean", "base_height_mean", "falls"):
        assert np.isfinite(out[k]), k
    assert os.path.exists(ckpt)
