"""The port's deployment export (utils/export.py, OnPolicyRunner.export_policy)
against the JAX package's TorchScript exporters: the same parameters, the
port's network carried to JAX's flax tree with ``params_to_jax``, written by
both and loaded with ``torch.jit.load``, must give the same actions within
1e-6 (the MLP with the normalizer folded in; LSTM and GRU over steps and
``reset_memory()``, also against the port's RecurrentInferencePolicy); the
``policy.pt2`` (the counterpart of JAX's StableHLO file) round-trips;
``runner.export_policy`` lists its files, as tests/test_export.py checks for
the JAX runner."""
import types

import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.utils.export import export_policy_as_jit as jexport_policy_as_jit
from extended_legged_gym_tpu.utils.export import (
    export_recurrent_policy_as_jit as jexport_recurrent_policy_as_jit)
from extended_legged_gym_tpu_torch import robots  # noqa: F401  (populates the registry)
from extended_legged_gym_tpu_torch.models.networks import (ActorCritic, ActorCriticRecurrent,
                                                         RecurrentInferencePolicy, RunningNorm,
                                                         inference_policy, params_to_jax)
from extended_legged_gym_tpu_torch.utils.export import (export_policy_as_jit, export_policy_pt2,
                                                        export_recurrent_policy_as_jit,
                                                        load_pt2_policy, mlp_policy_module)
from extended_legged_gym_tpu_torch.utils.task_registry import task_registry

OBS, ACT = 48, 12


def _norm(seed=0):
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal(OBS).astype(np.float32)
    var = rng.uniform(0.2, 3.0, OBS).astype(np.float32)
    return (RunningNorm(torch.as_tensor(mean), torch.as_tensor(var), torch.tensor(10.0)),
            types.SimpleNamespace(mean=mean, var=var))


def _obs(n, seed=1):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal((n, OBS)).astype(np.float32))


@pytest.mark.parametrize("normalized", [False, True], ids=["plain", "normalized"])
def test_mlp_torchscript_matches_jax(tmp_path, normalized):
    net = ActorCritic(OBS, ACT, (128, 64, 32), (128, 64, 32),
                      generator=torch.Generator().manual_seed(3))
    norm, jnorm = _norm() if normalized else (None, None)
    mine = export_policy_as_jit(net.actor, str(tmp_path / "port"), normalizer=norm)
    theirs = jexport_policy_as_jit(params_to_jax(net), str(tmp_path / "jax"), normalizer=jnorm)
    assert mine.endswith("policy_1.pt") and theirs.endswith("policy_1.pt")
    a, b = torch.jit.load(mine), torch.jit.load(theirs)
    obs = _obs(7)
    with torch.no_grad():
        np.testing.assert_allclose(a(obs).numpy(), b(obs).numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(a(obs).numpy(), inference_policy(net, norm)(obs).numpy(),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
@pytest.mark.parametrize("normalized", [False, True], ids=["plain", "normalized"])
def test_recurrent_torchscript_matches_jax(tmp_path, rnn_type, normalized):
    """Both files over 4 steps, a reset_memory() and 2 more steps, and the
    port's RecurrentInferencePolicy at one env."""
    net = ActorCriticRecurrent(OBS, ACT, (64, 32), (64, 32), rnn_hidden_size=32,
                               rnn_type=rnn_type, generator=torch.Generator().manual_seed(4))
    norm, jnorm = _norm(1) if normalized else (None, None)
    mine = export_recurrent_policy_as_jit(net, str(tmp_path / "port"), normalizer=norm)
    theirs = jexport_recurrent_policy_as_jit(params_to_jax(net), OBS, str(tmp_path / "jax"),
                                             rnn_type=rnn_type, rnn_hidden_size=32,
                                             normalizer=jnorm)
    assert mine.endswith("policy_lstm_1.pt")
    a, b = torch.jit.load(mine), torch.jit.load(theirs)
    ref = RecurrentInferencePolicy(net, norm, 1)
    obs = _obs(6, 2)
    with torch.no_grad():
        for t in range(6):
            if t == 4:
                a.reset_memory()
                b.reset_memory()
                ref.reset(torch.ones(1, dtype=torch.bool))
            x = obs[t:t + 1]
            ya, yb = a(x).numpy(), b(x).numpy()
            np.testing.assert_allclose(ya, yb, rtol=0, atol=1e-6, err_msg=f"step {t}")
            np.testing.assert_allclose(ya, ref(x).numpy(), rtol=0, atol=1e-6, err_msg=f"step {t}")
    # the memory moved the action: a step with the same input differs after one
    with torch.no_grad():
        a.reset_memory()
        first = a(obs[:1]).numpy()
        assert not np.allclose(a(obs[:1]).numpy(), first)


def test_pt2_round_trips(tmp_path):
    net = ActorCritic(OBS, ACT, (128, 64, 32), (128, 64, 32),
                      generator=torch.Generator().manual_seed(5))
    norm, _ = _norm(2)
    module = mlp_policy_module(net.actor, "elu", norm)
    path = export_policy_pt2(module, torch.zeros(2, OBS), str(tmp_path))
    assert path.endswith("policy.pt2")
    policy = load_pt2_policy(path)
    want = inference_policy(net, norm)
    for n in (1, 5, 50):                         # the batch is dynamic
        obs = _obs(n, n)
        with torch.no_grad():
            np.testing.assert_allclose(policy(obs).numpy(), want(obs).numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("recurrent", [False, True], ids=["mlp", "lstm"])
def test_runner_export_policy_lists_its_files(tmp_path, recurrent):
    env_cfg, train_cfg = task_registry.get_cfgs("anymal_c_flat")
    env_cfg.env.num_envs = 2
    if recurrent:
        train_cfg.runner.policy_class_name = "ActorCriticRecurrent"
        train_cfg.policy.rnn_hidden_size = 16
    env, _ = task_registry.make_env("anymal_c_flat", env_cfg=env_cfg, device="cpu")
    runner, _ = task_registry.make_alg_runner(env, "anymal_c_flat", train_cfg=train_cfg,
                                              log_root=str(tmp_path / "logs"))
    files = runner.export_policy(str(tmp_path / "exported"))
    obs = torch.zeros(1, env.num_obs)
    if recurrent:
        assert [f.split("/")[-1] for f in files] == ["policy_lstm_1.pt"]
        assert torch.jit.load(files[0])(obs).shape == (1, env.num_actions)
        return
    assert [f.split("/")[-1] for f in files] == ["policy_1.pt", "policy.pt2"]
    assert torch.jit.load(files[0])(obs).shape == (1, env.num_actions)
    assert load_pt2_policy(files[1])(obs).shape == (1, env.num_actions)
