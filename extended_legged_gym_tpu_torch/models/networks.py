"""Policy/value networks (port of the ``ActorCritic`` of ``models/networks.py``)
and the reader for the JAX package's ``.pkl`` checkpoints."""
from __future__ import annotations

import pickle
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

_ACTIVATIONS = {"elu": nn.ELU}
# modules a JAX checkpoint pickles in its optimizer state; the port reads only
# the parameters, so objects from these modules load as inert stubs
_STUBBED = ("jax", "jaxlib", "flax", "optax")


def _mlp(in_dim: int, hidden: Sequence[int], out_dim: int, activation: str) -> nn.Sequential:
    layers, d = [], in_dim
    for h in hidden:
        layers += [nn.Linear(d, h), _ACTIVATIONS[activation]()]
        d = h
    layers.append(nn.Linear(d, out_dim))
    return nn.Sequential(*layers)


class ActorCritic(nn.Module):
    """Gaussian MLP actor + MLP critic with a state-independent learned std."""

    def __init__(self, num_obs: int, num_actions: int,
                 actor_hidden_dims: Sequence[int] = (512, 256, 128),
                 critic_hidden_dims: Sequence[int] = (512, 256, 128),
                 activation: str = "elu"):
        super().__init__()
        self.actor = _mlp(num_obs, actor_hidden_dims, num_actions, activation)
        self.critic = _mlp(num_obs, critic_hidden_dims, 1, activation)
        self.log_std = nn.Parameter(torch.zeros(num_actions))

    def act_inference(self, obs: torch.Tensor) -> torch.Tensor:
        return self.actor(obs)


class _Stub:
    """Stand-in for any object of a stubbed module found in a pickle."""

    def __init__(self, *args, **kwargs):
        self.args = args

    def __setstate__(self, state):
        self.state = state


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _STUBBED:
            return type(name, (_Stub,), {"__module__": module})
        return super().find_class(module, name)


def _dense_to_linear(tree: Dict, prefix: str, out: Dict[str, torch.Tensor]):
    """flax ``Dense_k`` {kernel [in, out], bias} -> ``{prefix}.{2k}`` Linear."""
    k = 0
    while f"Dense_{k}" in tree:
        layer = tree[f"Dense_{k}"]
        out[f"{prefix}.{2 * k}.weight"] = torch.as_tensor(np.asarray(layer["kernel"]).T.copy())
        out[f"{prefix}.{2 * k}.bias"] = torch.as_tensor(np.asarray(layer["bias"]).copy())
        k += 1


def load_jax_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``.pkl`` written by the JAX runner and return an
    :class:`ActorCritic` ``state_dict``.  Only ``params`` is read; the
    optimizer state's JAX/flax/optax objects load as stubs, so neither JAX
    nor the JAX package is imported.

    Raises ``ValueError`` for a checkpoint that carries an observation
    normalizer (``obs_norm``, written when training with empirical
    normalization): its policy expects normalised observations, and the port
    does not apply a normalizer yet."""
    with open(path, "rb") as f:
        payload = _CheckpointUnpickler(f).load()
    if payload.get("obs_norm") is not None:
        raise ValueError(f"{path}: the checkpoint carries an observation normalizer (obs_norm); "
                         "the port does not apply one yet, so its policy would act on "
                         "unnormalised observations")
    params = payload["params"]
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    _dense_to_linear(params["actor"], "actor", out)
    _dense_to_linear(params["critic"], "critic", out)
    out["log_std"] = torch.as_tensor(np.asarray(params["log_std"]).copy())
    return out
