"""Policy/value networks (port of ``ActorCritic``, the Gaussian helpers and
``RunningNorm`` of ``models/networks.py``) and the bridge to the JAX
package's ``.pkl`` checkpoints in both directions.

The JAX networks are flax ``Dense`` stacks: a ``kernel [in, out]`` drawn from
``lecun_normal`` (a normal truncated at two standard deviations, scaled to
variance 1 / fan_in) and a zero bias; the port draws its ``nn.Linear``
weights the same way (PyTorch's default is a kaiming-uniform weight and a
uniform bias), so PPO starts from the same distribution of networks.
"""
from __future__ import annotations

import dataclasses
import math
import pickle
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

_ACTIVATIONS = {"elu": nn.ELU}
# modules a JAX checkpoint pickles objects of (the optimizer state's optax
# objects, the JAX package's RunningNorm); the port reads their fields, so they
# load as inert stubs and neither JAX nor the JAX package is imported
_STUBBED = ("jax", "jaxlib", "flax", "optax", "extended_legged_gym_tpu")
# the JAX class a checkpoint's ``obs_norm`` is an instance of
_JAX_RUNNING_NORM = ("extended_legged_gym_tpu.models.networks", "RunningNorm")
# standard deviation of a standard normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def _mlp(in_dim: int, hidden: Sequence[int], out_dim: int, activation: str) -> nn.Sequential:
    layers, d = [], in_dim
    for h in hidden:
        layers += [nn.Linear(d, h), _ACTIVATIONS[activation]()]
        d = h
    layers.append(nn.Linear(d, out_dim))
    return nn.Sequential(*layers)


def lecun_normal_(linear: nn.Linear, generator: Optional[torch.Generator] = None):
    """flax's ``Dense`` initialisation: weight from a normal truncated at two
    standard deviations with variance 1 / fan_in after truncation, zero bias."""
    fan_in = linear.weight.shape[1]
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(linear.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
        linear.weight.mul_(std)
        linear.bias.zero_()


class ActorCritic(nn.Module):
    """Gaussian MLP actor + MLP critic with a state-independent learned std
    (``log_std`` starts at ``log(init_noise_std)``).  ``generator`` seeds the
    flax-style initialisation of every ``nn.Linear``."""

    def __init__(self, num_obs: int, num_actions: int,
                 actor_hidden_dims: Sequence[int] = (512, 256, 128),
                 critic_hidden_dims: Sequence[int] = (512, 256, 128),
                 activation: str = "elu", init_noise_std: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.actor = _mlp(num_obs, actor_hidden_dims, num_actions, activation)
        self.critic = _mlp(num_obs, critic_hidden_dims, 1, activation)
        self.log_std = nn.Parameter(torch.full((num_actions,), math.log(init_noise_std)))
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m, generator)

    def forward(self, obs: torch.Tensor, critic_obs: Optional[torch.Tensor] = None):
        """``(mean [B, A], std [A], value [B])``."""
        mean = self.actor(obs)
        value = self.critic(critic_obs if critic_obs is not None else obs)[..., 0]
        return mean, self.log_std.exp(), value

    def act_inference(self, obs: torch.Tensor) -> torch.Tensor:
        return self.actor(obs)

    def evaluate(self, critic_obs: torch.Tensor) -> torch.Tensor:
        return self.critic(critic_obs)[..., 0]


def gaussian_log_prob(mean, std, actions):
    var = std ** 2
    return torch.sum(-0.5 * torch.square(actions - mean) / var - torch.log(std)
                     - 0.5 * math.log(2 * math.pi), dim=-1)


def gaussian_entropy(std):
    return torch.sum(0.5 + 0.5 * math.log(2 * math.pi) + torch.log(std), dim=-1)


@dataclasses.dataclass
class RunningNorm:
    """Empirical observation normalizer: running mean and population variance
    with an update-count cutoff (the JAX ``RunningNorm``)."""

    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor              # scalar float32
    until: int = int(1e9)

    @classmethod
    def create(cls, dim: int, until: int = int(1e9), device="cpu") -> "RunningNorm":
        return cls(mean=torch.zeros(dim, device=device), var=torch.ones(dim, device=device),
                   count=torch.zeros((), device=device), until=until)

    def update(self, batch: torch.Tensor) -> "RunningNorm":
        flat = batch.reshape(-1, batch.shape[-1])
        n = flat.shape[0]
        new_count = self.count + n
        delta = flat.mean(0) - self.mean
        new_mean = self.mean + delta * (n / new_count)
        m_a = self.var * self.count
        # jnp.var is the population variance (ddof 0); torch.var defaults to ddof 1
        m_b = flat.var(0, correction=0) * n
        new_var = (m_a + m_b + torch.square(delta) * self.count * n / new_count) / new_count
        do = self.count < self.until          # a device-side select: no host read
        return dataclasses.replace(self, mean=torch.where(do, new_mean, self.mean),
                                   var=torch.where(do, new_var, self.var),
                                   count=torch.where(do, new_count, self.count))

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / torch.sqrt(self.var + 1e-8)

    def to(self, device) -> "RunningNorm":
        return dataclasses.replace(self, mean=self.mean.to(device), var=self.var.to(device),
                                   count=self.count.to(device))


def inference_policy(net: ActorCritic,
                     obs_norm: Optional[RunningNorm] = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """The deterministic policy ``obs -> actions``: the actor's mean on
    observations normalized by ``obs_norm`` (moved to ``net``'s device) where
    there is one.  It reads ``net``'s parameters when called, so training
    continues to change it."""
    if obs_norm is not None:
        obs_norm = obs_norm.to(net.log_std.device)

    @torch.no_grad()
    def policy(obs: torch.Tensor) -> torch.Tensor:
        return net.act_inference(obs_norm.normalize(obs) if obs_norm is not None else obs)

    return policy


# ----------------------------------------------------------------- checkpoints
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


class _JaxLayoutPickler(pickle._Pickler):
    """A pickler that writes a :class:`RunningNorm` as an instance of the JAX
    package's ``RunningNorm`` (class reference, ``NEWOBJ``, then its field
    dict as numpy), so the JAX runner reads the port's checkpoints without
    the port importing the JAX package."""

    def save(self, obj, save_persistent_id=True):
        if not isinstance(obj, RunningNorm):
            return super().save(obj, save_persistent_id)
        module, name = _JAX_RUNNING_NORM
        self.save(module)
        self.save(name)
        self.write(pickle.STACK_GLOBAL + pickle.EMPTY_TUPLE + pickle.NEWOBJ)
        self.memoize(obj)
        self.save(dict(mean=obj.mean.detach().cpu().numpy(), var=obj.var.detach().cpu().numpy(),
                       count=np.asarray(obj.count.detach().cpu().numpy(), np.float32),
                       until=obj.until))
        self.write(pickle.BUILD)


def dump_checkpoint(payload: dict, f):
    """Pickle ``payload`` (numpy arrays, plain values, :class:`RunningNorm`)
    in the JAX runner's layout."""
    _JaxLayoutPickler(f, protocol=4).dump(payload)


def norm_from_checkpoint(obj) -> Optional[RunningNorm]:
    if obj is None:
        return None
    state = obj.state if isinstance(obj, _Stub) else obj
    return RunningNorm(mean=torch.as_tensor(np.asarray(state["mean"], np.float32)),
                       var=torch.as_tensor(np.asarray(state["var"], np.float32)),
                       count=torch.as_tensor(np.asarray(state.get("count", 0.0), np.float32)),
                       until=int(state.get("until", int(1e9))))


def _dense_to_linear(tree: Dict, prefix: str, out: Dict[str, torch.Tensor]):
    """flax ``Dense_k`` {kernel [in, out], bias} -> ``{prefix}.{2k}`` Linear."""
    k = 0
    while f"Dense_{k}" in tree:
        layer = tree[f"Dense_{k}"]
        out[f"{prefix}.{2 * k}.weight"] = torch.as_tensor(np.asarray(layer["kernel"]).T.copy())
        out[f"{prefix}.{2 * k}.bias"] = torch.as_tensor(np.asarray(layer["bias"]).copy())
        k += 1


def params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (``{"params": {"actor", "critic", "log_std"}}``
    or its inner dict) as an :class:`ActorCritic` ``state_dict``."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    _dense_to_linear(params["actor"], "actor", out)
    _dense_to_linear(params["critic"], "critic", out)
    out["log_std"] = torch.as_tensor(np.asarray(params["log_std"]).copy())
    return out


def params_to_jax(net: ActorCritic) -> Dict:
    """The inverse of :func:`params_from_jax`: ``net``'s parameters as the
    flax tree ``{"params": {"actor": {"Dense_k": {"kernel" [in, out],
    "bias"}}, "critic": ..., "log_std"}}`` of numpy arrays."""
    def dense(seq: nn.Sequential) -> Dict:
        linears = [m for m in seq if isinstance(m, nn.Linear)]
        return {f"Dense_{k}": {"kernel": m.weight.detach().cpu().numpy().T.copy(),
                               "bias": m.bias.detach().cpu().numpy().copy()}
                for k, m in enumerate(linears)}

    return {"params": {"actor": dense(net.actor), "critic": dense(net.critic),
                       "log_std": net.log_std.detach().cpu().numpy().copy()}}


def read_checkpoint(path: str) -> dict:
    """The payload of a ``.pkl`` written by the JAX runner or the port's, with
    the JAX package's and JAX's objects loaded as stubs."""
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def load_jax_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Optional[RunningNorm]]:
    """Read a ``.pkl`` written by the JAX runner (or the port's runner):
    ``(state_dict, obs_norm)``, the :class:`ActorCritic` parameters and the
    observation normalizer the policy was trained with (``None`` without
    empirical normalization).  A policy built from it must apply the
    normalizer: :func:`inference_policy`."""
    payload = read_checkpoint(path)
    return params_from_jax(payload["params"]), norm_from_checkpoint(payload.get("obs_norm"))
