"""Policy/value networks (port of ``ActorCritic``, ``ActorCriticRecurrent``,
``MLP``, the Gaussian helpers, the recurrent cells with ``rnn_carry`` and
``Memory``, and ``RunningNorm`` of ``models/networks.py``) and the bridge to
the JAX package's ``.pkl`` checkpoints in both directions.

The JAX networks are flax ``Dense`` stacks: a ``kernel [in, out]`` drawn from
``lecun_normal`` (a normal truncated at two standard deviations, scaled to
variance 1 / fan_in) and a zero bias; the port draws its ``nn.Linear``
weights the same way (PyTorch's default is a kaiming-uniform weight and a
uniform bias), so PPO starts from the same distribution of networks.  The
recurrent cells are flax's ``GRUCell`` and ``OptimizedLSTMCell`` written out
gate by gate: ``lecun_normal`` input kernels, orthogonal recurrent kernels,
zero biases, and flax's split of the biases between the input and the
hidden kernels, which ``torch.nn.GRUCell`` cannot hold.

Modules whose children carry flax's names (``Dense_0``, ``GRUCell_0``, ``ir``,
...) map to and from a flax parameter tree with :func:`flax_tree` and
:func:`load_flax_tree`, whatever they nest.
"""
from __future__ import annotations

import dataclasses
import math
import pickle
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import pmean
from ..utils.tree import tree_map

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


def lecun_normal_(layer: nn.Module, generator: Optional[torch.Generator] = None):
    """flax's ``Dense`` and ``Conv`` initialisation: weight from a normal
    truncated at two standard deviations with variance 1 / fan_in after
    truncation (fan_in: the inputs of one output unit), zero bias."""
    fan_in = layer.weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
        layer.weight.mul_(std)
        if layer.bias is not None:
            layer.bias.zero_()


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """flax's activation of ``name`` (``get_activation``)."""
    return {"elu": F.elu, "relu": F.relu, "selu": F.selu, "crelu": F.relu,
            "lrelu": F.leaky_relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid}[name]


get_activation = activation_fn   # the JAX package's name


class MLP(nn.Module):
    """flax's ``MLP``: ``Dense_0 .. Dense_n`` with the activation between
    them, none after the last."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int], out_dim: int,
                 activation: str = "elu", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = activation_fn(activation)
        dims = [in_dim, *hidden_dims, out_dim]
        self.n = len(dims) - 1
        for k in range(self.n):
            layer = nn.Linear(dims[k], dims[k + 1])
            lecun_normal_(layer, generator)
            self.add_module(f"Dense_{k}", layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k in range(self.n):
            x = self._modules[f"Dense_{k}"](x)
            if k < self.n - 1:
                x = self.act(x)
        return x


def _gate(in_dim: int, hidden: int, bias: bool, recurrent: bool,
          generator: Optional[torch.Generator]) -> nn.Linear:
    layer = nn.Linear(in_dim, hidden, bias=bias)
    if recurrent:
        with torch.no_grad():
            nn.init.orthogonal_(layer.weight, generator=generator)
    else:
        lecun_normal_(layer, generator)
    if bias:
        with torch.no_grad():
            layer.bias.zero_()
    return layer


class GRUCell(nn.Module):
    """flax's ``nn.GRUCell``: ``r = sigmoid(ir x + hr h)``, ``z = sigmoid(iz x
    + hz h)``, ``n = tanh(in x + r * (hn h))``, ``h' = (1 - z) n + z h``; the
    input gates and ``hn`` have a bias, ``hr`` and ``hz`` none.  Called as
    flax calls it: ``(carry, x) -> (carry, out)``, the carry ``h``."""

    def __init__(self, in_dim: int, hidden: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden = hidden
        for k in ("ir", "iz", "in"):
            self.add_module(k, _gate(in_dim, hidden, True, False, generator))
        for k in ("hr", "hz", "hn"):
            self.add_module(k, _gate(hidden, hidden, k == "hn", True, generator))

    def forward(self, h: torch.Tensor, x: torch.Tensor):
        g = self._modules
        r = torch.sigmoid(g["ir"](x) + g["hr"](h))
        z = torch.sigmoid(g["iz"](x) + g["hz"](h))
        n = torch.tanh(g["in"](x) + r * g["hn"](h))
        h = (1.0 - z) * n + z * h
        return h, h


class LSTMCell(nn.Module):
    """flax's ``nn.OptimizedLSTMCell``: gates ``i, f, g, o`` each the sum of
    an input kernel (no bias) and a hidden kernel (with bias);
    ``c' = f c + i g``, ``h' = o tanh(c')``.  The carry is ``(c, h)``, flax's
    order (``torch.nn.LSTMCell`` takes ``(h, c)``)."""

    def __init__(self, in_dim: int, hidden: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden = hidden
        for k in "ifgo":
            self.add_module("i" + k, _gate(in_dim, hidden, False, False, generator))
            self.add_module("h" + k, _gate(hidden, hidden, True, True, generator))

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor], x: torch.Tensor):
        c, h = carry
        g = self._modules
        i, f, o = (torch.sigmoid(g["h" + k](h) + g["i" + k](x)) for k in "ifo")
        c = f * c + i * torch.tanh(g["hg"](h) + g["ig"](x))
        h = o * torch.tanh(c)
        return (c, h), h


def rnn_carry(rnn_type: str, hidden_size: int, batch_dims: Tuple[int, ...], device="cpu"):
    """Zero carry of a recurrent cell (LSTM: ``(c, h)``; GRU: ``h``)."""
    shape = tuple(batch_dims) + (hidden_size,)
    if rnn_type == "lstm":
        return (torch.zeros(shape, device=device), torch.zeros(shape, device=device))
    return torch.zeros(shape, device=device)


class Memory(nn.Module):
    """One step of an LSTM or GRU (reference networks/memory.py): ``(x,
    carry) -> (out, carry)``; the caller carries the state and resets it on
    dones.  The cell is the child flax names ``OptimizedLSTMCell_0`` or
    ``GRUCell_0``."""

    def __init__(self, in_dim: int, hidden_size: int = 256, rnn_type: str = "lstm",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size, self.rnn_type = hidden_size, rnn_type
        if rnn_type == "lstm":
            self.cell_name = "OptimizedLSTMCell_0"
            cell = LSTMCell(in_dim, hidden_size, generator)
        elif rnn_type == "gru":
            self.cell_name = "GRUCell_0"
            cell = GRUCell(in_dim, hidden_size, generator)
        else:
            raise ValueError(f"unknown rnn type {rnn_type!r}")
        self.add_module(self.cell_name, cell)

    def forward(self, x: torch.Tensor, carry):
        carry, out = self._modules[self.cell_name](carry, x)
        return out, carry

    def initialize_carry(self, batch_dims: Tuple[int, ...], device="cpu"):
        return rnn_carry(self.rnn_type, self.hidden_size, batch_dims, device)


def mask_carry(carry, dones: torch.Tensor):
    """``carry`` (a tensor ``[B, H]`` or a tuple of them) with the rows of the
    envs in ``dones`` [B] zeroed, as the JAX runner multiplies by ``1 - d``."""
    keep = 1.0 - dones.to(torch.float32)[:, None]
    return tree_map(lambda h: h * keep, carry)


class ActorCritic(nn.Module):
    """Gaussian MLP actor + MLP critic with a state-independent learned std
    (``log_std`` starts at ``log(init_noise_std)``).  The critic reads
    ``num_critic_obs`` inputs (a privileged observation), by default the
    actor's ``num_obs``.  ``generator`` seeds the flax-style initialisation
    of every ``nn.Linear``."""

    def __init__(self, num_obs: int, num_actions: int,
                 actor_hidden_dims: Sequence[int] = (512, 256, 128),
                 critic_hidden_dims: Sequence[int] = (512, 256, 128),
                 activation: str = "elu", init_noise_std: float = 1.0,
                 num_critic_obs: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.actor = _mlp(num_obs, actor_hidden_dims, num_actions, activation)
        self.critic = _mlp(num_critic_obs or num_obs, critic_hidden_dims, 1, activation)
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


class ActorCriticRecurrent(nn.Module):
    """Recurrent actor-critic: one LSTM or GRU ``Memory`` before each of the
    actor and critic MLPs, a state-independent learned std.  The children
    carry flax's names (``memory_a``, ``memory_c``, ``actor``, ``critic``,
    ``log_std``), so :func:`flax_tree` / :func:`load_flax_tree` and the
    checkpoint bridge map it to and from the JAX module's parameters."""

    def __init__(self, num_obs: int, num_actions: int,
                 actor_hidden_dims: Sequence[int] = (256, 256, 128),
                 critic_hidden_dims: Sequence[int] = (256, 256, 128),
                 activation: str = "elu", init_noise_std: float = 1.0,
                 rnn_hidden_size: int = 256, rnn_type: str = "lstm",
                 num_critic_obs: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rnn_type, self.rnn_hidden_size = rnn_type, rnn_hidden_size
        self.memory_a = Memory(num_obs, rnn_hidden_size, rnn_type, generator)
        self.memory_c = Memory(num_critic_obs or num_obs, rnn_hidden_size, rnn_type, generator)
        self.actor = MLP(rnn_hidden_size, actor_hidden_dims, num_actions, activation, generator)
        self.critic = MLP(rnn_hidden_size, critic_hidden_dims, 1, activation, generator)
        self.log_std = nn.Parameter(torch.full((num_actions,), math.log(init_noise_std)))

    def forward(self, obs: torch.Tensor, carry_a, carry_c,
                critic_obs: Optional[torch.Tensor] = None):
        """``(mean [B, A], std [A], value [B], carry_a, carry_c)``."""
        xa, carry_a = self.memory_a(obs, carry_a)
        xc, carry_c = self.memory_c(critic_obs if critic_obs is not None else obs, carry_c)
        return self.actor(xa), self.log_std.exp(), self.critic(xc)[..., 0], carry_a, carry_c

    def act_inference(self, obs: torch.Tensor, carry_a):
        """The actor's mean and its next carry (the critic's memory is not run)."""
        xa, carry_a = self.memory_a(obs, carry_a)
        return self.actor(xa), carry_a

    def initialize_carries(self, batch_dims: Tuple[int, ...], device=None):
        """Zero ``(carry_a, carry_c)`` on ``device`` (default: the network's)."""
        device = device if device is not None else self.log_std.device
        return (self.memory_a.initialize_carry(batch_dims, device),
                self.memory_c.initialize_carry(batch_dims, device))


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

    def update(self, batch: torch.Tensor, mesh=None) -> "RunningNorm":
        """Merge ``batch``'s rows into the statistics.  With a ``mesh``
        (``parallel/mesh.py``; every rank passes a batch of the same size)
        the rows are all ranks' batches, and every rank holds the same
        result: the global mean is the ranks' mean of their means, the
        global population variance their mean of ``var + (mean - global
        mean)^2``, two ``all_reduce`` calls."""
        flat = batch.reshape(-1, batch.shape[-1])
        n = flat.shape[0]
        # jnp.var is the population variance (ddof 0); torch.var defaults to ddof 1
        batch_mean, batch_var = flat.mean(0), flat.var(0, correction=0)
        if mesh is not None:
            local_mean = batch_mean
            batch_mean, = pmean([local_mean], mesh)
            batch_var, = pmean([batch_var + torch.square(local_mean - batch_mean)], mesh)
            n = n * mesh.size
        new_count = self.count + n
        delta = batch_mean - self.mean
        new_mean = self.mean + delta * (n / new_count)
        m_a = self.var * self.count
        m_b = batch_var * n
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


class RecurrentInferencePolicy:
    """The deterministic policy of an :class:`ActorCriticRecurrent` as a
    stateful ``obs -> actions``: each call advances the actor's carry (one
    row per env, ``carry``), which :meth:`reset` zeroes for the envs whose
    episode ended.  Observations are normalized by ``obs_norm`` where there
    is one.  It reads the network's parameters when called."""

    def __init__(self, net: ActorCriticRecurrent, obs_norm: Optional[RunningNorm],
                 batch_size: int):
        self.net = net
        self.obs_norm = obs_norm.to(net.log_std.device) if obs_norm is not None else None
        self.carry = net.initialize_carries((batch_size,))[0]

    @torch.no_grad()
    def __call__(self, obs: torch.Tensor) -> torch.Tensor:
        obs = self.obs_norm.normalize(obs) if self.obs_norm is not None else obs
        mean, self.carry = self.net.act_inference(obs, self.carry)
        return mean

    def reset(self, dones: torch.Tensor):
        self.carry = mask_carry(self.carry, dones)


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


def _flax_state_dict(tree: Dict, prefix: str, out: Dict[str, torch.Tensor]):
    """A flax tree of ``Dense`` layers and leaves as the ``state_dict`` of the
    module whose children carry flax's names (:func:`flax_tree`'s inverse for
    modules of linear layers)."""
    for name, sub in tree.items():
        if isinstance(sub, dict) and "kernel" in sub:
            out[f"{prefix}{name}.weight"] = torch.as_tensor(np.asarray(sub["kernel"]).T.copy())
            if "bias" in sub:
                out[f"{prefix}{name}.bias"] = torch.as_tensor(np.asarray(sub["bias"]).copy())
        elif isinstance(sub, dict):
            _flax_state_dict(sub, f"{prefix}{name}.", out)
        else:
            out[prefix + name] = torch.as_tensor(np.asarray(sub).copy())


def params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (``{"params": {"actor", "critic", "log_std"}}``
    or its inner dict) as an :class:`ActorCritic` ``state_dict``, or, where
    the tree has ``memory_a``, as an :class:`ActorCriticRecurrent` one."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    if "memory_a" in params:
        _flax_state_dict(params, "", out)
        return out
    _dense_to_linear(params["actor"], "actor", out)
    _dense_to_linear(params["critic"], "critic", out)
    out["log_std"] = torch.as_tensor(np.asarray(params["log_std"]).copy())
    return out


def params_to_jax(net: nn.Module) -> Dict:
    """The inverse of :func:`params_from_jax`: ``net``'s parameters as the
    flax tree ``{"params": {"actor": {"Dense_k": {"kernel" [in, out],
    "bias"}}, "critic": ..., "log_std"}}`` of numpy arrays (an
    :class:`ActorCriticRecurrent` adds ``memory_a`` and ``memory_c``)."""
    if isinstance(net, ActorCriticRecurrent):
        return {"params": flax_tree(net)}
    def dense(seq: nn.Sequential) -> Dict:
        linears = [m for m in seq if isinstance(m, nn.Linear)]
        return {f"Dense_{k}": {"kernel": m.weight.detach().cpu().numpy().T.copy(),
                               "bias": m.bias.detach().cpu().numpy().copy()}
                for k, m in enumerate(linears)}

    return {"params": {"actor": dense(net.actor), "critic": dense(net.critic),
                       "log_std": net.log_std.detach().cpu().numpy().copy()}}


def _has_params(module: nn.Module) -> bool:
    return next(module.parameters(), None) is not None


def flax_tree(module: nn.Module) -> Dict:
    """``module``'s parameters as the flax tree of numpy arrays its children's
    names spell: an ``nn.Linear`` is ``{"kernel" [in, out], "bias"}``, a
    convolution ``{"kernel" [*window, in, out], "bias"}``, a parameter held
    by a module is a leaf of its name."""
    if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
        w = module.weight.detach().cpu()
        kernel = w.T if isinstance(module, nn.Linear) else w.permute(*range(2, w.dim()), 1, 0)
        out = {"kernel": kernel.numpy().copy()}
        if module.bias is not None:
            out["bias"] = module.bias.detach().cpu().numpy().copy()
        return out
    out = {n: p.detach().cpu().numpy().copy() for n, p in module.named_parameters(recurse=False)}
    out.update({n: flax_tree(c) for n, c in module.named_children() if _has_params(c)})
    return out


def load_flax_tree(module: nn.Module, tree: Dict) -> nn.Module:
    """Copy the flax tree ``tree`` (the inverse of :func:`flax_tree`) into
    ``module``'s parameters; every parameter must be given, and nothing else."""
    state: Dict[str, torch.Tensor] = {}

    def walk(mod: nn.Module, sub: Dict, prefix: str):
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            k = torch.as_tensor(np.asarray(sub["kernel"]).copy())
            nd = k.dim()
            state[prefix + "weight"] = k.T if nd == 2 else k.permute(nd - 1, nd - 2, *range(nd - 2))
            if "bias" in sub:
                state[prefix + "bias"] = torch.as_tensor(np.asarray(sub["bias"]).copy())
            return
        children = {n: c for n, c in mod.named_children() if _has_params(c)}
        leaves = [n for n, _ in mod.named_parameters(recurse=False)]
        if set(sub) != set(children) | set(leaves):
            raise KeyError(f"flax tree at {prefix or '/'} has {sorted(sub)}, the module "
                           f"{sorted(set(children) | set(leaves))}")
        for name in leaves:
            state[prefix + name] = torch.as_tensor(np.asarray(sub[name]).copy())
        for name, child in children.items():
            walk(child, sub[name], f"{prefix}{name}.")

    walk(module, tree, "")
    module.load_state_dict({k: v.contiguous() for k, v in state.items()}, strict=True)
    return module


def read_checkpoint(path) -> dict:
    """The payload of a ``.pkl`` written by the JAX runner or the port's, with
    the JAX package's and JAX's objects loaded as stubs.  ``path`` may also
    be a binary file object."""
    if hasattr(path, "read"):
        return _CheckpointUnpickler(path).load()
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def load_jax_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Optional[RunningNorm]]:
    """Read a ``.pkl`` written by the JAX runner (or the port's runner):
    ``(state_dict, obs_norm)``, the :class:`ActorCritic` (or
    :class:`ActorCriticRecurrent`) parameters and the
    observation normalizer the policy was trained with (``None`` without
    empirical normalization).  A policy built from it must apply the
    normalizer: :func:`inference_policy`."""
    payload = read_checkpoint(path)
    return params_from_jax(payload["params"]), norm_from_checkpoint(payload.get("obs_norm"))
