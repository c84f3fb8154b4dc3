"""Deployment export (port of ``utils/export.py``): trained policies as files
a robot loads without this package.

* **TorchScript**, the reference's deployment format (its
  ``export_policy_as_jit`` and ``PolicyExporterLSTM``): the MLP actor with
  the observation normalizer folded in as a first layer
  (:func:`export_policy_as_jit`, ``policy_1.pt``), and the recurrent actor
  with its hidden state in buffers and a ``reset_memory()`` method
  (:func:`export_recurrent_policy_as_jit`, ``policy_lstm_1.pt``, LSTM or
  GRU).  Written from CPU copies of the port's modules.
* **torch.export** (:func:`export_policy_pt2`, ``policy.pt2``, loaded by
  :func:`load_pt2_policy`): the counterpart of the JAX package's StableHLO
  artifact (``export_policy_stablehlo`` / ``load_stablehlo_policy``), a
  serialized graph with a dynamic batch dimension that runs without the
  Python model code.
"""
from __future__ import annotations

import copy
import os
from typing import Callable, Optional

import torch
from torch import nn

from ..models.networks import ActorCriticRecurrent, RunningNorm

_TORCH_ACT = {"elu": nn.ELU, "relu": nn.ReLU, "selu": nn.SELU, "tanh": nn.Tanh,
              "lrelu": nn.LeakyReLU, "sigmoid": nn.Sigmoid, "crelu": nn.ReLU}


def _sequential(mlp: nn.Module, activation: str) -> nn.Sequential:
    """A CPU ``nn.Sequential`` of copies of ``mlp``'s linear layers (in
    order) with the activation between them: the reference's actor layout,
    whether ``mlp`` is the MLP policy's ``Sequential`` or the flax-named
    ``MLP`` of the recurrent one."""
    linears = [copy.deepcopy(m).cpu() for m in mlp.modules() if isinstance(m, nn.Linear)]
    layers = []
    for k, lin in enumerate(linears):
        layers.append(lin)
        if k < len(linears) - 1:
            layers.append(_TORCH_ACT[activation]())
    return nn.Sequential(*layers)


class _Normalize(nn.Module):
    """``(x - mean) / sqrt(var + 1e-8)``, the runner's observation
    normalization."""

    def __init__(self, norm: RunningNorm):
        super().__init__()
        self.register_buffer("mean", norm.mean.detach().cpu().clone())
        self.register_buffer("std", torch.sqrt(norm.var.detach().cpu() + 1e-8))

    def forward(self, x):
        return (x - self.mean) / self.std


def mlp_policy_module(actor: nn.Module, activation: str = "elu",
                      normalizer: Optional[RunningNorm] = None) -> nn.Sequential:
    """The deterministic MLP policy as one CPU module: the normalizer (where
    there is one), then the actor."""
    seq = _sequential(actor, activation)
    if normalizer is not None:
        seq = nn.Sequential(_Normalize(normalizer), *seq)
    return seq.eval()


def export_policy_as_jit(actor: nn.Module, path: str, *, activation: str = "elu",
                         normalizer: Optional[RunningNorm] = None,
                         filename: str = "policy_1.pt") -> str:
    """The MLP actor (``ActorCritic.actor``) as TorchScript; returns the
    file written."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, filename)
    torch.jit.script(mlp_policy_module(actor, activation, normalizer)).save(out)
    return out


def _lstm(cell: nn.Module, in_dim: int, hidden: int) -> nn.LSTM:
    """The flax-style LSTM cell (input kernels ``ii, if, ig, io`` without
    bias, hidden kernels ``h*`` with bias) as ``torch.nn.LSTM`` (gates i, f,
    g, o)."""
    g = cell._modules
    lstm = nn.LSTM(in_dim, hidden, num_layers=1)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.cat([g["i" + k].weight for k in "ifgo"]))
        lstm.weight_hh_l0.copy_(torch.cat([g["h" + k].weight for k in "ifgo"]))
        lstm.bias_hh_l0.copy_(torch.cat([g["h" + k].bias for k in "ifgo"]))
        lstm.bias_ih_l0.zero_()
    return lstm


def _gru(cell: nn.Module, in_dim: int, hidden: int) -> nn.GRU:
    """The flax-style GRU cell (``ir, iz, in`` with bias; ``hr, hz`` without,
    ``hn`` with) as ``torch.nn.GRU`` (gates r, z, n; the n gate's hidden bias
    inside the reset product, as flax has it)."""
    g = cell._modules
    gru = nn.GRU(in_dim, hidden, num_layers=1)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.cat([g[k].weight for k in ("ir", "iz", "in")]))
        gru.weight_hh_l0.copy_(torch.cat([g[k].weight for k in ("hr", "hz", "hn")]))
        gru.bias_ih_l0.copy_(torch.cat([g[k].bias for k in ("ir", "iz", "in")]))
        gru.bias_hh_l0.copy_(torch.cat([torch.zeros(2 * hidden), g["hn"].bias.detach().cpu()]))
    return gru


class PolicyExporterLSTM(nn.Module):
    """The reference's ``PolicyExporterLSTM`` contract: one env's actor with
    its ``(h, c)`` in buffers, advanced by each call and zeroed by
    ``reset_memory()``."""

    def __init__(self, norm: nn.Module, rnn: nn.LSTM, actor: nn.Sequential, hidden: int):
        super().__init__()
        self.norm, self.rnn, self.actor = norm, rnn, actor
        self.register_buffer("hidden_state", torch.zeros(1, 1, hidden))
        self.register_buffer("cell_state", torch.zeros(1, 1, hidden))

    def forward(self, x):
        out, (h, c) = self.rnn(self.norm(x).unsqueeze(0), (self.hidden_state, self.cell_state))
        self.hidden_state[:] = h
        self.cell_state[:] = c
        return self.actor(out.squeeze(0))

    @torch.jit.export
    def reset_memory(self):
        self.hidden_state[:] = 0.0
        self.cell_state[:] = 0.0


class PolicyExporterGRU(nn.Module):
    """:class:`PolicyExporterLSTM`'s contract for a GRU (one hidden buffer)."""

    def __init__(self, norm: nn.Module, rnn: nn.GRU, actor: nn.Sequential, hidden: int):
        super().__init__()
        self.norm, self.rnn, self.actor = norm, rnn, actor
        self.register_buffer("hidden_state", torch.zeros(1, 1, hidden))

    def forward(self, x):
        out, h = self.rnn(self.norm(x).unsqueeze(0), self.hidden_state)
        self.hidden_state[:] = h
        return self.actor(out.squeeze(0))

    @torch.jit.export
    def reset_memory(self):
        self.hidden_state[:] = 0.0


def export_recurrent_policy_as_jit(net: ActorCriticRecurrent, path: str, *,
                                   activation: str = "elu",
                                   normalizer: Optional[RunningNorm] = None,
                                   filename: str = "policy_lstm_1.pt") -> str:
    """The recurrent actor (``memory_a`` then the actor MLP) as TorchScript
    with the :class:`PolicyExporterLSTM` / :class:`PolicyExporterGRU`
    contract; returns the file written."""
    mem = net.memory_a
    cell, H = mem._modules[mem.cell_name], mem.hidden_size
    norm = _Normalize(normalizer) if normalizer is not None else nn.Identity()
    actor = _sequential(net.actor, activation)
    if mem.rnn_type == "lstm":
        exporter = PolicyExporterLSTM(norm, _lstm(cell, cell.ii.weight.shape[1], H), actor, H)
    else:
        exporter = PolicyExporterGRU(norm, _gru(cell, cell.ir.weight.shape[1], H), actor, H)
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, filename)
    torch.jit.script(exporter.eval()).save(out)
    return out


def export_policy_pt2(module: nn.Module, example_obs: torch.Tensor, path: str,
                      filename: str = "policy.pt2") -> str:
    """``module`` (``obs [B, n] -> actions``) traced by ``torch.export`` with
    a dynamic batch dimension and saved with ``torch.export.save`` (the
    counterpart of the JAX package's ``export_policy_stablehlo``); returns
    the file written."""
    batch = torch.export.Dim("batch")
    program = torch.export.export(module, (example_obs,), dynamic_shapes=({0: batch},))
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, filename)
    torch.export.save(program, out)
    return out


def load_pt2_policy(path: str, device="cpu") -> Callable[[torch.Tensor], torch.Tensor]:
    """The policy of a ``policy.pt2`` on ``device``: a callable ``obs ->
    actions`` (the counterpart of the JAX package's
    ``load_stablehlo_policy``)."""
    return torch.export.load(path).module().to(device)
