"""Depth-image encoders (port of ``models/depth_backbone.py``): DepthMLPEnc,
DepthHistMLPEnc, the DepthOnlyFCBackbone CNN, StackDepthEncoder,
``make_depth_encoder`` and RecurrentDepthBackbone.

flax infers a layer's input width at its first call; here the encoders take
the frame size ``in_hw = (H, W)`` (and the buffer length) when built.  Three
layout rules keep the parameters interchangeable with the JAX package's:

* flax's ``Conv`` pads "SAME" as XLA does: ``ceil(n / s)`` outputs, the
  padding split with the odd pixel at the end (16 -> 8 with a 5-tap kernel
  at stride 2 pads 1 before and 2 after), which ``nn.Conv2d(padding=...)``
  cannot express, so :class:`SameConv2d` pads with ``F.pad`` first;
* flax runs NHWC and flattens a feature map in (h, w, c) order, so the CNN
  flattens its NCHW map after moving the channels last, and ``Dense_0``'s
  rows carry over unpermuted;
* StackDepthEncoder's temporal convolution treats the frames as channels
  over the 32-wide latent (flax NWC, torch NCW over the same [B, T, 32]
  stack) and flattens its output in (w, c) order.

Convolutions start as flax's do: ``lecun_normal`` kernels (fan-in: input
channels times the window), zero biases.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .networks import MLP, GRUCell, activation_fn, lecun_normal_, rnn_carry


def same_pads(n: int, k: int, s: int) -> Tuple[int, int, int]:
    """XLA's "SAME" padding of a length-``n`` axis for a ``k``-tap window at
    stride ``s``: ``(before, after, outputs)``."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2, out


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's "SAME" padding and initialisation."""

    def __init__(self, cin: int, cout: int, k: int, s: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cin, cout, k, stride=s)
        lecun_normal_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        th, bh, _ = same_pads(x.shape[-2], kh, sh)
        lw, rw, _ = same_pads(x.shape[-1], kw, sw)
        return super().forward(F.pad(x, (lw, rw, th, bh)))


class DepthMLPEnc(nn.Module):
    """Flatten-then-MLP depth encoder: [B, H, W] -> [B, output_dim]."""

    def __init__(self, in_hw: Tuple[int, int], output_dim: int = 32,
                 hidden_dims: Sequence[int] = (256, 128), activation: str = "elu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.MLP_0 = MLP(in_hw[0] * in_hw[1], hidden_dims, output_dim, activation, generator)

    def forward(self, depth: torch.Tensor) -> torch.Tensor:
        return self.MLP_0(depth.reshape(depth.shape[0], -1))


class DepthHistMLPEnc(nn.Module):
    """Frame-stacked depth history encoder: [B, T, H, W] flattened into an
    MLP."""

    def __init__(self, in_hw: Tuple[int, int], buffer_len: int, output_dim: int = 32,
                 hidden_dims: Sequence[int] = (512, 256), activation: str = "elu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.MLP_0 = MLP(buffer_len * in_hw[0] * in_hw[1], hidden_dims, output_dim, activation,
                         generator)

    def forward(self, depth_hist: torch.Tensor) -> torch.Tensor:
        return self.MLP_0(depth_hist.reshape(depth_hist.shape[0], -1))


class DepthOnlyFCBackbone(nn.Module):
    """Small CNN depth backbone (reference DepthOnlyFCBackbone58x87, any input
    size): 5x5/2 -> 16, 3x3/2 -> 32, 3x3/1 -> 32 ("SAME"), then 128 -> out."""

    def __init__(self, in_hw: Tuple[int, int], output_dim: int = 32, activation: str = "elu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = activation_fn(activation)
        self.Conv_0 = SameConv2d(1, 16, 5, 2, generator)
        self.Conv_1 = SameConv2d(16, 32, 3, 2, generator)
        self.Conv_2 = SameConv2d(32, 32, 3, 1, generator)
        h, w = (same_pads(same_pads(n, 5, 2)[2], 3, 2)[2] for n in in_hw)
        self.Dense_0 = nn.Linear(h * w * 32, 128)
        self.Dense_1 = nn.Linear(128, output_dim)
        for layer in (self.Dense_0, self.Dense_1):
            lecun_normal_(layer, generator)

    def forward(self, depth: torch.Tensor) -> torch.Tensor:
        """[B, H, W] -> [B, output_dim]."""
        act = self.act
        x = act(self.Conv_0(depth[:, None]))
        x = act(self.Conv_1(x))
        x = act(self.Conv_2(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)      # flax's (h, w, c) order
        return self.Dense_1(act(self.Dense_0(x)))


class StackDepthEncoder(nn.Module):
    """Frame-stack encoder (reference StackDepthEncoder): each of the
    ``buffer_len`` frames through the shared CNN to a 32-d latent; the [B, T,
    32] stack mixed by a Conv1d with the frames as channels over the latent
    axis (32 -> 15 taps at 4/2, -> 14 at 2/1, 16 channels); an activated
    Dense to the output."""

    def __init__(self, in_hw: Tuple[int, int], output_dim: int = 32, buffer_len: int = 2,
                 activation: str = "elu", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = activation_fn(activation)
        self.DepthOnlyFCBackbone_0 = DepthOnlyFCBackbone(in_hw, 32, activation, generator)
        self.Conv_0 = nn.Conv1d(buffer_len, 16, 4, stride=2)
        self.Conv_1 = nn.Conv1d(16, 16, 2, stride=1)
        self.Dense_0 = nn.Linear(16 * 14, output_dim)
        for layer in (self.Conv_0, self.Conv_1, self.Dense_0):
            lecun_normal_(layer, generator)

    def forward(self, depth_stack: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W] -> [B, output_dim]."""
        act = self.act
        B, T = depth_stack.shape[:2]
        lat = self.DepthOnlyFCBackbone_0(depth_stack.reshape(B * T, *depth_stack.shape[2:]))
        x = act(self.Conv_0(lat.reshape(B, T, 32)))          # NCW: frames are the channels
        x = act(self.Conv_1(x))
        x = x.transpose(1, 2).reshape(B, -1)                   # flax's (w, c) order
        return act(self.Dense_0(x))


def make_depth_encoder(name: str, in_hw: Tuple[int, int], output_dim: int = 32,
                       buffer_len: int = 2, activation: str = "elu",
                       generator: Optional[torch.Generator] = None) -> nn.Module:
    """Encoder selection by ``cfg.depth.encoder``; ``in_hw`` is the processed
    frame's (H, W)."""
    if name == "mlp":
        return DepthMLPEnc(in_hw, output_dim, activation=activation, generator=generator)
    if name == "hist_mlp":
        return DepthHistMLPEnc(in_hw, buffer_len, output_dim, activation=activation,
                               generator=generator)
    if name == "cnn":
        return DepthOnlyFCBackbone(in_hw, output_dim, activation, generator)
    if name == "stack":
        return StackDepthEncoder(in_hw, output_dim, buffer_len, activation, generator)
    raise ValueError(f"unknown depth encoder {name!r}")


class RecurrentDepthBackbone(nn.Module):
    """CNN encoder (64) + proprioception -> GRU -> Dense; the caller carries
    the GRU state."""

    def __init__(self, in_hw: Tuple[int, int], proprio_dim: int, output_dim: int = 32,
                 hidden_size: int = 128, activation: str = "elu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.DepthOnlyFCBackbone_0 = DepthOnlyFCBackbone(in_hw, 64, activation, generator)
        self.GRUCell_0 = GRUCell(64 + proprio_dim, hidden_size, generator)
        self.Dense_0 = nn.Linear(hidden_size, output_dim)
        lecun_normal_(self.Dense_0, generator)

    def forward(self, depth: torch.Tensor, proprio: torch.Tensor, carry: torch.Tensor):
        x = torch.cat([self.DepthOnlyFCBackbone_0(depth), proprio], dim=-1)
        carry, out = self.GRUCell_0(carry, x)
        return self.Dense_0(out), carry

    def initialize_carry(self, batch_dims: Tuple[int, ...], device="cpu"):
        return rnn_carry("gru", self.hidden_size, batch_dims, device)
