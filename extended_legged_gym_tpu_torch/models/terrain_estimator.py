"""Depth -> raycast terrain estimator (port of ``models/terrain_estimator.py``):
depth encoder -> concatenation with proprioception -> GRU -> MLP decoder to
the ray distances, and the bridge to the JAX runner's checkpoint tree
``{"params": {<encoder>_0, GRUCell_0, MLP_0}}``."""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from .depth_backbone import make_depth_encoder
from .networks import MLP, GRUCell, flax_tree, load_flax_tree, rnn_carry


class TerrainEstimator(nn.Module):
    """``(depth [B, H, W] or, for the "stack" and "hist_mlp" encoders, the
    frame buffer [B, T, H, W], proprio [B, P], carry [B, rnn_hidden]) ->
    (distances [B, R], carry)``.  ``in_hw`` is the processed frame's (H, W);
    the encoder is the child flax names after its class (``DepthOnlyFCBackbone_0``
    for "cnn")."""

    def __init__(self, num_raycast: int, proprio_dim: int, in_hw: Tuple[int, int],
                 depth_enc_dim: int = 64, rnn_hidden: int = 128,
                 decoder_dims: Sequence[int] = (128, 128), activation: str = "elu",
                 encoder: str = "cnn", buffer_len: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rnn_hidden = rnn_hidden
        enc = make_depth_encoder(encoder, in_hw, depth_enc_dim, buffer_len, activation, generator)
        self.encoder_name = type(enc).__name__ + "_0"
        self.add_module(self.encoder_name, enc)
        self.GRUCell_0 = GRUCell(depth_enc_dim + proprio_dim, rnn_hidden, generator)
        self.MLP_0 = MLP(rnn_hidden, decoder_dims, num_raycast, activation, generator)

    def forward(self, depth: torch.Tensor, proprio: torch.Tensor, carry: torch.Tensor):
        x = torch.cat([self._modules[self.encoder_name](depth), proprio], dim=-1)
        carry, h = self.GRUCell_0(carry, x)
        return self.MLP_0(h), carry

    def predict_sequence(self, depths: torch.Tensor, proprios: torch.Tensor,
                         dones: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
        """The per-step ``forward`` over a window ``[T, B, ...]`` from
        ``carry``, the carry zeroed after step t where ``dones[t]`` holds:
        predictions [T, B, R].  The encoder and the decoder see all T x B
        inputs in one call each; only the GRU steps in order."""
        T, B = proprios.shape[:2]
        enc = self._modules[self.encoder_name](depths.reshape(T * B, *depths.shape[2:]))
        x = torch.cat([enc.reshape(T, B, -1), proprios], dim=-1)
        hs = []
        for t in range(T):
            carry, h = self.GRUCell_0(carry, x[t])
            hs.append(h)
            carry = torch.where(dones[t][:, None], torch.zeros_like(carry), carry)
        return self.MLP_0(torch.stack(hs))

    def initialize_carry(self, batch_dims: Tuple[int, ...], device="cpu") -> torch.Tensor:
        return rnn_carry("gru", self.rnn_hidden, batch_dims, device)


def estimator_params_from_jax(net: TerrainEstimator, params: Dict) -> TerrainEstimator:
    """Load the JAX runner's estimator tree (``{"params": {...}}`` or its
    inner dict) into ``net``."""
    return load_flax_tree(net, params.get("params", params))


def estimator_params_to_jax(net: TerrainEstimator) -> Dict:
    """``net``'s parameters as the JAX runner's tree ``{"params": {...}}`` of
    numpy arrays."""
    return {"params": flax_tree(net)}
