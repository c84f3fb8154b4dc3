"""ANYdrive actuator network (port of ``models/actuator_net.py``): the LSTM
series-elastic-actuator model that maps each joint's (position error,
velocity) to a torque, with a hidden state carried per env and joint.

The weights are the JAX package's committed JSON
(``extended_legged_gym_tpu/robots/data/anydrive_v3_lstm.json``, read in
place): two LSTM layers of 8 units, a linear head, the input scaling
``in_scale`` (2.0, 0.25) and the output scaling ``out_scale`` (20).  The cell
is written gate by gate in torch's gate order (i, f, g, o), as the JAX
``__call__`` is, over inputs ``[..., 2]``; no kernel stands behind it (the
JAX module is plain ``jnp``).  ``extract_weights`` pulls the weights out of
the reference's TorchScript file, ``save_weights_json`` writes them as that
JSON and ``load_weights_json`` reads it back as tensors.
"""
from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np
import torch

Hidden = Tuple[torch.Tensor, torch.Tensor]


def extract_weights(torchscript_path: str) -> Dict[str, np.ndarray]:
    """The LSTM and linear parameters and the in / out scaling buffers
    (flattened) of a TorchScript actuator network, as float arrays by name.
    The scripted forward is ``out_scale * linear(lstm(in_scale * x))``."""
    m = torch.jit.load(torchscript_path, map_location="cpu")
    out = {name: p.detach().numpy() for name, p in m.named_parameters()}
    out.update({name: b.detach().numpy().reshape(-1) for name, b in m.named_buffers()})
    return out


def save_weights_json(weights: Dict[str, np.ndarray], path: str):
    with open(path, "w") as f:
        json.dump({k: np.asarray(v).tolist() for k, v in weights.items()}, f)


def load_weights_json(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """The weights of a :func:`save_weights_json` file as float32 tensors on
    ``device``."""
    with open(path) as f:
        d = json.load(f)
    return {k: torch.as_tensor(np.array(v, np.float32), device=device) for k, v in d.items()}


class ActuatorNetLSTM:
    """Stateless apply over an explicit hidden state ``(h, c)``, each
    ``[..., num_layers, hidden]``; inputs ``[..., 2]`` = (position error,
    velocity); output the torque ``[...]``."""

    def __init__(self, weights: Dict[str, torch.Tensor]):
        self.w = weights
        self.num_layers = 1 + max(int(k.split("_l")[-1]) for k in weights
                                  if k.startswith("lstm.weight_ih"))
        self.hidden = weights["lstm.weight_hh_l0"].shape[1]

    @classmethod
    def from_json(cls, path: str, device="cpu") -> "ActuatorNetLSTM":
        return cls(load_weights_json(path, device))

    def init_hidden(self, batch_shape: Tuple[int, ...], device=None) -> Hidden:
        shape = tuple(batch_shape) + (self.num_layers, self.hidden)
        device = device if device is not None else self.w["linear.bias"].device
        return torch.zeros(shape, device=device), torch.zeros(shape, device=device)

    def __call__(self, x: torch.Tensor, hidden: Hidden) -> Tuple[torch.Tensor, Hidden]:
        """``x [..., 2] -> (torque [...], new_hidden)``."""
        h_all, c_all = hidden
        w = self.w
        inp = x * w["in_scale"] if "in_scale" in w else x
        new_h, new_c = [], []
        for layer in range(self.num_layers):
            gates = (inp @ w[f"lstm.weight_ih_l{layer}"].T + h_all[..., layer, :]
                     @ w[f"lstm.weight_hh_l{layer}"].T
                     + (w[f"lstm.bias_ih_l{layer}"] + w[f"lstm.bias_hh_l{layer}"]))
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c_all[..., layer, :] + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            new_h.append(h)
            new_c.append(c)
            inp = h
        torque = inp @ w["linear.weight"].T + w["linear.bias"]
        if "out_scale" in w:
            torque = torque * w["out_scale"]
        return torque[..., 0], (torch.stack(new_h, dim=-2), torch.stack(new_c, dim=-2))
