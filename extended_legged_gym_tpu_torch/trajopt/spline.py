"""Node <-> dense trajectory conversion (port of ``trajopt/spline.py``)."""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.math import _spline_interp_matrix_np
from ..utils.math import spline_fit_matrix, spline_interp_matrix  # noqa: F401 (public API)


class TrajSpline:
    """Fixed-size node <-> dense converter for one (Hnode, Hsample) pair.
    Trajectories carry ``H + 1`` points (node 0 = the current step)."""

    def __init__(self, horizon_nodes: int, horizon_samples: int, method: str = "spline",
                 device="cuda"):
        device = resolve_device(device)
        self.n_nodes = horizon_nodes + 1
        self.n_dense = horizon_samples + 1
        A = _spline_interp_matrix_np(self.n_nodes, self.n_dense, method)   # [D, N]
        self.A_np = A
        self.A = torch.as_tensor(A, device=device)
        self.P = torch.as_tensor(np.linalg.pinv(A).astype(np.float32), device=device)  # [N, D]

    def node2dense(self, nodes: torch.Tensor) -> torch.Tensor:
        """[..., Hnode+1, A] -> [..., Hsample+1, A]."""
        return torch.einsum("dn,...na->...da", self.A, nodes)

    def dense2node(self, dense: torch.Tensor) -> torch.Tensor:
        """Least-squares fit [..., Hsample+1, A] -> [..., Hnode+1, A]."""
        return torch.einsum("nd,...da->...na", self.P, dense)
