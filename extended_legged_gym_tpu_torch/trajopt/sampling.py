"""Trajectory-gradient sampling: the diffusion-style sampling-MPC core (port of
``trajopt/sampling.py``).

Noise schedule: node h gets ``noise_scaling · horizon_diffuse_factor^(Hnode−h)``,
annealed per diffusion iteration i by ``traj_diffuse_factor^i``.  The current
mean rides along as sample 0, so the update never loses the incumbent
(Nsample = 127 gives 128 evaluated rollouts).  Node 0 is the action being
executed and stays fixed.

The noise comes from a ``torch.Generator``; tests inject it instead (the
``noise`` argument of :meth:`TrajGradSampling.optimize`), since JAX's PRNG
streams cannot be reproduced in torch.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.tracing import span
from .optimizers import make_update_fn
from .spline import TrajSpline


class TrajOptConfig(NamedTuple):
    num_samples: int = 127
    temp_sample: float = 0.1
    horizon_samples: int = 16
    horizon_nodes: int = 4
    num_diffuse_steps: int = 2
    num_diffuse_steps_init: int = 10
    horizon_diffuse_factor: float = 0.9
    traj_diffuse_factor: float = 0.5
    noise_scaling: float = 1.5
    update_method: str = "avwbfo"
    gamma: float = 1.0
    interp_method: str = "spline"


class TrajGradSampling:
    """Sampling-based trajectory optimizer over a batch of main envs.

    ``rollout_fn(all_us)`` maps dense controls ``[E, S, Hsample+1, A]`` to
    per-step rewards ``[E, S, Hsample+1]``."""

    def __init__(self, cfg: TrajOptConfig, num_envs: int, num_actions: int, device="cuda"):
        self.cfg = cfg
        self.num_envs = num_envs
        self.num_actions = num_actions
        self.device = resolve_device(device)
        self.spline = TrajSpline(cfg.horizon_nodes, cfg.horizon_samples, cfg.interp_method,
                                 device=self.device)
        self.update_fn = make_update_fn(cfg.update_method, cfg.temp_sample, self.spline.A,
                                        cfg.gamma)
        h = np.arange(cfg.horizon_nodes + 1, dtype=np.float32)
        sigma = cfg.noise_scaling * cfg.horizon_diffuse_factor ** (cfg.horizon_nodes - h)
        self.node_sigma = torch.as_tensor(sigma.astype(np.float32), device=self.device)

    def node2u(self, nodes: torch.Tensor) -> torch.Tensor:
        return self.spline.node2dense(nodes)

    def u2node(self, us: torch.Tensor) -> torch.Tensor:
        return self.spline.dense2node(us)

    def init_node_trajectories(self) -> torch.Tensor:
        return torch.zeros(self.num_envs, self.cfg.horizon_nodes + 1, self.num_actions,
                           device=self.device)

    def init_from_actions(self, action_seq: torch.Tensor) -> torch.Tensor:
        """Warm start: the nodes fitted to a dense action sequence that a
        policy rolled out, ``[..., Hsample+1, A] -> [..., Hnode+1, A]``."""
        return self.u2node(action_seq)

    def _disc(self) -> torch.Tensor:
        return self.cfg.gamma ** torch.arange(self.cfg.horizon_samples + 1, dtype=torch.float32,
                                              device=self.device)

    def optimize(self, nodes: torch.Tensor, rollout_fn: Callable, n_diffuse: int,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Run ``n_diffuse`` diffusion iterations on the mean node trajectories
        ``[E, Hnode+1, A]``.  ``noise`` ``[n_diffuse, E, Nsample, Hnode+1, A]``
        replaces the standard-normal draws from ``generator``."""
        cfg = self.cfg
        E, A = nodes.shape[0], self.num_actions
        infos = []
        for i in range(n_diffuse):
            with span("mpc.diffuse"):
                with span("mpc.sample"):
                    sigma = (self.node_sigma[None, None, :, None]
                             * cfg.traj_diffuse_factor ** float(i))
                    if noise is not None:
                        eps = noise[i]
                    else:
                        eps = torch.randn((E, cfg.num_samples, cfg.horizon_nodes + 1, A),
                                          generator=generator, device=nodes.device)
                    samples = torch.cat([nodes[:, None], nodes[:, None] + sigma * eps], dim=1)
                    samples[:, :, 0, :] = nodes[:, None, 0, :]
                    us = self.node2u(samples)
                rewards = rollout_fn(us)                                   # [E, S, Hs+1]
                with span("mpc.update"):
                    nodes = self.update_fn(nodes, samples, rewards)
                    infos.append(dict(rew_mean=rewards.mean(dim=(1, 2)),
                                      rew_best=rewards.sum(dim=-1).amax(dim=1)
                                      / (cfg.horizon_samples + 1)))
        if not infos:
            empty = torch.zeros(0, E, device=nodes.device)
            return nodes, dict(rew_mean=empty, rew_best=empty)
        return nodes, {k: torch.stack([d[k] for d in infos]) for k in infos[0]}

    def shift(self, nodes: torch.Tensor, n_steps: int = 1,
              append_action: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Receding horizon: node -> dense, roll left, repeat-or-append the
        tail, dense -> node."""
        us = torch.roll(self.node2u(nodes), -n_steps, dims=-2)
        if append_action is None:
            tail = us[..., -n_steps - 1:-n_steps, :].repeat_interleave(n_steps, dim=-2)
        else:
            tail = append_action[..., None, :].expand(us[..., -n_steps:, :].shape)
        us = torch.cat([us[..., :-n_steps, :], tail], dim=-2)
        return self.u2node(us)

    @span("mpc.polish")
    def polish(self, nodes: torch.Tensor, rollout_fn: Callable, n_iters: int, lr: float
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """First-order refinement of the mean node trajectories by
        backpropagating the summed discounted reward through the spline and
        a differentiable ``rollout_fn``: normalized-gradient ascent (the norm
        taken over every node, node 0 included, as in the JAX package), the
        three line-search scales tried in one rollout batch, a per-env
        monotone accept, node 0 pinned."""
        disc = self._disc()
        scales = torch.tensor([1.0, 0.25, 0.0625], device=nodes.device)
        E = nodes.shape[0]
        gains = []
        for _ in range(n_iters):
            with torch.enable_grad():
                nds = nodes.detach().requires_grad_(True)
                J_old = torch.sum(rollout_fn(self.node2u(nds)[:, None])[:, 0] * disc, dim=-1)
                g, = torch.autograd.grad(J_old.sum(), nds)
            J_old = J_old.detach()
            gn = g / (torch.linalg.norm(g.reshape(E, -1), dim=-1)[:, None, None] + 1e-8)
            cands = nodes[:, None] + (lr * scales)[None, :, None, None] * gn[:, None]
            cands[:, :, 0] = nodes[:, None, 0]                  # the executing node stays
            with torch.no_grad():
                Js = torch.sum(rollout_fn(self.node2u(cands)) * disc, dim=-1)   # [E, 3]
            best = torch.argmax(Js, dim=1)
            J_new = Js.gather(1, best[:, None])[:, 0]
            cand = cands[torch.arange(E, device=nodes.device), best]
            nodes = torch.where((J_new > J_old)[:, None, None], cand, nodes)
            gains.append((J_new - J_old).clamp(min=0.0).mean())
        return nodes, dict(polish_gain=torch.stack(gains))

    @span("mpc.polish")
    def polish_fd(self, nodes: torch.Tensor, rollout_fn: Callable, n_iters: int, lr: float,
                  eps: float = 0.05) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Gradient polish with a batched central-difference gradient: the
        2·D+1 perturbed rollouts (D = Hnode·A free coordinates; node 0 is
        pinned) run as one rollout batch, then a 3-point line search along the
        normalized gradient with a per-env monotone accept."""
        cfg = self.cfg
        E, A, Hn = nodes.shape[0], self.num_actions, cfg.horizon_nodes
        D = Hn * A
        basis = torch.eye(D, dtype=nodes.dtype, device=nodes.device).reshape(D, Hn, A)
        basis = torch.cat([torch.zeros(D, 1, A, dtype=nodes.dtype, device=nodes.device), basis], 1)
        stencil = torch.cat([eps * basis, -eps * basis, torch.zeros_like(basis[:1])], 0)
        disc = self._disc()
        scales = torch.tensor([1.0, 0.25, 0.0625], device=nodes.device)

        def scores(samples):                                   # [E, S, Hn+1, A] -> [E, S]
            return torch.sum(rollout_fn(self.node2u(samples)) * disc, dim=-1)

        gains = []
        for _ in range(n_iters):
            J = scores(nodes[:, None] + stencil[None])          # [E, 2D+1]
            J_old = J[:, 2 * D]
            g = ((J[:, :D] - J[:, D:2 * D]) / (2.0 * eps)).reshape(E, Hn, A)
            g = torch.cat([torch.zeros_like(g[:, :1]), g], 1)
            gn = g / (torch.linalg.norm(g.reshape(E, -1), dim=-1)[:, None, None] + 1e-8)
            cands = nodes[:, None] + (lr * scales)[None, :, None, None] * gn[:, None]
            Js = scores(cands)                                  # [E, 3]
            best = torch.argmax(Js, dim=1)
            J_new = Js.gather(1, best[:, None])[:, 0]
            cand = cands[torch.arange(E, device=nodes.device), best]
            nodes = torch.where((J_new > J_old)[:, None, None], cand, nodes)
            gains.append((J_new - J_old).clamp(min=0.0).mean())
        return nodes, dict(polish_gain=torch.stack(gains))
