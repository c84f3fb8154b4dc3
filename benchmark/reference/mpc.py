"""Plain reference of diffusion-style sampling MPC over node trajectories
(DIAL-MPC's annealed sampling with a per-node weighted update): the
Catmull-Rom node-to-dense map, the annealed noise schedule, the AVWBFO
update (per-node softmax weights of the z-scored discounted reward-to-go
under each node's basis column), the finite-difference polish's gradient
and line-search candidates, and the per-step reward of a rollout env."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .physics import quat_rotate_inverse


def interp_matrix(n_nodes: int, n_dense: int) -> np.ndarray:
    """Catmull-Rom interpolation ``dense = A @ nodes`` [n_dense, n_nodes],
    nodes evenly spread over the horizon, ends clamped by knot duplication."""
    A = np.zeros((n_dense, n_nodes), dtype=np.float32)
    s = np.linspace(0.0, n_nodes - 1.0, n_dense)
    seg = np.clip(np.floor(s).astype(int), 0, n_nodes - 2)
    t = s - seg
    M = np.array([[0.0, 2.0, 0.0, 0.0], [-1.0, 0.0, 1.0, 0.0],
                  [2.0, -5.0, 4.0, -1.0], [-1.0, 3.0, -3.0, 1.0]]) / 2.0
    for i in range(n_dense):
        w = np.array([1.0, t[i], t[i] ** 2, t[i] ** 3]) @ M
        for j, dk in enumerate((-1, 0, 1, 2)):
            A[i, int(np.clip(seg[i] + dk, 0, n_nodes - 1))] += w[j]
    return A


class Sampler:
    """The sampling MPC's arithmetic for one configuration (its
    ``trajectory_opt`` group)."""

    def __init__(self, to: dict, num_actions: int, device):
        self.to, self.A_n = to, num_actions
        self.Hn, self.Hs = to["horizon_nodes"], to["horizon_samples"]
        self.A = torch.as_tensor(interp_matrix(self.Hn + 1, self.Hs + 1), device=device)
        h = np.arange(self.Hn + 1, dtype=np.float32)
        sigma = to["noise_scaling"] * to["horizon_diffuse_factor"] ** (self.Hn - h)
        self.node_sigma = torch.as_tensor(sigma.astype(np.float32), device=device)
        self.disc = to["gamma"] ** torch.arange(self.Hs + 1, dtype=torch.float32, device=device)

    def dense(self, nodes):
        return torch.einsum("dn,...na->...da", self.A, nodes)

    def samples(self, nodes, i: int, eps):
        """The mean (sample 0) and the annealed perturbations of diffusion
        iteration ``i``, node 0 held at the mean's."""
        sigma = self.node_sigma[None, None, :, None] * self.to["traj_diffuse_factor"] ** float(i)
        s = torch.cat([nodes[:, None], nodes[:, None] + sigma * eps], dim=1)
        s[:, :, 0, :] = nodes[:, None, 0, :]
        return s

    def update(self, samples, rewards, half: bool = False):
        """AVWBFO: the new mean nodes ``[E, Hn+1, A]`` from samples
        ``[E, N, Hn+1, A]`` and per-step rewards ``[E, N, Hs+1]``."""
        if half:                        # a planted fault: half the samples left out
            n = samples.shape[1] // 2
            samples, rewards = samples[:, :n], rewards[:, :n]
        g = self.to["gamma"]
        rtg = torch.empty_like(rewards)
        acc = torch.zeros_like(rewards[..., 0])
        for t in range(rewards.shape[-1] - 1, -1, -1):
            acc = rewards[..., t] + g * acc
            rtg[..., t] = acc
        pos = self.A.clamp(min=0.0)
        col = pos / (pos.sum(dim=0, keepdim=True) + 1e-9)
        scores = torch.einsum("end,dh->enh", rtg, col)
        z = (scores - scores.mean(dim=1, keepdim=True)) / (
            scores.std(dim=1, keepdim=True, correction=0) + 1e-6)
        w = torch.softmax(z / self.to["temp_sample"], dim=1)
        return torch.einsum("enh,enha->eha", w, samples)

    def stencil(self, nodes):
        """The fd polish's 2D+1 perturbed node trajectories per env."""
        E, Hn, A = nodes.shape[0], self.Hn, self.A_n
        D, eps = Hn * A, self.to["polish_fd_eps"]
        basis = torch.eye(D, dtype=nodes.dtype, device=nodes.device).reshape(D, Hn, A)
        basis = torch.cat([torch.zeros(D, 1, A, dtype=nodes.dtype, device=nodes.device), basis], 1)
        st = torch.cat([eps * basis, -eps * basis, torch.zeros_like(basis[:1])], 0)
        return nodes[:, None] + st[None]

    def candidates(self, nodes, stencil_rewards):
        """The three line-search candidates along the normalized central
        difference gradient of the stencil's discounted returns, and the
        incumbent's return."""
        E, Hn, A = nodes.shape[0], self.Hn, self.A_n
        D, eps = Hn * A, self.to["polish_fd_eps"]
        J = torch.sum(stencil_rewards * self.disc, dim=-1)
        g = ((J[:, :D] - J[:, D:2 * D]) / (2.0 * eps)).reshape(E, Hn, A)
        g = torch.cat([torch.zeros_like(g[:, :1]), g], 1)
        gn = g / (torch.linalg.norm(g.reshape(E, -1), dim=-1)[:, None, None] + 1e-8)
        scales = torch.tensor([1.0, 0.25, 0.0625], device=nodes.device)
        return (nodes[:, None] + (self.to["polish_lr"] * scales)[None, :, None, None]
                * gn[:, None]), J[:, 2 * D]

    def accept(self, nodes, cands, J_old, cand_rewards):
        """The per-env monotone accept of the best candidate."""
        E = nodes.shape[0]
        Js = torch.sum(cand_rewards * self.disc, dim=-1)
        best = torch.argmax(Js, dim=1)
        J_new = Js.gather(1, best[:, None])[:, 0]
        cand = cands[torch.arange(E, device=nodes.device), best]
        return torch.where((J_new > J_old)[:, None, None], cand, nodes)


# ----------------------------------------------------------------- rewards
class RolloutReward:
    """The per-step reward of a rollout env: the configuration's non-zero
    scales times dt over legged_gym's terms (no clip where
    ``only_positive_rewards`` is off), computed from the env's state after
    its physics step and the contact bookkeeping it carried in."""

    def __init__(self, config: dict, robot, device):
        rw, ctl = config["rewards"], config["control"]
        self.dt = ctl["decimation"] * config["sim"]["dt"]
        self.sigma = rw["tracking_sigma"]
        self.only_positive = rw["only_positive_rewards"]
        self.terms = {k: v for k, v in rw["scales"].items() if k != "termination" and v != 0}
        self.feet = torch.as_tensor(robot.foot_geoms(), device=device)
        self.penalised = torch.as_tensor(robot.geoms_matching(config["asset"]["penalize_contacts_on"]),
                                         dtype=torch.int64, device=device)
        unknown = set(self.terms) - set(self.TERMS)
        if unknown:
            raise ValueError(f"no reference for the reward terms {sorted(unknown)}")

    TERMS = ("tracking_lin_vel", "tracking_ang_vel", "lin_vel_z", "ang_vel_xy", "orientation",
             "torques", "dof_acc", "feet_air_time", "collision", "action_rate")

    def __call__(self, s: Dict[str, torch.Tensor]):
        gf = s["geom_forces"]
        contact = gf[:, self.feet, 2] > 1.0
        contact_filt = contact | s["last_contacts"]
        first_contact = (s["feet_air_time"] > 0.0) & contact_filt
        air = s["feet_air_time"] + self.dt
        lin, ang, grav = s["base_lin_vel"], s["base_ang_vel"], s["projected_gravity"]
        cmd = s["commands"]
        val = {
            "tracking_lin_vel": torch.exp(-torch.sum(torch.square(cmd[:, :2] - lin[:, :2]), 1)
                                          / self.sigma),
            "tracking_ang_vel": torch.exp(-torch.square(cmd[:, 2] - ang[:, 2]) / self.sigma),
            "lin_vel_z": torch.square(lin[:, 2]),
            "ang_vel_xy": torch.sum(torch.square(ang[:, :2]), dim=1),
            "orientation": torch.sum(torch.square(grav[:, :2]), dim=1),
            "torques": torch.sum(torch.square(s["torques"]), dim=1),
            "dof_acc": torch.sum(torch.square((s["last_dof_vel"] - s["joint_vel"]) / self.dt), 1),
            "feet_air_time": torch.sum((air - 0.5) * first_contact, dim=1)
            * (torch.linalg.norm(cmd[:, :2], dim=1) > 0.1),
            "collision": torch.sum((torch.linalg.norm(gf[:, self.penalised], dim=-1) > 0.1)
                                   .to(torch.float32), dim=1),
            "action_rate": torch.sum(torch.square(s["last_actions"] - s["actions"]), dim=1),
        }
        rew = torch.zeros_like(lin[:, 0])
        for name, scale in self.terms.items():
            rew = rew + val[name] * torch.tensor(scale * self.dt, dtype=torch.float32)
        if self.only_positive:
            rew = rew.clamp(min=0.0)
        return rew


def body_frame(base_quat, base_lin_vel, base_ang_vel):
    """Body-frame linear and angular velocity and projected gravity."""
    grav = torch.tensor([0.0, 0.0, -1.0], device=base_quat.device).expand_as(base_lin_vel)
    return (quat_rotate_inverse(base_quat, base_lin_vel),
            quat_rotate_inverse(base_quat, base_ang_vel),
            quat_rotate_inverse(base_quat, grav))
