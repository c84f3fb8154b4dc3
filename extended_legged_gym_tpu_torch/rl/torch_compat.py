"""rsl_rl checkpoint interop (port of ``rl/torch_compat.py``): the reference
repository's ActorCritic ``.pt`` checkpoints (its ``on_policy_runner.py``
save format: ``{"model_state_dict": {"actor.<i>.weight", ..., "critic.<i>.*",
"std"}, "iter", ...}``) read into the port's :class:`ActorCritic`, whose
``nn.Sequential`` actor and critic carry the same layer indices.

Isaac Gym orders an asset's DOFs alphabetically by joint name, the engine
by URDF traversal; :func:`dof_permutation` maps between them, and a policy
trained in Isaac Gym speaks the engine's order through
:func:`permuted_policy` (a wrapper) or :func:`permute_params_to_our_dof_order`
(the same map baked into the weights, usable as a PPO start).  Both assume
the LeggedRobot observation layout ``[lin vel 3, ang vel 3, gravity 3,
commands 3, dof pos nj, dof vel nj, actions nj, rest]``.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.networks import ActorCritic, inference_policy
from ..utils.device import resolve_device

# the reference's ANYmal-C walking checkpoint (the JAX scripts' default), by
# its path in a checkout of the reference repository; not part of this one
REF_CKPT = "legged_gym/ckpt/anymal_c/plane_walk_200.pt"


def require_checkpoint(path: str) -> str:
    """``path``, or ``FileNotFoundError`` naming it where it is absent (the
    reference checkpoints are not part of this repository)."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"reference rsl_rl checkpoint not found: {path} (the reference repository's "
            f"legged_gym/ckpt/...; pass the path of a .pt checkpoint)")
    return path


def load_rsl_rl_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], Optional[int]]:
    """``(state dict as numpy, iteration)`` of an rsl_rl ``.pt`` checkpoint
    (read on the CPU).  A missing file raises ``FileNotFoundError`` naming it."""
    d = torch.load(require_checkpoint(path), map_location="cpu", weights_only=False)
    sd = d.get("model_state_dict", d)
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}, d.get("iter", None)


def rsl_rl_state_dict(sd: Dict[str, np.ndarray], net: ActorCritic) -> Dict[str, torch.Tensor]:
    """The rsl_rl weights ``sd`` as ``net``'s state dict: the actor and
    critic layers one to one (shapes checked), ``log_std = log(max(std,
    1e-6))``; parameters ``sd`` lacks keep ``net``'s values."""
    out = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
    for k, v in out.items():
        if k.startswith(("actor.", "critic.")):
            if k not in sd or tuple(sd[k].shape) != tuple(v.shape):
                raise ValueError(f"{k}: the checkpoint has "
                                 f"{None if k not in sd else tuple(sd[k].shape)}, the network "
                                 f"{tuple(v.shape)}")
            out[k] = torch.as_tensor(np.asarray(sd[k], np.float32).copy())
    if "std" in sd:
        out["log_std"] = torch.log(torch.clamp(torch.as_tensor(np.asarray(sd["std"], np.float32)),
                                               min=1e-6))
    return out


def dof_permutation(our_joint_names: Sequence[str],
                    ref_joint_names: Optional[Sequence[str]] = None):
    """``(perm, inv)`` between the engine's DOF order and the Isaac Gym order
    a reference checkpoint was trained in (default: alphabetical):
    ``x_ref = x_ours[perm]`` and ``a_ours = a_ref[inv]``."""
    ours = list(our_joint_names)
    ref = sorted(ours) if ref_joint_names is None else list(ref_joint_names)
    if sorted(ours) != sorted(ref):
        raise ValueError(f"joint name mismatch: {ours} vs {ref}")
    perm = np.asarray([ours.index(n) for n in ref])
    return perm, np.argsort(perm)


def permuted_policy(policy: Callable[[torch.Tensor], torch.Tensor],
                    our_joint_names: Sequence[str],
                    ref_joint_names: Optional[Sequence[str]] = None,
                    dof_obs_start: int = 12) -> Callable[[torch.Tensor], torch.Tensor]:
    """``policy`` (of the reference's DOF order) wrapped to read observations
    and emit actions in the engine's: only the three nj-wide segments from
    ``dof_obs_start`` are permuted."""
    perm, inv = dof_permutation(our_joint_names, ref_joint_names)
    if (perm == np.arange(len(perm))).all():
        return policy
    nj, s0 = len(perm), dof_obs_start
    P, I = torch.as_tensor(perm), torch.as_tensor(inv)

    def wrapped(obs: torch.Tensor) -> torch.Tensor:
        p, i = P.to(obs.device), I.to(obs.device)
        segs = [obs[:, s0 + k * nj:s0 + (k + 1) * nj][:, p] for k in range(3)]
        return policy(torch.cat([obs[:, :s0], *segs, obs[:, s0 + 3 * nj:]], -1))[:, i]

    return wrapped


def permute_params_to_our_dof_order(state: Dict[str, torch.Tensor],
                                    our_joint_names: Sequence[str],
                                    ref_joint_names: Optional[Sequence[str]] = None,
                                    dof_obs_start: int = 12) -> Dict[str, torch.Tensor]:
    """An :class:`ActorCritic` state dict of a reference-order policy
    re-expressed in the engine's DOF order: the first layers' input columns
    of the three nj-wide observation segments (actor and critic), the
    actor's output rows and ``log_std`` permuted.  Exactly
    :func:`permuted_policy` in weight space."""
    perm, inv = dof_permutation(our_joint_names, ref_joint_names)
    nj, s0 = len(perm), dof_obs_start
    out = {k: v.clone() for k, v in state.items()}
    for first in ("actor.0.weight", "critic.0.weight"):
        w = state[first]
        for seg in range(3):
            base = s0 + seg * nj
            # the reference net reads obs_ref[base + i] = obs_ours[base + perm[i]]
            out[first][:, base + perm] = w[:, base:base + nj]
    last = max(int(k.split(".")[1]) for k in state if k.startswith("actor.") and k.endswith(".weight"))
    inv_t = torch.as_tensor(inv)
    out[f"actor.{last}.weight"] = state[f"actor.{last}.weight"][inv_t]
    out[f"actor.{last}.bias"] = state[f"actor.{last}.bias"][inv_t]
    out["log_std"] = state["log_std"][inv_t]
    return out


def load_reference_policy(path: str, num_obs: int, num_actions: int,
                          hidden_dims: Sequence[int] = (128, 64, 32), activation: str = "elu",
                          our_joint_names: Optional[Sequence[str]] = None,
                          ref_joint_names: Optional[Sequence[str]] = None, device="cuda"):
    """``(network, state dict, policy)`` of an rsl_rl checkpoint: the
    :class:`ActorCritic` on ``device`` and its deterministic ``obs -> actions``;
    with ``our_joint_names`` (``env.model.joint_names``) the policy is bridged
    to the engine's DOF order (:func:`permuted_policy`), without it it keeps
    the reference's."""
    dev = resolve_device(device)
    net = ActorCritic(num_obs, num_actions, tuple(hidden_dims), tuple(hidden_dims), activation)
    sd, _ = load_rsl_rl_checkpoint(path)
    state = rsl_rl_state_dict(sd, net)
    net.load_state_dict(state)
    net = net.to(dev).eval()
    policy = inference_policy(net)
    if our_joint_names is not None:
        policy = permuted_policy(policy, our_joint_names, ref_joint_names)
    return net, state, policy
