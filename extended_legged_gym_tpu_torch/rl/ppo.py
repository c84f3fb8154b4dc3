"""PPO (port of ``rl/ppo.py``): GAE and the clipped-surrogate update with the
adaptive-KL learning rate, global-norm gradient clipping and Adam.

The JAX update is one jitted scan over epochs x minibatches; here it is a
Python loop of eager PyTorch ops that never reads a device value on the host:
the learning rate, Adam's step count, the non-finite guard and the metrics
stay device tensors until the caller reads them.  ``ppo_update`` takes the
symmetry-augmentation term (``make_mirror_fns``); ``ppo_update_recurrent``
replays each minibatch of envs through the recurrent policy over the whole
window, as the JAX function of the same name does.

Data parallelism: with a ``mesh`` (``parallel/mesh.py``: one process per
card, each holding its shard of the envs) the updates reduce what the JAX
functions reduce under ``shard_map`` with ``axis_name`` (the reference's
NCCL all-reduce), in the same order: the mean of the ranks' advantage means
and population stds before normalisation, and per minibatch the mean of the
ranks' gradients and KL means before the adaptive-KL rate and the step.  The
loss metrics stay per rank.  One difference on purpose: the non-finite skip
is ANDed over the ranks (JAX ANDs the local loss with the reduced
gradients, so a shard whose loss alone is non-finite would step apart from
the others); here the ranks' parameters never part.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..models.networks import ActorCritic, gaussian_entropy, gaussian_log_prob, mask_carry
from ..parallel.mesh import Mesh, pmean
from ..utils.tree import tree_map


@dataclasses.dataclass
class PPOConfig:
    clip_param: float = 0.2
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    value_loss_coef: float = 1.0
    entropy_coef: float = 0.01
    learning_rate: float = 1.0e-3
    schedule: str = "adaptive"
    gamma: float = 0.99
    lam: float = 0.95
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0
    use_clipped_value_loss: bool = True


@dataclasses.dataclass
class Transition:
    """Collected steps, stacked ``[T, B, ...]`` (``sigma`` is ``[T, A]``: the
    std does not depend on the state)."""

    obs: torch.Tensor
    critic_obs: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    values: torch.Tensor
    log_probs: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor


def compute_gae(rewards, dones, values, last_value, gamma: float, lam: float):
    """GAE(lambda) advantages and returns over ``[T, B]``; the timeout
    bootstrap is folded into ``rewards`` by the caller."""
    not_done = 1.0 - dones.to(torch.float32)
    values_next = torch.cat([values[1:], last_value[None]], dim=0)
    adv = torch.zeros_like(last_value)
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * values_next[t] * not_done[t] - values[t]
        adv = delta + gamma * lam * not_done[t] * adv
        out.append(adv)
    advantages = torch.stack(out[::-1])
    return advantages, advantages + values


class Adam:
    """optax's ``chain(clip_by_global_norm(max_norm), adam(lr))`` over a list
    of parameters, held as flat vectors, with a guarded step.

    * Clipping scales the gradient by ``max_norm / g`` only when the global
      norm ``g >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` would divide
      by ``g + 1e-6`` instead).
    * Adam: b1 0.9, b2 0.999, eps 1e-8 outside the square root; the bias
      correction uses the step count, which only counted steps raise.
    * ``step(grads, lr, ok)`` applies the update where the device flag ``ok``
      holds and otherwise leaves parameters and state unchanged, without the
      host reading ``ok``.
    """

    def __init__(self, params: Sequence[torch.nn.Parameter], max_grad_norm: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.max_grad_norm, self.b1, self.b2, self.eps = max_grad_norm, b1, b2, eps
        n = sum(p.numel() for p in self.params)
        dev = self.params[0].device
        self.mu = torch.zeros(n, device=dev)
        self.nu = torch.zeros(n, device=dev)
        self.count = torch.zeros((), device=dev)

    def flat_params(self) -> torch.Tensor:
        return torch.cat([p.detach().reshape(-1) for p in self.params])

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: torch.Tensor, ok: torch.Tensor):
        g = torch.nan_to_num(torch.cat([x.reshape(-1) for x in grads]))
        g_norm = torch.sqrt(torch.sum(g * g))
        g = torch.where(g_norm < self.max_grad_norm, g, g / g_norm * self.max_grad_norm)
        mu = (1.0 - self.b1) * g + self.b1 * self.mu
        nu = (1.0 - self.b2) * g * g + self.b2 * self.nu
        count = self.count + 1.0
        mu_hat = mu / (1.0 - torch.pow(self.b1, count))
        nu_hat = nu / (1.0 - torch.pow(self.b2, count))
        flat = self.flat_params()
        new = flat - lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        new = torch.where(ok, new, flat)
        self.mu = torch.where(ok, mu, self.mu)
        self.nu = torch.where(ok, nu, self.nu)
        self.count = torch.where(ok, count, self.count)
        off = 0
        for p in self.params:
            p.copy_(new[off:off + p.numel()].view_as(p))
            off += p.numel()

    def state_dict(self) -> dict:
        return dict(mu=self.mu.cpu().numpy(), nu=self.nu.cpu().numpy(),
                    count=float(self.count.item()))

    def load_state_dict(self, sd: dict):
        dev = self.mu.device
        self.mu = torch.as_tensor(sd["mu"], device=dev)
        self.nu = torch.as_tensor(sd["nu"], device=dev)
        self.count = torch.tensor(float(sd["count"]), device=dev)


class Mirror:
    """A left-right mirror ``x -> x[..., perm] * signs`` (``make_mirror_fns``),
    its index and sign tensors kept per device."""

    def __init__(self, perm, signs):
        self.perm = torch.as_tensor(perm, dtype=torch.int64)
        self.signs = torch.as_tensor(signs, dtype=torch.float32)
        self._dev = {}

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        key = str(x.device)
        if key not in self._dev:
            self._dev[key] = (self.perm.to(x.device), self.signs.to(x.device))
        perm, signs = self._dev[key]
        return x[..., perm] * signs


def make_mirror_fns(perm, signs) -> Mirror:
    """The mirroring function of an index permutation and sign flips (the
    usual left-right symmetry spec of a legged robot)."""
    return Mirror(perm, signs)


def _ppo_loss(cfg: PPOConfig, mean, std, value, mb: Dict[str, torch.Tensor]):
    """The clipped surrogate, (clipped) value loss and entropy of the policy's
    outputs on a minibatch, their total, and the KL from the collected
    Gaussian for the adaptive schedule."""
    log_prob = gaussian_log_prob(mean, std, mb["actions"])
    ratio = torch.exp(log_prob - mb["log_probs"])
    surr1 = -mb["advantages"] * ratio
    surr2 = -mb["advantages"] * torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param)
    surrogate_loss = torch.maximum(surr1, surr2).mean()
    if cfg.use_clipped_value_loss:
        v_clipped = mb["values"] + torch.clamp(value - mb["values"], -cfg.clip_param,
                                               cfg.clip_param)
        v_loss = torch.maximum(torch.square(value - mb["returns"]),
                               torch.square(v_clipped - mb["returns"])).mean()
    else:
        v_loss = torch.square(value - mb["returns"]).mean()
    entropy = gaussian_entropy(std).mean()
    total = surrogate_loss + cfg.value_loss_coef * v_loss - cfg.entropy_coef * entropy
    # KL(old || new) for the adaptive schedule
    std_b = std.detach().expand_as(mb["sigma"])
    kl = torch.sum(torch.log(std_b / (mb["sigma"] + 1e-8) + 1e-8)
                   + (torch.square(mb["sigma"]) + torch.square(mb["mu"] - mean.detach()))
                   / (2.0 * torch.square(std_b)) - 0.5, dim=-1)
    return total, v_loss.detach(), surrogate_loss.detach(), entropy.detach(), kl.mean()


def _epochs(cfg: PPOConfig, optimizer: Adam, learning_rate: torch.Tensor, n: int, dev,
            minibatch_loss: Callable, perms, generator, mesh: Optional[Mesh] = None):
    """Epochs x minibatches of guarded Adam steps: each epoch permutes ``n``
    items (``perms[e]`` where given, else ``torch.randperm`` from
    ``generator``) into ``num_mini_batches`` index sets; ``minibatch_loss``
    maps one to ``_ppo_loss``'s outputs.  With a ``mesh`` each step takes
    the ranks' mean gradient and KL, and steps only where every rank's loss
    and the mean gradient are finite (one ``all_reduce`` per step).  Returns
    the new learning rate and the mean metrics (device scalars)."""
    size = n // cfg.num_mini_batches
    lr = learning_rate
    rows: List[torch.Tensor] = []
    for e in range(cfg.num_learning_epochs):
        perm = (perms[e].to(dev) if perms is not None
                else torch.randperm(n, generator=generator, device=dev))
        idx = perm[: size * cfg.num_mini_batches].reshape(cfg.num_mini_batches, size)
        for m in range(cfg.num_mini_batches):
            loss, v_loss, surr, ent, kl = minibatch_loss(idx[m])
            grads = torch.cat([g.reshape(-1) for g in
                               torch.autograd.grad(loss, optimizer.params)])
            ok = torch.isfinite(loss.detach())
            if mesh is not None:
                # the ranks' loss checks ride in the gradients' buffer: their
                # mean is 1 exactly when every rank's loss is finite
                grads, kl, ok = pmean([grads, kl, ok.to(kl.dtype)], mesh)
                ok = ok == 1.0
            if cfg.schedule == "adaptive":
                # the minibatch's own KL moves the rate before its step
                lr = torch.where(kl > cfg.desired_kl * 2.0, torch.clamp(lr / 1.5, min=1e-5), lr)
                lr = torch.where((kl < cfg.desired_kl / 2.0) & (kl > 0.0),
                                 torch.clamp(lr * 1.5, max=1e-2), lr)
            ok = ok & torch.isfinite(grads).all()
            optimizer.step([grads], lr, ok)
            rows.append(torch.stack([loss.detach(), v_loss, surr, ent, kl,
                                     1.0 - ok.to(torch.float32)]))
    m = torch.stack(rows)
    mean = m.mean(0)
    return lr, dict(loss=mean[0], value_loss=mean[1], surrogate_loss=mean[2], entropy=mean[3],
                    kl=mean[4], nonfinite_skips=m[:, 5].sum(), learning_rate=lr)


def _normalized(advantages: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Whole-batch normalisation; jnp.std is the population std (ddof 0).
    With a ``mesh``, by the mean over the ranks of their means and stds."""
    mean, std = advantages.mean(), advantages.std(correction=0)
    if mesh is not None:
        mean, std = pmean([mean, std], mesh)
    return (advantages - mean) / (std + 1e-8)


def ppo_update(net: ActorCritic, cfg: PPOConfig, optimizer: Adam, batch: Transition,
               advantages: torch.Tensor, returns: torch.Tensor, learning_rate: torch.Tensor,
               perms: Optional[Sequence[torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None,
               symmetry: Optional[Tuple[Callable, Callable, float]] = None,
               mesh: Optional[Mesh] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Epochs x shuffled minibatches over the ``[T, B]`` batch.  Each epoch's
    permutation of the ``T * B`` samples is ``perms[e]`` where given (the
    tests inject the JAX package's), else ``torch.randperm`` from
    ``generator``.  ``symmetry`` = (mirror_obs, mirror_act, coef) adds
    ``coef`` times the mean squared difference between the actor's mean on
    mirrored observations and the mirrored mean (held constant).  ``mesh``
    makes it the data-parallel update over the ranks' batches (the JAX
    ``axis_name``; the module docstring).  Returns the new learning rate
    and the metrics (device scalars), as the JAX ``ppo_update`` does."""
    T, B = advantages.shape
    N = T * B

    def flat(x):
        return x.reshape((N,) + x.shape[2:])

    data = dict(obs=flat(batch.obs), critic_obs=flat(batch.critic_obs),
                actions=flat(batch.actions), values=flat(batch.values),
                log_probs=flat(batch.log_probs), mu=flat(batch.mu),
                sigma=flat(batch.sigma[:, None, :].expand(batch.mu.shape)),
                advantages=flat(_normalized(advantages, mesh)), returns=flat(returns))

    def minibatch_loss(idx):
        mb = {k: v[idx] for k, v in data.items()}
        mean, std, value = net(mb["obs"], mb["critic_obs"])
        out = _ppo_loss(cfg, mean, std, value, mb)
        if symmetry is None:
            return out
        mirror_obs, mirror_act, coef = symmetry
        # the JAX loss runs the critic on the mirrored observations too; its
        # value takes no part in the loss
        m_mean = net.act_inference(mirror_obs(mb["obs"]))
        sym_loss = torch.mean(torch.square(m_mean - mirror_act(mean.detach())))
        return (out[0] + coef * sym_loss, *out[1:])

    return _epochs(cfg, optimizer, learning_rate, N, advantages.device, minibatch_loss, perms,
                   generator, mesh)


def ppo_update_recurrent(net, cfg: PPOConfig, optimizer: Adam, batch: Transition, carries0,
                         advantages: torch.Tensor, returns: torch.Tensor,
                         learning_rate: torch.Tensor,
                         perms: Optional[Sequence[torch.Tensor]] = None,
                         generator: Optional[torch.Generator] = None,
                         mesh: Optional[Mesh] = None
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """PPO for a recurrent policy (``ActorCriticRecurrent``): minibatches
    split the env axis (each epoch permutes the ``B`` envs, ``perms[e]``
    where given), and each minibatch's loss replays its envs' whole
    ``T``-step window from the window-start carries ``carries0`` = (actor,
    critic), zeroing a carry after a step that ended its episode, as the
    collection did.  The learning-rate schedule, clipping, guard, metrics
    and ``mesh`` are ``ppo_update``'s."""
    T, B = advantages.shape
    data = dict(obs=batch.obs, critic_obs=batch.critic_obs, actions=batch.actions,
                values=batch.values, log_probs=batch.log_probs, mu=batch.mu,
                sigma=batch.sigma[:, None, :].expand(batch.mu.shape),
                advantages=_normalized(advantages, mesh), returns=returns,
                dones=batch.dones.to(torch.float32))

    def minibatch_loss(idx):
        mb = {k: v[:, idx] for k, v in data.items()}
        ca, cc = (tree_map(lambda h: h[idx], c) for c in carries0)
        means, values = [], []
        for t in range(T):
            mean, std, value, ca, cc = net(mb["obs"][t], ca, cc, mb["critic_obs"][t])
            d = mb["dones"][t]
            ca, cc = mask_carry(ca, d), mask_carry(cc, d)
            means.append(mean)
            values.append(value)
        return _ppo_loss(cfg, torch.stack(means), std, torch.stack(values), mb)

    return _epochs(cfg, optimizer, learning_rate, B, advantages.device, minibatch_loss, perms,
                   generator, mesh)
