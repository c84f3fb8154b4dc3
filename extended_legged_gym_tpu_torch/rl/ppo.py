"""PPO (port of ``rl/ppo.py``): GAE and the clipped-surrogate update with the
adaptive-KL learning rate, global-norm gradient clipping and Adam.

The JAX update is one jitted scan over epochs x minibatches; here it is a
Python loop of eager PyTorch ops that never reads a device value on the host:
the learning rate, Adam's step count, the non-finite guard and the metrics
stay device tensors until the caller reads them.  Left out: the recurrent
update and the symmetry loss (the runner raises on either).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..models.networks import ActorCritic, gaussian_entropy, gaussian_log_prob


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


def _loss(net: ActorCritic, cfg: PPOConfig, mb: Dict[str, torch.Tensor]):
    mean, std, value = net(mb["obs"], mb["critic_obs"])
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


def ppo_update(net: ActorCritic, cfg: PPOConfig, optimizer: Adam, batch: Transition,
               advantages: torch.Tensor, returns: torch.Tensor, learning_rate: torch.Tensor,
               perms: Optional[Sequence[torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Epochs x shuffled minibatches over the ``[T, B]`` batch.  Each epoch's
    permutation of the ``T * B`` samples is ``perms[e]`` where given (the
    tests inject the JAX package's), else ``torch.randperm`` from
    ``generator``.  Returns the new learning rate and the metrics (device
    scalars), as the JAX ``ppo_update`` does."""
    T, B = advantages.shape
    N = T * B
    mb_size = N // cfg.num_mini_batches
    # whole-batch normalisation; jnp.std is the population std (ddof 0)
    advantages = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)

    def flat(x):
        return x.reshape((N,) + x.shape[2:])

    data = dict(obs=flat(batch.obs), critic_obs=flat(batch.critic_obs),
                actions=flat(batch.actions), values=flat(batch.values),
                log_probs=flat(batch.log_probs), mu=flat(batch.mu),
                sigma=flat(batch.sigma[:, None, :].expand(batch.mu.shape)),
                advantages=flat(advantages), returns=flat(returns))
    dev = advantages.device
    lr = learning_rate
    rows: List[torch.Tensor] = []
    for e in range(cfg.num_learning_epochs):
        perm = (perms[e].to(dev) if perms is not None
                else torch.randperm(N, generator=generator, device=dev))
        idx = perm[: mb_size * cfg.num_mini_batches].reshape(cfg.num_mini_batches, mb_size)
        for m in range(cfg.num_mini_batches):
            mb = {k: v[idx[m]] for k, v in data.items()}
            loss, v_loss, surr, ent, kl = _loss(net, cfg, mb)
            grads = torch.autograd.grad(loss, optimizer.params)
            if cfg.schedule == "adaptive":
                # the minibatch's own KL moves the rate before its step
                lr = torch.where(kl > cfg.desired_kl * 2.0, torch.clamp(lr / 1.5, min=1e-5), lr)
                lr = torch.where((kl < cfg.desired_kl / 2.0) & (kl > 0.0),
                                 torch.clamp(lr * 1.5, max=1e-2), lr)
            ok = torch.isfinite(loss.detach())
            for g in grads:
                ok = ok & torch.isfinite(g).all()
            optimizer.step(grads, lr, ok)
            rows.append(torch.stack([loss.detach(), v_loss, surr, ent, kl,
                                     1.0 - ok.to(torch.float32)]))
    m = torch.stack(rows)
    mean = m.mean(0)
    return lr, dict(loss=mean[0], value_loss=mean[1], surrogate_loss=mean[2], entropy=mean[3],
                    kl=mean[4], nonfinite_skips=m[:, 5].sum(), learning_rate=lr)
