"""Plain reference of PPO on a Gaussian MLP actor-critic (rsl_rl's PPO as
legged_gym trains with it): the flax-style initialisation, the policy's
actions and values, GAE(lambda) with the time-out bootstrap, and the
clipped-surrogate update with the adaptive-KL learning rate, global-norm
clipping and Adam, over shuffled minibatches.

``follow`` replays the first iterations of a training run from the
observations, rewards and episode ends its environment produced: the
environment's dynamics are checked apart, one control step at a time."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

TRUNC_STD = 0.87962566103423978      # std of a standard normal truncated to (-2, 2)


@dataclass
class PPOParams:
    hidden: Sequence[int]
    init_noise_std: float
    clip: float
    epochs: int
    minibatches: int
    value_coef: float
    entropy_coef: float
    learning_rate: float
    gamma: float
    lam: float
    desired_kl: float
    max_grad_norm: float
    steps_per_env: int

    @classmethod
    def from_config(cls, c: dict) -> "PPOParams":
        pol, alg, run = c["policy"], c["algorithm"], c["runner"]
        if pol["actor_hidden_dims"] != pol["critic_hidden_dims"] or pol["activation"] != "elu":
            raise ValueError("the reference takes equal actor and critic widths and ELU")
        if alg["schedule"] != "adaptive" or not alg["use_clipped_value_loss"]:
            raise ValueError("the reference takes the adaptive schedule and the clipped value loss")
        return cls(hidden=list(pol["actor_hidden_dims"]), init_noise_std=pol["init_noise_std"],
                   clip=alg["clip_param"], epochs=alg["num_learning_epochs"],
                   minibatches=alg["num_mini_batches"], value_coef=alg["value_loss_coef"],
                   entropy_coef=alg["entropy_coef"], learning_rate=alg["learning_rate"],
                   gamma=alg["gamma"], lam=alg["lam"], desired_kl=alg["desired_kl"],
                   max_grad_norm=alg["max_grad_norm"], steps_per_env=run["num_steps_per_env"])


def init_params(num_obs: int, num_actions: int, hidden: Sequence[int], init_noise_std: float,
                seed: int) -> Dict[str, torch.Tensor]:
    """Actor then critic layers, each weight from a normal truncated at two
    standard deviations with variance 1 / fan_in (drawn on the CPU from one
    generator seeded with ``seed``, in layer order), biases zero; the log
    std at ``log(init_noise_std)``.  Names follow ``actor.<i>`` /
    ``critic.<i>`` of a Sequential of Linear and ELU modules, the log std
    first (the order of the flat vector Adam steps)."""
    gen = torch.Generator().manual_seed(seed)
    params: Dict[str, torch.Tensor] = {"log_std": torch.full((num_actions,),
                                                             math.log(init_noise_std))}
    for net, out in (("actor", num_actions), ("critic", 1)):
        dims = [num_obs] + list(hidden) + [out]
        for k in range(len(dims) - 1):
            w = torch.empty(dims[k + 1], dims[k])
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
            params[f"{net}.{2 * k}.weight"] = w * (math.sqrt(1.0 / dims[k]) / TRUNC_STD)
            params[f"{net}.{2 * k}.bias"] = torch.zeros(dims[k + 1])
    return params


def mlp(params, net: str, x):
    k = 0
    while f"{net}.{2 * (k + 1)}.weight" in params:
        x = F.elu(F.linear(x, params[f"{net}.{2 * k}.weight"], params[f"{net}.{2 * k}.bias"]))
        k += 1
    return F.linear(x, params[f"{net}.{2 * k}.weight"], params[f"{net}.{2 * k}.bias"])


def log_prob(mean, std, actions):
    var = std ** 2
    return torch.sum(-0.5 * torch.square(actions - mean) / var - torch.log(std)
                     - 0.5 * math.log(2 * math.pi), dim=-1)


def gae(rewards, dones, values, last_value, gamma: float, lam: float):
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


def _loss(p: PPOParams, params, mb, half: bool):
    if half:                         # a planted fault: the second half left out
        n = mb["obs"].shape[0] // 2
        mb = {k: v[:n] for k, v in mb.items()}
    mean = mlp(params, "actor", mb["obs"])
    value = mlp(params, "critic", mb["obs"])[..., 0]
    std = params["log_std"].exp()
    ratio = torch.exp(log_prob(mean, std, mb["actions"]) - mb["log_probs"])
    surr = torch.maximum(-mb["advantages"] * ratio,
                         -mb["advantages"] * torch.clamp(ratio, 1 - p.clip, 1 + p.clip)).mean()
    v_clipped = mb["values"] + torch.clamp(value - mb["values"], -p.clip, p.clip)
    v_loss = torch.maximum(torch.square(value - mb["returns"]),
                           torch.square(v_clipped - mb["returns"])).mean()
    entropy = torch.sum(0.5 + 0.5 * math.log(2 * math.pi) + torch.log(std), dim=-1).mean()
    total = surr + p.value_coef * v_loss - p.entropy_coef * entropy
    std_b = std.detach().expand_as(mb["sigma"])
    kl = torch.sum(torch.log(std_b / (mb["sigma"] + 1e-8) + 1e-8)
                   + (torch.square(mb["sigma"]) + torch.square(mb["mu"] - mean.detach()))
                   / (2.0 * torch.square(std_b)) - 0.5, dim=-1)
    return total, kl.mean()


def follow(p: PPOParams, ranks: List[List[dict]], num_obs: int, num_actions: int, seed: int,
           device, fault: Optional[str] = None) -> dict:
    """Replay the first iterations of a training run from the seed, on
    ``len(ranks)`` data-parallel ranks (one: a single card).  ``ranks[r][k]``
    holds rank ``r``'s environment of iteration ``k``: ``obs`` [T, B, O]
    (before each step), ``last_obs`` [B, O] (after the last), ``rew``,
    ``time_out`` and ``dones`` [T, B].  Rank ``r``'s action noise and
    minibatch permutations come from a generator on ``device`` seeded with
    ``seed + r``, drawn in the runner's order.  The ranks share the update:
    the mean of their advantage means and stds normalises the advantages,
    and each minibatch step takes the mean of the ranks' gradients and KLs
    and steps where every rank's loss is finite.  Returns ``[k][r]`` the
    actions, values and advantages, per iteration rank 0's mean loss, rank
    0's first minibatch loss, the first step's gradient (by parameter), the
    parameters after that step and the parameters before and after.  ``fault`` plants "unchanged" (no step applied) or "half" (each
    minibatch loss over its first half)."""
    W = len(ranks)
    params = {k: v.to(device) for k, v in init_params(num_obs, num_actions, p.hidden,
                                                      p.init_noise_std, seed).items()}
    names = list(params)
    start = {k: v.clone() for k, v in params.items()}
    gens = [torch.Generator(device=device).manual_seed(seed + r) for r in range(W)]
    n_par = sum(v.numel() for v in params.values())
    mu = torch.zeros(n_par, device=device)
    nu = torch.zeros(n_par, device=device)
    count = torch.zeros((), device=device)
    lr = torch.tensor(p.learning_rate, device=device)
    out = dict(actions=[], values=[], advantages=[], loss=[], first_grad=None,
               after_first=None)
    for k_it in range(len(ranks[0])):
        datas, advs = [], []
        out["actions"].append([])
        out["values"].append([])
        out["advantages"].append([])
        for r in range(W):
            rec = ranks[r][k_it]
            obs = rec["obs"].to(device)
            T, B = obs.shape[:2]
            acts, vals, logps, mus = [], [], [], []
            with torch.no_grad():
                std = params["log_std"].exp()
                for t in range(T):
                    mean = mlp(params, "actor", obs[t])
                    value = mlp(params, "critic", obs[t])[..., 0]
                    eps = torch.randn(mean.shape, generator=gens[r], device=device)
                    a = mean + std * eps
                    acts.append(a)
                    vals.append(value)
                    logps.append(log_prob(mean, std, a))
                    mus.append(mean)
                values = torch.stack(vals)
                rewards = rec["rew"].to(device) + p.gamma * values * rec["time_out"].to(device)
                last_value = mlp(params, "critic", rec["last_obs"].to(device))[..., 0]
                adv, ret = gae(rewards, rec["dones"].to(device), values, last_value, p.gamma,
                               p.lam)
            out["actions"][-1].append(torch.stack(acts))
            out["values"][-1].append(values)
            out["advantages"][-1].append(adv)
            N = T * B
            advs.append(adv)
            datas.append(dict(obs=obs.reshape(N, -1), actions=torch.stack(acts).reshape(N, -1),
                              values=values.reshape(N), log_probs=torch.stack(logps).reshape(N),
                              mu=torch.stack(mus).reshape(N, -1),
                              sigma=std[None, None, :].expand(T, B, -1).reshape(N, -1),
                              returns=ret.reshape(N)))
        with torch.no_grad():
            if W == 1:
                a_mean, a_std = advs[0].mean(), advs[0].std(correction=0)
            else:
                a_mean = torch.stack([a.mean() for a in advs]).sum() / W
                a_std = torch.stack([a.std(correction=0) for a in advs]).sum() / W
            for d, a in zip(datas, advs):
                d["advantages"] = ((a - a_mean) / (a_std + 1e-8)).reshape(-1)
        N = datas[0]["values"].shape[0]
        size = N // p.minibatches
        losses = []
        for _ in range(p.epochs):
            idxs = [torch.randperm(N, generator=gens[r], device=device)[: size * p.minibatches]
                    .reshape(p.minibatches, size) for r in range(W)]
            for m in range(p.minibatches):
                gs, kls, oks = [], [], []
                for r in range(W):
                    mb = {k: v[idxs[r][m]] for k, v in datas[r].items()}
                    leaves = [params[k].requires_grad_(True) for k in names]
                    loss, kl = _loss(p, params, mb, fault == "half")
                    grads = torch.autograd.grad(loss, leaves)
                    for k in names:
                        params[k] = params[k].detach()
                    gs.append(torch.cat([x.reshape(-1) for x in grads]))
                    kls.append(kl.detach())
                    oks.append(torch.isfinite(loss.detach()))
                    if r == 0:
                        losses.append(loss.detach())
                with torch.no_grad():
                    if W == 1:
                        g, kl, ok = gs[0], kls[0], oks[0]
                    else:
                        g = torch.stack(gs).sum(0) / W
                        kl = torch.stack(kls).sum() / W
                        ok = torch.stack(oks).to(kl.dtype).sum() / W == 1.0
                    if out["first_grad"] is None:
                        out["first_grad"] = dict(zip(names, (
                            g[o:o + params[k].numel()].view_as(params[k]).clone()
                            for k, o in zip(names, _offsets(params, names)))))
                    lr = torch.where(kl > p.desired_kl * 2.0, torch.clamp(lr / 1.5, min=1e-5), lr)
                    lr = torch.where((kl < p.desired_kl / 2.0) & (kl > 0.0),
                                     torch.clamp(lr * 1.5, max=1e-2), lr)
                    ok = ok & torch.isfinite(g).all()
                    g = torch.nan_to_num(g)
                    g_norm = torch.sqrt(torch.sum(g * g))
                    g = torch.where(g_norm < p.max_grad_norm, g, g / g_norm * p.max_grad_norm)
                    mu_n = (1.0 - 0.9) * g + 0.9 * mu
                    nu_n = (1.0 - 0.999) * g * g + 0.999 * nu
                    count_n = count + 1.0
                    mu_hat = mu_n / (1.0 - torch.pow(0.9, count_n))
                    nu_hat = nu_n / (1.0 - torch.pow(0.999, count_n))
                    flat = torch.cat([params[k].reshape(-1) for k in names])
                    new = flat - lr * (mu_hat / (torch.sqrt(nu_hat) + 1e-8))
                    if fault == "unchanged":
                        ok = torch.zeros_like(ok)
                    new = torch.where(ok, new, flat)
                    mu, nu = torch.where(ok, mu_n, mu), torch.where(ok, nu_n, nu)
                    count = torch.where(ok, count_n, count)
                    off = 0
                    for k in names:
                        n = params[k].numel()
                        params[k] = new[off:off + n].view_as(params[k]).clone()
                        off += n
                    if out["after_first"] is None:
                        out["after_first"] = {k: v.clone() for k, v in params.items()}
        out["loss"].append(torch.stack(losses).mean())
        out.setdefault("first_loss", losses[0])
    out["start"], out["end"], out["names"] = start, params, names
    return out


def _offsets(params, names):
    off = 0
    for k in names:
        yield off
        off += params[k].numel()
