"""On-policy training runner (port of ``rl/runner.py``): the MLP policy
(``ActorCritic``) or the recurrent one (``ActorCriticRecurrent``), with RND
intrinsic rewards (``algorithm.rnd_cfg``) and symmetry augmentation
(``algorithm.symmetry_cfg``).

One iteration collects ``num_steps_per_env`` steps of every env into device
tensors ``[T, B, ...]`` (the physics step is the fused kernel on the card),
computes GAE with the timeout bootstrap, runs the PPO update, reads the
episodes that ended into the JAX runner's metric keys and advances the
staged rewards.  Nothing inside the collection or minibatch loops reads a
device value on the host; ``learn`` reads the metrics once per iteration.

* Recurrent policies: the carries advance each step and are zeroed where an
  env reset; the window-start carries are kept for the update's replay
  (``ppo_update_recurrent``) and the bootstrap value comes from the carries
  at the window's end.
* RND: the intrinsic reward of each step's new observation is added to its
  reward; after the PPO update the predictor takes one Adam step
  (``rnd_cfg["learning_rate"]``, no clipping) over the window's policy
  observations, with the normalizers as collection left them.
* Privileged observations: where the env has them (``num_privileged_obs``)
  the critic reads ``EnvState.privileged_obs``, unnormalized, and is sized
  by it; the actor reads the (normalized) observation.
* Symmetry: ``symmetry_cfg`` = {obs_perm, obs_signs, act_perm, act_signs,
  coef (0.5)} adds the mirror loss to ``ppo_update``.  The JAX runner passes
  it to the MLP update only and drops it silently for a recurrent policy;
  the port refuses that combination.

Checkpoints are pickles in the JAX runner's layout (flax parameter tree,
``opt_state=None``, ``learning_rate``, ``obs_norm``, ``iteration``), so the
JAX ``OnPolicyRunner.load`` reads them; the port's Adam state rides under
``torch_opt_state``, the reward stage under ``reward_stage`` and the RND
module (target and predictor trees, normalizers, step, Adam state) under
``rnd``, which the JAX runner ignores.  ``load`` reads the port's
checkpoints and the JAX package's (parameters and learning rate; a JAX
checkpoint's optax state is not carried over, so Adam restarts).

``warmstart_from_reference`` starts the MLP policy from a reference rsl_rl
``.pt`` (bridged to the engine's DOF order in weight space, Adam restarted);
``export_policy`` writes the deployment files (``utils/export.py``).

Data parallelism (``mesh``, ``parallel/mesh.py``; the JAX runner shards the
env axis over its mesh, the reference runs one torchrun process per GPU):
each process holds its shard of the envs and collects them alone.  At
construction and after ``load`` / ``warmstart_from_reference`` every rank
takes rank 0's parameters, Adam state, learning rate, normalizer(s), reward
stage and RND networks (rsl_rl's ``broadcast_parameters``).  An iteration
updates the normalizers with every rank's rows, runs the data-parallel PPO
update (``ppo_update(..., mesh=)``), takes the ranks' mean RND predictor
gradient, and sums the episode metrics and averages ``mean_step_reward``
and ``terrain_level`` over the ranks before the means, so the staged
reward advances alike everywhere; the ranks stay bit for bit equal.  The
action noise and minibatch permutations draw from a generator seeded with
``seed + rank``.  Only rank 0 logs, writes metrics and saves.  The
distillation and terrain-estimator runners stay single-process: the JAX
package shards neither.
"""
from __future__ import annotations

import io
import os
import time
from typing import Dict, List, Optional, Sequence

import torch

from ..envs.legged_robot import EnvState, LeggedRobot
from ..envs.legged_robot_config import UNREAD_TRAIN_FIELDS, LeggedRobotCfgPPO, refuse_unread
from ..models.networks import (ActorCritic, ActorCriticRecurrent, RecurrentInferencePolicy,
                               RunningNorm, dump_checkpoint, flax_tree, gaussian_log_prob,
                               inference_policy, load_flax_tree, mask_carry,
                               norm_from_checkpoint, params_from_jax, params_to_jax,
                               read_checkpoint)
from ..models.rnd import RandomNetworkDistillation
from ..parallel.mesh import Mesh, all_sum, broadcast_object, pmean, replicate
from ..utils.metrics import MetricsWriter
from .ppo import (Adam, PPOConfig, Transition, compute_gae, make_mirror_fns, ppo_update,
                  ppo_update_recurrent)


class OnPolicyRunner:
    def __init__(self, env: LeggedRobot, train_cfg: LeggedRobotCfgPPO,
                 log_dir: Optional[str] = None, seed: Optional[int] = None,
                 mesh: Optional[Mesh] = None):
        alg, pol, run = train_cfg.algorithm, train_cfg.policy, train_cfg.runner
        refuse_unread(train_cfg, UNREAD_TRAIN_FIELDS)
        if run.policy_class_name not in ("ActorCritic", "ActorCriticRecurrent"):
            raise NotImplementedError(f"not ported yet: policy {run.policy_class_name}")
        self.recurrent = run.policy_class_name == "ActorCriticRecurrent"
        if self.recurrent and alg.symmetry_cfg:
            raise ValueError("symmetry_cfg with ActorCriticRecurrent: the recurrent update takes "
                             "no symmetry term (the JAX runner drops it silently)")
        if self.recurrent and pol.rnn_num_layers != 1:
            raise ValueError(f"rnn_num_layers {pol.rnn_num_layers}: the recurrent policy's "
                             "Memory has one layer")
        self.mesh = mesh
        self.is_main = mesh is None or mesh.rank == 0
        self.env, self.cfg = env, train_cfg
        self.log_dir = log_dir if self.is_main else None
        self.device = env.device
        self.writer = MetricsWriter(log_dir) if self.log_dir else None
        seed = train_cfg.seed if seed is None else seed
        self.ppo_cfg = PPOConfig(
            clip_param=alg.clip_param, num_learning_epochs=alg.num_learning_epochs,
            num_mini_batches=alg.num_mini_batches, value_loss_coef=alg.value_loss_coef,
            entropy_coef=alg.entropy_coef, learning_rate=alg.learning_rate,
            schedule=alg.schedule, gamma=alg.gamma, lam=alg.lam, desired_kl=alg.desired_kl,
            max_grad_norm=alg.max_grad_norm, use_clipped_value_loss=alg.use_clipped_value_loss)
        self.num_steps_per_env = run.num_steps_per_env

        # the initialisation draws on the CPU, so a seed gives the same network
        # on every device; action noise and minibatch permutations come from
        # a generator on the env's device
        init_gen = torch.Generator().manual_seed(seed)
        critic_dim = env.num_privileged_obs or env.num_obs
        if self.recurrent:
            self.network = ActorCriticRecurrent(
                env.num_obs, env.num_actions, pol.actor_hidden_dims, pol.critic_hidden_dims,
                pol.activation, pol.init_noise_std, pol.rnn_hidden_size, pol.rnn_type,
                num_critic_obs=critic_dim, generator=init_gen).to(self.device)
            self.carries = self.initial_carries()
        else:
            self.network = ActorCritic(
                env.num_obs, env.num_actions, pol.actor_hidden_dims, pol.critic_hidden_dims,
                pol.activation, pol.init_noise_std, num_critic_obs=critic_dim,
                generator=init_gen).to(self.device)
            self.carries = None
        self.optimizer = Adam(self.network.parameters(), alg.max_grad_norm)
        self.symmetry = None
        if alg.symmetry_cfg:
            sc = alg.symmetry_cfg
            self.symmetry = (make_mirror_fns(sc["obs_perm"], sc["obs_signs"]),
                             make_mirror_fns(sc["act_perm"], sc["act_signs"]), sc.get("coef", 0.5))
        self.rnd = None
        if alg.rnd_cfg:
            rc = alg.rnd_cfg
            self.rnd = RandomNetworkDistillation(
                env.num_obs, rc.get("num_outputs", 64), rc.get("hidden_dims", (256, 256)),
                rc.get("weight", 1.0), rc.get("weight_schedule"), generator=init_gen,
                device=self.device)
            # optax.adam: no gradient clipping
            self.rnd_optimizer = Adam(self.rnd.predictor.parameters(), float("inf"))
            self.rnd_learning_rate = torch.tensor(rc.get("learning_rate", 1e-3),
                                                  device=self.device)
        self.learning_rate = torch.tensor(alg.learning_rate, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + (mesh.rank if mesh is not None else 0))
        self.obs_norm = (RunningNorm.create(env.num_obs, device=self.device)
                         if run.empirical_normalization else None)
        self.env_state: EnvState = env.reset_all()
        self.iteration = 0
        self._replicate()

    def _replicate(self):
        """Every rank takes rank 0's parameters, Adam state, learning rate,
        normalizer(s), reward stage and RND state (no-op without a mesh)."""
        if self.mesh is None:
            return
        opt = self.optimizer
        tree = dict(params=[p.detach() for p in self.network.parameters()],
                    adam=[opt.mu, opt.nu, opt.count], lr=self.learning_rate,
                    norm=self.obs_norm, stage=self.env_state.reward_stage)
        if self.rnd is not None:
            r, ro = self.rnd, self.rnd_optimizer
            tree["rnd"] = dict(params=[p.detach() for p in r.parameters()],
                               adam=[ro.mu, ro.nu, ro.count],
                               norms=[r.state_norm, r.reward_norm], step=r.step)
        got = replicate(tree, self.mesh)
        with torch.no_grad():
            for p, v in zip(self.network.parameters(), got["params"]):
                p.copy_(v)
        opt.mu, opt.nu, opt.count = got["adam"]
        self.learning_rate, self.obs_norm = got["lr"], got["norm"]
        self.env_state = self.env_state.replace(reward_stage=got["stage"])
        if self.rnd is not None:
            rg = got["rnd"]
            with torch.no_grad():
                for p, v in zip(self.rnd.parameters(), rg["params"]):
                    p.copy_(v)
            self.rnd_optimizer.mu, self.rnd_optimizer.nu, self.rnd_optimizer.count = rg["adam"]
            (self.rnd.state_norm, self.rnd.reward_norm), self.rnd.step = rg["norms"], rg["step"]

    # ------------------------------------------------------------------
    def _policy_io(self, es: EnvState, obs_norm: Optional[RunningNorm]):
        obs = obs_norm.normalize(es.obs) if obs_norm is not None else es.obs
        return obs, es.privileged_obs if es.privileged_obs is not None else obs

    def _forward(self, obs, critic_obs, carries):
        """``(mean, std, value, carries)`` of the policy (carries pass
        through an MLP policy)."""
        if not self.recurrent:
            return (*self.network(obs, critic_obs), carries)
        mean, std, value, ca, cc = self.network(obs, *carries, critic_obs)
        return mean, std, value, (ca, cc)

    @torch.no_grad()
    def _collect(self, es: EnvState, carries, action_noise: Optional[torch.Tensor]):
        """``num_steps_per_env`` steps of every env: ``(env_state, carries,
        batch)``.  The action noise is ``action_noise[t]`` where given (tests
        inject the JAX runner's), else standard normal from the runner's
        generator."""
        env, gamma = self.env, self.ppo_cfg.gamma
        rows: Dict[str, List[torch.Tensor]] = {k: [] for k in (
            "obs", "critic_obs", "actions", "rewards", "dones", "values", "log_probs", "mu",
            "sigma")}
        for t in range(self.num_steps_per_env):
            obs, critic_obs = self._policy_io(es, self.obs_norm)
            mean, std, value, carries = self._forward(obs, critic_obs, carries)
            eps = (action_noise[t] if action_noise is not None else
                   torch.randn(mean.shape, generator=self.generator, device=self.device))
            actions = mean + std * eps
            log_prob = gaussian_log_prob(mean, std, actions)
            es = env.step(es, actions)
            if self.recurrent:
                carries = tuple(mask_carry(c, es.reset_buf) for c in carries)
            # timeout bootstrap with the value of the observation before the
            # step; dones is reset_buf, which includes the time-outs
            rewards = es.rew + gamma * value * es.time_out_buf
            if self.rnd is not None:
                rewards = rewards + self.rnd.intrinsic_reward(es.obs, self.mesh)
            for k, v in (("obs", obs), ("critic_obs", critic_obs), ("actions", actions),
                         ("rewards", rewards), ("dones", es.reset_buf), ("values", value),
                         ("log_probs", log_prob), ("mu", mean), ("sigma", std)):
                rows[k].append(v)
        return es, carries, Transition(**{k: torch.stack(v) for k, v in rows.items()})

    def train_iteration(self, action_noise: Optional[torch.Tensor] = None,
                        perms: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """One collection and PPO update (the JAX ``_train_iteration``).
        Returns the metrics as device scalars; ``action_noise`` [T, B, A] and
        ``perms`` (one permutation of ``T * B`` per epoch) replace the
        runner's own draws."""
        env, cfg = self.env, self.ppo_cfg
        # the iteration's logging window starts empty
        es = self.env_state.replace(episode_metrics=env.zero_episode_metrics())
        t0 = time.perf_counter()
        carries0 = self.carries            # window start, for the recurrent replay
        es, carries, batch = self._collect(es, carries0, action_noise)
        obs_norm = self.obs_norm
        if obs_norm is not None:
            # as in the JAX runner: updated with the (already normalized)
            # observations the policy saw
            obs_norm = obs_norm.update(batch.obs, self.mesh)
        with torch.no_grad():
            obs, critic_obs = self._policy_io(es, self.obs_norm)
            last_value = self._forward(obs, critic_obs, carries)[2]
        advantages, returns = compute_gae(batch.rewards, batch.dones, batch.values, last_value,
                                          cfg.gamma, cfg.lam)
        action_std = self.network.log_std.detach().exp().mean()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        if self.recurrent:
            self.learning_rate, metrics = ppo_update_recurrent(
                self.network, cfg, self.optimizer, batch, carries0, advantages, returns,
                self.learning_rate, perms=perms, generator=self.generator, mesh=self.mesh)
        else:
            self.learning_rate, metrics = ppo_update(
                self.network, cfg, self.optimizer, batch, advantages, returns,
                self.learning_rate, perms=perms, generator=self.generator,
                symmetry=self.symmetry, mesh=self.mesh)
        if self.rnd is not None:
            loss = self.rnd.predictor_loss(batch.obs.reshape(-1, batch.obs.shape[-1]))
            grads = torch.autograd.grad(loss, self.rnd_optimizer.params)
            if self.mesh is not None:
                grads = pmean(grads, self.mesh)
            self.rnd_optimizer.step(grads, self.rnd_learning_rate,
                                    torch.ones((), dtype=torch.bool, device=self.device))
            metrics["rnd_loss"] = loss.detach()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_times = dict(collection_s=t1 - t0, update_s=time.perf_counter() - t1)

        em = es.episode_metrics
        means = dict(mean_step_reward=batch.rewards.mean())
        if env.custom_origins:
            means["terrain_level"] = es.terrain_levels.to(torch.float32).mean()
        if self.mesh is not None:
            # the episodes of every rank, and the means over the ranks' shards
            em = dict(zip(em, all_sum(list(em.values()), self.mesh)))
            means = dict(zip(means, pmean(list(means.values()), self.mesh)))
        n_ep = torch.clamp(em["count"], min=1.0)
        metrics["mean_reward"] = em["return_sum"] / n_ep
        metrics["mean_episode_length"] = em["length_sum"] / n_ep
        metrics["episodes_done"] = em["count"]
        metrics["mean_step_reward"] = means.pop("mean_step_reward")
        metrics["action_std"] = action_std
        metrics.update(means)
        for k, v in em.items():
            if k.startswith("rew_"):
                metrics["episode/" + k] = v / n_ep
        # staged rewards: the stage advances when the episodes that ended in
        # this iteration averaged more than the threshold
        if env.reward_scale_table.shape[0] > 1:
            rc = env.cfg.rewards
            advance = (metrics["mean_reward"] > rc.reward_stage_threshold) & (
                es.reward_stage < rc.reward_max_stage)
            es = es.replace(reward_stage=torch.where(advance, es.reward_stage + 1,
                                                     es.reward_stage))
            metrics["reward_stage"] = es.reward_stage.to(torch.float32)
        self.env_state, self.obs_norm, self.carries = es, obs_norm, carries
        self.iteration += 1
        return metrics

    # ------------------------------------------------------------------
    def learn(self, num_iterations: int, log_interval: int = 10,
              save_interval: Optional[int] = None) -> Dict[str, float]:
        save_interval = save_interval or self.cfg.runner.save_interval
        # env steps of every rank
        steps_per_iter = (self.num_steps_per_env * self.env.num_envs
                          * (self.mesh.size if self.mesh is not None else 1))
        last: Dict[str, float] = {}
        t_start = time.time()
        for it in range(num_iterations):
            t0 = time.perf_counter()
            metrics = self.train_iteration()
            names = list(metrics)
            values = torch.stack([metrics[k].to(torch.float32) for k in names]).tolist()
            dt = time.perf_counter() - t0
            last = dict(zip(names, values))
            last.update(self.last_times, fps=steps_per_iter / dt)
            if self.writer:
                self.writer.write(self.iteration, last)
            if self.is_main and (it % log_interval == 0 or it == num_iterations - 1):
                print(f"it {self.iteration:5d} | rew/ep {last['mean_reward']:8.3f} | "
                      f"len {last['mean_episode_length']:6.1f} | kl {last['kl']:.4f} | "
                      f"lr {last['learning_rate']:.1e} | fps {last['fps']:,.0f}", flush=True)
            if self.log_dir and save_interval and (it + 1) % save_interval == 0:
                self.save(os.path.join(self.log_dir, f"model_{self.iteration}.pkl"))
        last["total_time"] = time.time() - t_start
        if self.log_dir:
            self.save(os.path.join(self.log_dir, "model_final.pkl"))
        if self.writer:
            self.writer.close()
        return last

    # ------------------------------------------------------------------
    def save(self, path: str):
        """A checkpoint the JAX runner reads (see the module docstring)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = dict(params=params_to_jax(self.network), opt_state=None,
                       learning_rate=float(self.learning_rate.item()),
                       obs_norm=self.obs_norm, iteration=self.iteration,
                       torch_opt_state=self.optimizer.state_dict(),
                       reward_stage=int(self.env_state.reward_stage.item()))
        if self.rnd is not None:
            r = self.rnd
            payload["rnd"] = dict(target=flax_tree(r.target), predictor=flax_tree(r.predictor),
                                  state_norm=r.state_norm, reward_norm=r.reward_norm,
                                  step=int(r.step.item()),
                                  torch_opt_state=self.rnd_optimizer.state_dict())
        with open(path, "wb") as f:
            dump_checkpoint(payload, f)

    def load(self, path: Optional[str], load_optimizer: bool = True) -> dict:
        """Read a checkpoint of either runner (the module docstring).  With a
        mesh every rank calls it: rank 0 reads ``path`` (the others' is not
        read) and broadcasts the file's bytes, every rank applies them, and
        rank 0's state is replicated."""
        if self.mesh is None:
            payload = read_checkpoint(path)
        else:
            data = None
            if self.is_main:
                with open(path, "rb") as f:
                    data = f.read()
            payload = read_checkpoint(io.BytesIO(broadcast_object(data, self.mesh)))
        with torch.no_grad():
            for name, t in params_from_jax(payload["params"]).items():
                self.network.get_parameter(name).copy_(t)
        if load_optimizer and (payload.get("opt_state") is not None
                               or payload.get("torch_opt_state") is not None):
            self.learning_rate = torch.tensor(float(payload["learning_rate"]), device=self.device)
            if payload.get("torch_opt_state") is not None:
                self.optimizer.load_state_dict(payload["torch_opt_state"])
        if payload.get("obs_norm") is not None:
            self.obs_norm = norm_from_checkpoint(payload["obs_norm"]).to(self.device)
        if self.rnd is not None and payload.get("rnd") is not None:
            r, saved = self.rnd, payload["rnd"]
            load_flax_tree(r.target, saved["target"])
            load_flax_tree(r.predictor, saved["predictor"])
            norm = lambda n: norm_from_checkpoint(n).to(self.device) if n is not None else None
            r.state_norm, r.reward_norm = norm(saved["state_norm"]), norm(saved["reward_norm"])
            r.step = torch.tensor(int(saved["step"]), device=self.device)
            if load_optimizer:
                self.rnd_optimizer.load_state_dict(saved["torch_opt_state"])
        if payload.get("reward_stage") is not None:
            self.env_state = self.env_state.replace(
                reward_stage=torch.tensor(int(payload["reward_stage"]), device=self.device))
        self.iteration = int(payload.get("iteration", 0))
        self._replicate()
        return payload

    def get_inference_policy(self, batch_size: Optional[int] = None):
        """The deterministic policy ``obs -> actions`` (the actor's mean on
        normalized observations).  For a recurrent policy it is a
        :class:`RecurrentInferencePolicy` of ``batch_size`` (default: the
        env's) envs, which carries its own state; call its ``reset(dones)``
        after each env step."""
        if self.recurrent:
            return RecurrentInferencePolicy(self.network, self.obs_norm,
                                            batch_size or self.env.num_envs)
        return inference_policy(self.network, self.obs_norm)

    def initial_carries(self, batch_size: Optional[int] = None):
        """Zero (actor, critic) carries of a recurrent policy."""
        if not self.recurrent:
            raise ValueError("carries exist for recurrent policies only")
        return self.network.initialize_carries((batch_size or self.env.num_envs,), self.device)

    def warmstart_from_reference(self, pt_path: str):
        """Start the policy from a reference rsl_rl ``.pt`` checkpoint,
        re-expressed in the engine's DOF order in weight space
        (``rl/torch_compat.permute_params_to_our_dof_order``), with a fresh
        Adam state.  With a mesh every rank calls it; rank 0 reads the file
        and the others take its parameters."""
        from .torch_compat import (load_rsl_rl_checkpoint, permute_params_to_our_dof_order,
                                   rsl_rl_state_dict)

        if self.recurrent:
            raise ValueError("a reference .pt checkpoint holds an MLP policy")
        if self.is_main:
            sd, _ = load_rsl_rl_checkpoint(pt_path)
            state = permute_params_to_our_dof_order(rsl_rl_state_dict(sd, self.network),
                                                    self.env.model.joint_names)
            self.network.load_state_dict({k: v.to(self.device) for k, v in state.items()})
            print(f"Warm-started PPO params from reference checkpoint: {pt_path}", flush=True)
        self.optimizer = Adam(self.network.parameters(), self.cfg.algorithm.max_grad_norm)
        self._replicate()

    def export_policy(self, path: str) -> List[str]:
        """Write the deployment files into ``path`` and return them: the MLP
        policy as TorchScript (``policy_1.pt``) and as a ``torch.export``
        program (``policy.pt2``), a recurrent one as TorchScript with its
        memory inside (``policy_lstm_1.pt``); the normalizer folded in."""
        from ..utils.export import (export_policy_as_jit, export_policy_pt2,
                                    export_recurrent_policy_as_jit, mlp_policy_module)

        act = self.cfg.policy.activation
        if self.recurrent:
            return [export_recurrent_policy_as_jit(self.network, path, activation=act,
                                                   normalizer=self.obs_norm)]
        module = mlp_policy_module(self.network.actor, act, self.obs_norm)
        return [export_policy_as_jit(self.network.actor, path, activation=act,
                                     normalizer=self.obs_norm),
                export_policy_pt2(module, torch.zeros(2, self.env.num_obs), path)]
