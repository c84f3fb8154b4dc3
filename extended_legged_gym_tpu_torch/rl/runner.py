"""On-policy training runner for the MLP policy (port of ``rl/runner.py``).

One iteration collects ``num_steps_per_env`` steps of every env into device
tensors ``[T, B, ...]`` (the physics step is the fused kernel on the card),
computes GAE with the timeout bootstrap, runs the PPO update, reads the
episodes that ended into the JAX runner's metric keys and advances the
staged rewards.  Nothing inside the collection or minibatch loops reads a
device value on the host; ``learn`` reads the metrics once per iteration.

Checkpoints are pickles in the JAX runner's layout (flax parameter tree,
``opt_state=None``, ``learning_rate``, ``obs_norm``, ``iteration``), so the
JAX ``OnPolicyRunner.load`` reads them; the port's Adam state rides under
``torch_opt_state`` and the reward stage under ``reward_stage``, which the
JAX runner ignores.  ``load`` reads the port's checkpoints and the JAX
package's (parameters and learning rate; a JAX checkpoint's optax state is
not carried over, so Adam restarts).

Not ported (raise ``NotImplementedError``): recurrent policies, RND,
symmetry augmentation, ``warmstart_from_reference`` and ``export_policy``.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import torch

from ..envs.legged_robot import EnvState, LeggedRobot
from ..envs.legged_robot_config import LeggedRobotCfgPPO
from ..models.networks import (ActorCritic, RunningNorm, dump_checkpoint, gaussian_log_prob,
                               inference_policy, norm_from_checkpoint, params_from_jax,
                               params_to_jax, read_checkpoint)
from ..utils.metrics import MetricsWriter
from .ppo import Adam, PPOConfig, Transition, compute_gae, ppo_update


class OnPolicyRunner:
    def __init__(self, env: LeggedRobot, train_cfg: LeggedRobotCfgPPO,
                 log_dir: Optional[str] = None, seed: Optional[int] = None):
        alg, pol, run = train_cfg.algorithm, train_cfg.policy, train_cfg.runner
        if run.policy_class_name != "ActorCritic":
            raise NotImplementedError(f"not ported yet: policy {run.policy_class_name}")
        if alg.rnd_cfg or alg.symmetry_cfg:
            raise NotImplementedError("not ported yet: RND and symmetry augmentation")
        self.env, self.cfg, self.log_dir = env, train_cfg, log_dir
        self.device = env.device
        self.writer = MetricsWriter(log_dir) if log_dir else None
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
        self.network = ActorCritic(
            env.num_obs, env.num_actions, pol.actor_hidden_dims, pol.critic_hidden_dims,
            pol.activation, pol.init_noise_std,
            generator=torch.Generator().manual_seed(seed)).to(self.device)
        self.optimizer = Adam(self.network.parameters(), alg.max_grad_norm)
        self.learning_rate = torch.tensor(alg.learning_rate, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.obs_norm = (RunningNorm.create(env.num_obs, device=self.device)
                         if run.empirical_normalization else None)
        self.env_state: EnvState = env.reset_all()
        self.iteration = 0

    # ------------------------------------------------------------------
    def _policy_io(self, es: EnvState, obs_norm: Optional[RunningNorm]):
        obs = obs_norm.normalize(es.obs) if obs_norm is not None else es.obs
        return obs, obs

    @torch.no_grad()
    def _collect(self, es: EnvState, action_noise: Optional[torch.Tensor]):
        """``num_steps_per_env`` steps of every env: ``(env_state, batch)``.
        The action noise is ``action_noise[t]`` where given (tests inject the
        JAX runner's), else standard normal from the runner's generator."""
        env, net, gamma = self.env, self.network, self.ppo_cfg.gamma
        rows: Dict[str, List[torch.Tensor]] = {k: [] for k in (
            "obs", "critic_obs", "actions", "rewards", "dones", "values", "log_probs", "mu",
            "sigma")}
        for t in range(self.num_steps_per_env):
            obs, critic_obs = self._policy_io(es, self.obs_norm)
            mean, std, value = net(obs, critic_obs)
            eps = (action_noise[t] if action_noise is not None else
                   torch.randn(mean.shape, generator=self.generator, device=self.device))
            actions = mean + std * eps
            log_prob = gaussian_log_prob(mean, std, actions)
            es = env.step(es, actions)
            # timeout bootstrap with the value of the observation before the
            # step; dones is reset_buf, which includes the time-outs
            rewards = es.rew + gamma * value * es.time_out_buf
            for k, v in (("obs", obs), ("critic_obs", critic_obs), ("actions", actions),
                         ("rewards", rewards), ("dones", es.reset_buf), ("values", value),
                         ("log_probs", log_prob), ("mu", mean), ("sigma", std)):
                rows[k].append(v)
        return es, Transition(**{k: torch.stack(v) for k, v in rows.items()})

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
        es, batch = self._collect(es, action_noise)
        obs_norm = self.obs_norm
        if obs_norm is not None:
            # as in the JAX runner: updated with the (already normalized)
            # observations the policy saw
            obs_norm = obs_norm.update(batch.obs)
        with torch.no_grad():
            last_value = self.network.evaluate(self._policy_io(es, self.obs_norm)[1])
        advantages, returns = compute_gae(batch.rewards, batch.dones, batch.values, last_value,
                                          cfg.gamma, cfg.lam)
        action_std = self.network.log_std.detach().exp().mean()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.learning_rate, metrics = ppo_update(
            self.network, cfg, self.optimizer, batch, advantages, returns, self.learning_rate,
            perms=perms, generator=self.generator)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_times = dict(collection_s=t1 - t0, update_s=time.perf_counter() - t1)

        em = es.episode_metrics
        n_ep = torch.clamp(em["count"], min=1.0)
        metrics["mean_reward"] = em["return_sum"] / n_ep
        metrics["mean_episode_length"] = em["length_sum"] / n_ep
        metrics["episodes_done"] = em["count"]
        metrics["mean_step_reward"] = batch.rewards.mean()
        metrics["action_std"] = action_std
        if env.custom_origins:
            metrics["terrain_level"] = es.terrain_levels.to(torch.float32).mean()
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
        self.env_state, self.obs_norm = es, obs_norm
        self.iteration += 1
        return metrics

    # ------------------------------------------------------------------
    def learn(self, num_iterations: int, log_interval: int = 10,
              save_interval: Optional[int] = None) -> Dict[str, float]:
        save_interval = save_interval or self.cfg.runner.save_interval
        steps_per_iter = self.num_steps_per_env * self.env.num_envs
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
            if it % log_interval == 0 or it == num_iterations - 1:
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
        with open(path, "wb") as f:
            dump_checkpoint(payload, f)

    def load(self, path: str, load_optimizer: bool = True) -> dict:
        payload = read_checkpoint(path)
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
        if payload.get("reward_stage") is not None:
            self.env_state = self.env_state.replace(
                reward_stage=torch.tensor(int(payload["reward_stage"]), device=self.device))
        self.iteration = int(payload.get("iteration", 0))
        return payload

    def get_inference_policy(self):
        """The deterministic policy ``obs -> actions`` (the actor's mean on
        normalized observations)."""
        return inference_policy(self.network, self.obs_norm)

    def warmstart_from_reference(self, pt_path: str):
        raise NotImplementedError("not ported yet: warm start from a reference .pt checkpoint")

    def export_policy(self, path: str):
        raise NotImplementedError("not ported yet: policy export")
