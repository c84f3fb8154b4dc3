"""Teacher -> student distillation runner (port of
``rl/distillation_runner.py``).

One iteration lets the STUDENT act for ``num_steps_per_env`` steps (with
``exploration_std`` Gaussian noise on its actions; the recurrent student's
carry is zeroed where an env reset), labels every pre-step observation with
the frozen teacher, and behaviour-clones on the window
(:class:`rl.distillation.Distillation`).  The teacher reads the env's
privileged observation where it has one, else the observation.  The env
state and the carry run on
across iterations; the episode metrics start empty each iteration.  Every
physics step is one launch of the env's fused step (B1 on flat ground).
It runs in one process: the JAX package shards no distillation, so it has
no data-parallel form (``OnPolicyRunner`` has one).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from ..envs.legged_robot import LeggedRobot
from ..models.student_teacher import StudentTeacher, StudentTeacherRecurrent
from ..utils.metrics import MetricsWriter
from .distillation import Distillation, scale_carry


class DistillationRunner:
    def __init__(self, env: LeggedRobot, teacher_policy: Callable[[torch.Tensor], torch.Tensor],
                 student_hidden_dims=(256, 256, 128), learning_rate=1e-3,
                 num_steps_per_env: int = 24, num_learning_epochs: int = 2,
                 gradient_length: int = 15, exploration_std: float = 0.05,
                 recurrent: bool = False, rnn_type: str = "lstm", rnn_hidden_size: int = 256,
                 log_dir: Optional[str] = None, seed: int = 0):
        """``teacher_policy``: the frozen map teacher_obs -> actions (e.g. a
        trained runner's ``get_inference_policy()``); ``learning_rate`` a
        constant or a schedule of optimizer steps; ``recurrent`` selects the
        LSTM / GRU student."""
        self.env, self.teacher_policy = env, teacher_policy
        self.device = env.device
        self.writer = MetricsWriter(log_dir) if log_dir else None
        self.num_steps_per_env = num_steps_per_env
        self.exploration_std = exploration_std
        self.recurrent = recurrent
        teacher_obs_dim = env.num_privileged_obs or env.num_obs
        gen = torch.Generator().manual_seed(seed)
        if recurrent:
            net = StudentTeacherRecurrent(env.num_obs, teacher_obs_dim, env.num_actions,
                                          tuple(student_hidden_dims), rnn_type=rnn_type,
                                          rnn_hidden_size=rnn_hidden_size, generator=gen)
        else:
            net = StudentTeacher(env.num_obs, teacher_obs_dim, env.num_actions,
                                 tuple(student_hidden_dims), generator=gen)
        self.network = net.to(self.device)
        self.alg = Distillation(self.network, learning_rate=learning_rate,
                                num_learning_epochs=num_learning_epochs,
                                gradient_length=gradient_length)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.env_state = env.reset_all()
        # the carry at the start of the next window (reference last_hidden_states)
        self.carry = self.alg.initialize_carry((env.num_envs,), self.device)
        self.iteration = 0

    def _draw_exploration_noise(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device)

    def train_iteration(self, exploration_noise: Optional[torch.Tensor] = None
                        ) -> Dict[str, torch.Tensor]:
        """One collection and update (the JAX ``_iteration``): the metrics as
        device scalars.  ``exploration_noise`` [T, B, A] (standard normal)
        replaces the runner's own draws."""
        env, alg = self.env, self.alg
        es = self.env_state.replace(episode_metrics=env.zero_episode_metrics())
        carry0 = carry = self.carry
        rows: Dict[str, List[torch.Tensor]] = {"s_obs": [], "t_act": [], "dones": []}
        t0 = time.perf_counter()
        with torch.no_grad():
            for t in range(self.num_steps_per_env):
                obs = es.obs
                t_obs = es.privileged_obs if es.privileged_obs is not None else obs
                if self.recurrent:
                    actions, carry = alg.act(obs, carry=carry)
                else:
                    actions = alg.act(obs)
                if self.exploration_std:
                    eps = (exploration_noise[t] if exploration_noise is not None
                           else self._draw_exploration_noise(actions.shape))
                    actions = actions + self.exploration_std * eps
                es = env.step(es, actions)
                done = es.reset_buf.to(torch.float32)
                if self.recurrent:
                    carry = scale_carry(carry, 1.0 - done)
                rows["s_obs"].append(obs)
                rows["t_act"].append(self.teacher_policy(t_obs))   # the pre-step observation
                rows["dones"].append(done)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        metrics = alg.update_on_actions(torch.stack(rows["s_obs"]), torch.stack(rows["t_act"]),
                                        torch.stack(rows["dones"]), carry0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_times = dict(collection_s=t1 - t0, update_s=time.perf_counter() - t1)
        em = es.episode_metrics
        metrics["mean_reward"] = em["return_sum"] / torch.clamp(em["count"], min=1.0)
        metrics["learning_rate"] = torch.tensor(alg.learning_rate, device=self.device)
        self.env_state, self.carry = es, carry
        self.iteration += 1
        return metrics

    def learn(self, num_iterations: int, log_interval: int = 10) -> Dict[str, float]:
        last: Dict[str, float] = {}
        for it in range(num_iterations):
            metrics = self.train_iteration()
            names = list(metrics)
            values = torch.stack([metrics[k].to(torch.float32) for k in names]).tolist()
            last = dict(zip(names, values), **self.last_times)
            if self.writer:
                self.writer.write(self.iteration, last)
            if it % log_interval == 0:
                print(f"distill it {it}: bc_loss {last['behavior_loss']:.5f}",
                      flush=True)
        if self.writer:
            self.writer.close()
        return last

    def get_student_policy(self):
        """The student's deterministic policy: ``obs -> actions``, or
        ``(obs, carry) -> (actions, carry)`` for the recurrent student.  It
        reads the network's parameters when called."""
        net = self.network

        @torch.no_grad()
        def policy(obs, *carry):
            return net.act_student(obs, *carry)

        return policy
