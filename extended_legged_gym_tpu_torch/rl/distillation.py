"""Teacher -> student behaviour cloning (port of ``rl/distillation.py``).

The student acts in the env; the frozen teacher labels privileged
observations.  The update walks the collected ``[T, B]`` window in chunks of
``gradient_length`` steps and takes one optimizer step per chunk; each of
``num_learning_epochs`` epochs replays the window from the carry it started
with, and the recurrent student's carry is detached between chunks
(truncated BPTT) and zeroed after a step that ended an episode.  With the
defaults of the distillation recipe (T = 24, G = 15, 2 epochs) that is 4
optimizer steps per iteration.

The optimizer is optax's ``chain(clip_by_global_norm(max_grad_norm),
adam(learning_rate))`` (the port's :class:`rl.ppo.Adam`) over the student's
parameters; a learning-rate schedule is a function of the optimizer steps
taken, as optax counts them.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Union

import torch

from ..models.student_teacher import StudentTeacher, StudentTeacherRecurrent
from .ppo import Adam


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule``: ``init_value`` times ``(1 - alpha)
    * (1 + cos(pi * min(count, decay_steps) / decay_steps)) / 2 + alpha``."""
    def schedule(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        return init_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)

    return schedule


def scale_carry(carry, keep: torch.Tensor):
    """``carry`` (a tensor or an LSTM's ``(c, h)``) times ``keep`` [B]."""
    if isinstance(carry, tuple):
        return tuple(scale_carry(c, keep) for c in carry)
    return carry * keep[:, None]


def detach_carry(carry):
    if isinstance(carry, tuple):
        return tuple(c.detach() for c in carry)
    return carry.detach()


class Distillation:
    def __init__(self, network: StudentTeacher,
                 learning_rate: Union[float, Callable[[int], float]] = 1e-3,
                 num_learning_epochs: int = 1, gradient_length: int = 15,
                 max_grad_norm: float = 1.0, loss_type: str = "mse"):
        """``network`` sits on its device already; ``learning_rate`` is a
        constant or a schedule of the optimizer steps taken."""
        self.network = network
        self.recurrent = isinstance(network, StudentTeacherRecurrent)
        self.num_learning_epochs = num_learning_epochs
        self.gradient_length = gradient_length
        self.loss_type = loss_type
        self.schedule = learning_rate if callable(learning_rate) else (lambda count: learning_rate)
        self.optimizer = Adam(network.student_parameters(), max_grad_norm)
        self.num_updates = 0
        self._ok = torch.ones((), dtype=torch.bool, device=network.log_std.device)

    @property
    def learning_rate(self) -> float:
        """The rate of the next optimizer step."""
        return self.schedule(self.num_updates)

    def initialize_carry(self, batch_dims, device="cpu"):
        return self.network.initialize_carry(batch_dims, device) if self.recurrent else None

    @torch.no_grad()
    def act(self, student_obs: torch.Tensor, carry=None):
        """The student's action; the recurrent student returns ``(actions,
        carry)``.  (The runner adds its own exploration noise.)"""
        if self.recurrent:
            return self.network.act_student(student_obs, carry)
        return self.network.act_student(student_obs)

    def _elem_loss(self, pred, target):
        if self.loss_type == "mse":
            return torch.mean(torch.square(pred - target))
        return torch.mean(torch.abs(pred - target))

    def _chunk_loss(self, carry, s_chunk, t_chunk, d_chunk):
        net = self.network
        if self.recurrent:
            losses = []
            for s, ta, d in zip(s_chunk, t_chunk, d_chunk):
                a, carry = net.act_student(s, carry)
                carry = scale_carry(carry, 1.0 - d)    # zeroed after a step that ended
                losses.append(self._elem_loss(a, ta))
            return torch.stack(losses).mean(), carry
        a = net.act_student(s_chunk.reshape(-1, s_chunk.shape[-1]))
        return self._elem_loss(a, t_chunk.reshape(-1, t_chunk.shape[-1])), None

    def update_on_actions(self, student_obs: torch.Tensor, teacher_actions: torch.Tensor,
                          dones: Optional[torch.Tensor] = None,
                          carry0=None) -> Dict[str, torch.Tensor]:
        """Behaviour cloning on a ``[T, B, ...]`` window toward recorded
        teacher actions: ``{"behavior_loss"}``, the mean over epochs of each
        epoch's mean chunk loss (a device scalar)."""
        T = student_obs.shape[0]
        G = max(1, min(self.gradient_length, T))
        bounds = [(i, min(i + G, T)) for i in range(0, T, G)]
        if dones is None:
            dones = torch.zeros(student_obs.shape[:2], device=student_obs.device)
        dones = dones.to(torch.float32)
        params = self.optimizer.params
        epoch_losses = []
        for _ in range(self.num_learning_epochs):
            carry, total = carry0, 0.0
            for lo, hi in bounds:
                loss, carry = self._chunk_loss(carry, student_obs[lo:hi], teacher_actions[lo:hi],
                                               dones[lo:hi])
                grads = torch.autograd.grad(loss, params)
                self.optimizer.step(grads, self.learning_rate, self._ok)
                self.num_updates += 1
                if carry is not None:
                    carry = detach_carry(carry)
                total = total + loss.detach()
            epoch_losses.append(total / len(bounds))
        return dict(behavior_loss=torch.stack(epoch_losses).mean())

    def update(self, student_obs: torch.Tensor, teacher_obs: torch.Tensor,
               dones: Optional[torch.Tensor] = None, carry0=None) -> Dict[str, torch.Tensor]:
        """Behaviour cloning toward the frozen teacher's actions on
        ``teacher_obs`` [T, B, D]."""
        with torch.no_grad():
            targets = self.network.evaluate_teacher(teacher_obs)
        return self.update_on_actions(student_obs, targets, dones, carry0)
