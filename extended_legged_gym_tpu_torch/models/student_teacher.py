"""Student-teacher policy pair for distillation (port of
``models/student_teacher.py``): the student acts on its own observations,
the frozen teacher on privileged ones; the recurrent variant puts an LSTM or
GRU (``Memory``) before the student MLP.  Children carry flax's names
(``student``, ``teacher``, ``memory``, ``log_std``), so :func:`flax_tree`
gives the JAX network's parameter tree."""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from .networks import MLP, Memory, load_flax_tree


class StudentTeacher(nn.Module):
    """Student MLP on ``student_obs``; teacher MLP on ``teacher_obs``, its
    output detached (frozen during training)."""

    def __init__(self, num_student_obs: int, num_teacher_obs: int, num_actions: int,
                 student_hidden_dims: Sequence[int] = (256, 256, 128),
                 teacher_hidden_dims: Sequence[int] = (256, 256, 128),
                 activation: str = "elu", init_noise_std: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.student = MLP(num_student_obs, student_hidden_dims, num_actions, activation,
                           generator)
        self.teacher = MLP(num_teacher_obs, teacher_hidden_dims, num_actions, activation,
                           generator)
        self.log_std = nn.Parameter(torch.full((num_actions,), math.log(init_noise_std)))

    def forward(self, student_obs: torch.Tensor, teacher_obs: torch.Tensor):
        return self.student(student_obs), self.teacher(teacher_obs).detach()

    def act_student(self, student_obs: torch.Tensor) -> torch.Tensor:
        return self.student(student_obs)

    def evaluate_teacher(self, teacher_obs: torch.Tensor) -> torch.Tensor:
        return self.teacher(teacher_obs)

    def student_parameters(self):
        """What distillation trains: the student (and its memory)."""
        return [p for n, p in self.named_parameters() if not n.startswith("teacher.")
                and n != "log_std"]


class StudentTeacherRecurrent(StudentTeacher):
    """Recurrent student (``Memory`` of ``rnn_type`` before the student MLP)
    with an MLP teacher."""

    def __init__(self, num_student_obs: int, num_teacher_obs: int, num_actions: int,
                 student_hidden_dims: Sequence[int] = (256, 256, 128),
                 teacher_hidden_dims: Sequence[int] = (256, 256, 128),
                 activation: str = "elu", rnn_hidden_size: int = 256, rnn_type: str = "lstm",
                 init_noise_std: float = 0.1, generator: Optional[torch.Generator] = None):
        super().__init__(rnn_hidden_size, num_teacher_obs, num_actions, student_hidden_dims,
                         teacher_hidden_dims, activation, init_noise_std, generator)
        self.memory = Memory(num_student_obs, rnn_hidden_size, rnn_type, generator)

    def forward(self, student_obs: torch.Tensor, teacher_obs: torch.Tensor, carry):
        actions, carry = self.act_student(student_obs, carry)
        return actions, self.teacher(teacher_obs).detach(), carry

    def act_student(self, student_obs: torch.Tensor, carry) -> Tuple[torch.Tensor, object]:
        """``(actions, carry)``: the JAX package's ``_act_student_carry``."""
        h, carry = self.memory(student_obs, carry)
        return self.student(h), carry

    def initialize_carry(self, batch_dims: Tuple[int, ...], device="cpu"):
        return self.memory.initialize_carry(batch_dims, device)


def load_teacher_from_actor_critic(net: StudentTeacher, ac_params: Dict) -> StudentTeacher:
    """Copy a trained ActorCritic's actor (a flax tree ``{"params":
    {"actor": {"Dense_k": ...}, ...}}``, as the JAX and the port's runners
    save) into ``net``'s teacher."""
    load_flax_tree(net.teacher, ac_params["params"]["actor"])
    return net
