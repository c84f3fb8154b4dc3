"""The work the benchmark's cells need, counted from shapes: a frozen copy of
the physics step's float operations and bytes per env and control step, the
MLP's operations, and the H100's published peaks.  The counts belong to the
yardstick, not to the program: they say what the algorithm needs, whatever
implements it."""
from __future__ import annotations

from typing import Sequence

import torch

PEAK_BYTES_S = 3.35e12            # H100 SXM HBM3
PEAK_F32 = 67e12                  # float32 outside the tensor cores
PEAK_TF32 = 495e12                # TF32 tensor cores, dense


def matmul_peak() -> float:
    """The peak of the precision the timed path's matrix products run in:
    TF32 where PyTorch allows it, else float32."""
    return PEAK_TF32 if torch.backends.cuda.matmul.allow_tf32 else PEAK_F32


def control_step_flops(nb: int, nj: int, ng: int, nf: int, decimation: int,
                       rough: bool = False, fix_base: bool = False) -> int:
    """Float operations of one env's control step (PD torques and clamps,
    ``decimation`` ABA substeps with penalty contacts, the report on the
    last); each add, multiply, min/max, divide, square root, sine, cosine or
    floor counts one, the 6x6 and 3x3 products blockwise (zero blocks, the
    zeros of skew matrices and the mirrored half of symmetric results cost
    nothing).  ``rough`` adds the heightfield sample and the general normal."""
    per_sub = (13 * nj               # torques and clamp (7); joint integration (6)
               + 407                 # base frame, mass delta, 6x6 Cholesky solve, base integration
               + 129 * nb            # IA v and v x* (IA v); gravity wrench
               + 864 * (nb - 1)      # per joint: kinematics, backward and forward sweeps
               + 247 * ng)           # per geom: point kinematics, penalty, stiction, wrench, damper
    if fix_base:
        per_sub -= 175 + 43 + 129 + 42
    report = nf * 45 + ng * 76       # foot kinematics; implicit-consistent geom forces
    if rough:
        per_sub += 98 * ng           # heightfield sample, normal, projected terms per geom
        report += 13 * ng
    return decimation * per_sub + report


def control_step_bytes(nj: int, ng: int, nf: int, decimation: int, rough: bool = False) -> int:
    """Bytes one env's control step must move: its state read and written,
    actions, friction and mass delta read, torques, geom forces and foot
    kinematics written (float32), and on a heightfield one 16-byte corner
    read per geom and substep."""
    ns = 13 + 2 * nj + 2 * ng
    per_env = 4 * (2 * ns + 2 * nj + 2 + 3 * ng + 6 * nf)
    return per_env + (16 * ng * decimation if rough else 0)


def mlp_flops(inputs: int, hidden: Sequence[int], outputs: int) -> int:
    """Float operations of one sample through an MLP: 2 per multiply-add,
    plus the bias and the activation of each hidden unit."""
    dims = [inputs] + list(hidden) + [outputs]
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return 2 * macs + 2 * sum(hidden) + outputs


def ppo_iteration_flops(num_envs: int, steps: int, epochs: int, num_obs: int, num_actions: int,
                        hidden: Sequence[int]) -> int:
    """The networks' operations of one PPO iteration: the actor and critic
    forward on every collected step and on the bootstrap observation, and
    forward plus backward (3x forward) on every sample in every epoch."""
    fwd = mlp_flops(num_obs, hidden, num_actions) + mlp_flops(num_obs, hidden, 1)
    return fwd * num_envs * (steps + 1) + 3 * fwd * num_envs * steps * epochs
