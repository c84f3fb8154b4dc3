"""Raibert-heuristic foothold and base references (port of
``utils/raibert_planner.py``), in three layers:

* :func:`sin_swing_traj`: the half-sine swing height on the phase;
* :class:`SimpleRaibertPlanner`: an ideal-trajectory integrator.  Its state
  (:class:`RaibertPlannerState`: the ideal base pose integrated from the
  velocity commands, the gait clock, per-env randomized nominal footholds,
  base and swing heights, and the swing feet EMA-tracking the foothold at
  their next mid-stance) is a dataclass of tensors advanced by ``init`` /
  ``reset`` / ``step``.  It gives an observation [base pos (3), base quat
  (4), feet (3F), support flags (F)] relative to the real base, and
  tracking penalties and rewards;
* :class:`RaibertPlanner`: the same with the reference pose shifted by a
  6-DoF random walk and the nominal footholds drifting (two
  :class:`~.random_walker.RandomWalker`), for arbitrary body poses;
* :class:`RaibertHeuristic`: closed-form references from the state, the
  commands and the clock (p = p_hip + v T_st / 2 + k (v - v_cmd)), no
  integrator state; ``FootTrackElSpider``'s reward terms read it.

Every env carries its own gait phase.  Each draw comes from the caller's
``torch.Generator`` or is passed in (``noise=`` standard normals for the
nominals, the walkers' ``*_targets=``), so a test can inject the JAX
planner's draws.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import configclass
from .math import quat_apply_yaw, quat_conjugate, quat_mul, quat_rotate, quat_rotate_inverse, \
    ypr_to_quat
from .random_walker import RandomWalker, RandomWalkerState


def sin_swing_traj(swing_height, phase: torch.Tensor) -> torch.Tensor:
    """Half-sine swing height on phase in [0, 0.5), zero in stance."""
    phase = torch.as_tensor(phase)
    return torch.where(phase < 0.5, swing_height * torch.sin(2 * math.pi * phase),
                       torch.zeros_like(phase))


def _yaw_quat(angle: torch.Tensor) -> torch.Tensor:
    """Quaternion (xyzw) of a rotation by ``angle`` about +z."""
    zeros = torch.zeros_like(angle)
    return ypr_to_quat(angle, zeros, zeros)


def _axis(q: torch.Tensor, i: int) -> torch.Tensor:
    """The world direction of q's body axis ``i``."""
    e = torch.zeros(3, dtype=q.dtype, device=q.device)
    e[i] = 1.0
    return quat_rotate(q, e.expand(q.shape[:-1] + (3,)))


def _heading_only(quat: torch.Tensor) -> torch.Tensor:
    """The yaw-only rotation of ``quat``'s heading (its rotated x axis)."""
    x_world = _axis(quat, 0)
    return _yaw_quat(torch.atan2(x_world[..., 1], x_world[..., 0]))


# ---------------------------------------------------------------------------
# The ideal-trajectory integrator
# ---------------------------------------------------------------------------

@configclass
class SimpleRaibertPlannerCfg:
    dt: float = 0.02
    # nominal footholds in the base frame, in the model's foot order (LB, LF,
    # LM, RB, RF, RM)
    nominal_foothold_base: list = [
        [-0.354, 0.34, -0.28], [0.354, 0.34, -0.28], [0.054, 0.40, -0.28],
        [-0.354, -0.34, -0.28], [0.354, -0.34, -0.28], [0.054, -0.40, -0.28]]
    foot_phases: list = [0.5, 0.5, 0.0, 0.0, 0.0, 0.5]
    nominal_base_height: float = 0.30
    gait_period: float = 0.5
    swing_height: float = 0.1
    swing_foot_track_ema: float = 0.25
    nominal_foothold_base_sigma: float = 0.02
    nominal_base_height_sigma: float = 0.02
    nominal_swing_height_sigma: float = 0.05
    min_base_height: float = 0.16
    min_swing_height: float = 0.02
    reward_sigma: float = 0.25


@dataclass
class RaibertPlannerState:
    base_pos: torch.Tensor              # [B, 3] ideal base position
    base_quat: torch.Tensor             # [B, 4] ideal base orientation (yaw only)
    foot_pos: torch.Tensor              # [B, F, 3] ideal foot positions (world)
    gait_idx: torch.Tensor              # [B] gait clock in [0, 1)
    last_contacts: torch.Tensor         # [B, F] bool
    nominal_foothold: torch.Tensor      # [B, F, 3] per-env randomized nominals
    nominal_base_height: torch.Tensor   # [B]
    nominal_swing_height: torch.Tensor  # [B]
    base_rw: Optional[RandomWalkerState] = None   # RaibertPlanner's pose walk
    foot_rw: Optional[RandomWalkerState] = None   # RaibertPlanner's foothold walk

    def replace(self, **changes) -> "RaibertPlannerState":
        return dataclasses.replace(self, **changes)


def _select(done: torch.Tensor, new, old):
    """``new`` where ``done`` [B], else ``old`` (tensors, walker states or None)."""
    if old is None:
        return None
    if isinstance(old, (RaibertPlannerState, RandomWalkerState)):
        return old.replace(**{f.name: _select(done, getattr(new, f.name), getattr(old, f.name))
                              for f in dataclasses.fields(old)})
    return torch.where(done.reshape((-1,) + (1,) * (old.dim() - 1)), new, old)


class SimpleRaibertPlanner:
    """The ideal-trajectory integrator as plain functions over
    :class:`RaibertPlannerState`."""

    def __init__(self, cfg: SimpleRaibertPlannerCfg):
        self.cfg = cfg
        self.nominal = torch.as_tensor(np.array(cfg.nominal_foothold_base, np.float32))
        self.phases = torch.as_tensor(np.array(cfg.foot_phases, np.float32))
        self.foot_num = int(self.nominal.shape[0])

    def draw_noise(self, B: int, device, generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Standard normals for the nominal footholds [B, F, 3], base heights
        [B] and swing heights [B]."""
        return (torch.randn((B, self.foot_num, 3), generator=generator, device=device),
                torch.randn((B,), generator=generator, device=device),
                torch.randn((B,), generator=generator, device=device))

    def _nominals(self, noise):
        cfg = self.cfg
        n_foot, n_height, n_swing = noise
        foothold = (self.nominal.to(n_foot.device)[None]
                    + cfg.nominal_foothold_base_sigma * n_foot)
        height = torch.clamp(cfg.nominal_base_height + cfg.nominal_base_height_sigma * n_height,
                             min=cfg.min_base_height)
        swing = torch.clamp(cfg.swing_height + cfg.nominal_swing_height_sigma * n_swing,
                            min=cfg.min_swing_height)
        return foothold, height, swing

    def init(self, base_pos: torch.Tensor, base_quat: torch.Tensor,
             generator: Optional[torch.Generator] = None, noise=None) -> RaibertPlannerState:
        """The ideal pose at the nominal height and the real heading, the
        feet at the randomized nominals."""
        B, dev = base_pos.shape[0], base_pos.device
        noise = self.draw_noise(B, dev, generator) if noise is None else noise
        foothold, height, swing = self._nominals(noise)
        pos = torch.cat([base_pos[:, :2], height[:, None]], dim=-1)
        quat = _heading_only(base_quat)
        foot = quat_rotate(quat[:, None], foothold) + pos[:, None]
        return RaibertPlannerState(
            base_pos=pos, base_quat=quat, foot_pos=foot, gait_idx=torch.zeros(B, device=dev),
            last_contacts=torch.zeros(B, self.foot_num, dtype=torch.bool, device=dev),
            nominal_foothold=foothold, nominal_base_height=height, nominal_swing_height=swing)

    def reset(self, state: RaibertPlannerState, done: torch.Tensor, base_pos: torch.Tensor,
              base_quat: torch.Tensor, generator: Optional[torch.Generator] = None,
              **draws) -> RaibertPlannerState:
        """A fresh ``init`` where ``done`` [B] is set."""
        return _select(done, self.init(base_pos, base_quat, generator, **draws), state)

    def _step_core(self, state: RaibertPlannerState, command: torch.Tensor,
                   nominal_foothold: torch.Tensor) -> RaibertPlannerState:
        cfg = self.cfg
        phases = self.phases.to(command.device)
        x_w, y_w = _axis(state.base_quat, 0), _axis(state.base_quat, 1)
        # each foot's time to the middle of its next stance
        gait_phases = torch.remainder(state.gait_idx[:, None] + phases[None], 1.0)
        dur_mid = torch.remainder(1.75 - gait_phases, 1.0) * cfg.gait_period      # [B, F]
        # the base pose extrapolated to each foot's next mid-stance
        lin = x_w[:, None] * command[:, None, :1] + y_w[:, None] * command[:, None, 1:2]
        pos_mid = state.base_pos[:, None] + lin * dur_mid[..., None]              # [B, F, 3]
        quat_mid = quat_mul(_yaw_quat(command[:, None, 2] * dur_mid), state.base_quat[:, None])
        # integrate the ideal base
        quat = quat_mul(_yaw_quat(command[:, 2] * cfg.dt), state.base_quat)
        pos = state.base_pos + (x_w * command[:, :1] + y_w * command[:, 1:2]) * cfg.dt
        # advance the clock; the swing feet EMA-track the foothold at their
        # next mid-stance
        gait_idx = torch.remainder(state.gait_idx + cfg.dt / cfg.gait_period, 1.0)
        gait_phases = torch.remainder(gait_idx[:, None] + phases[None], 1.0)
        swing = gait_phases < 0.5
        nominal_w = quat_rotate(quat_mid, nominal_foothold) + pos_mid              # [B, F, 3]
        ema = cfg.swing_foot_track_ema
        xy = torch.where(swing[..., None],
                         nominal_w[..., :2] * ema + state.foot_pos[..., :2] * (1 - ema),
                         state.foot_pos[..., :2])
        z = torch.where(swing, sin_swing_traj(state.nominal_swing_height[:, None], gait_phases),
                        torch.zeros_like(gait_phases))
        foot = torch.cat([xy, z[..., None]], dim=-1)
        return state.replace(base_pos=pos, base_quat=quat, foot_pos=foot, gait_idx=gait_idx)

    def step(self, state: RaibertPlannerState, command: torch.Tensor) -> RaibertPlannerState:
        """One control period under ``command`` [B, 3] = (lin_vel_x,
        lin_vel_y, ang_vel_yaw)."""
        return self._step_core(state, command, state.nominal_foothold)

    def swing_mask(self, state: RaibertPlannerState) -> torch.Tensor:
        phases = self.phases.to(state.gait_idx.device)
        return torch.remainder(state.gait_idx[:, None] + phases[None], 1.0) < 0.5

    def _ref_pose(self, state: RaibertPlannerState):
        """The pose the tracking terms target."""
        return state.base_pos, state.base_quat

    def observations(self, state: RaibertPlannerState, base_pos_real: torch.Tensor,
                     base_quat_real: torch.Tensor) -> torch.Tensor:
        """[B, 3 + 4 + 3F + F]: the reference pose and the ideal feet in the
        real base's frame, and the support flags."""
        ref_pos, ref_quat = self._ref_pose(state)
        pos_rel = quat_rotate_inverse(base_quat_real, ref_pos - base_pos_real)
        quat_rel = quat_mul(quat_conjugate(base_quat_real), ref_quat)
        foot_rel = quat_rotate_inverse(base_quat_real[:, None],
                                       state.foot_pos - base_pos_real[:, None])
        support = (~self.swing_mask(state)).to(torch.float32)
        return torch.cat([pos_rel, quat_rel, foot_rel.flatten(1), support], dim=-1)

    def penalty_base_pos_track(self, state, base_pos_real):
        return torch.linalg.norm(self._ref_pose(state)[0] - base_pos_real, dim=-1)

    def penalty_base_quat_track(self, state, base_quat_real):
        dq = quat_mul(base_quat_real, quat_conjugate(self._ref_pose(state)[1]))
        return torch.linalg.norm(dq[..., :3], dim=-1)

    def penalty_foot_pos_track(self, state, foot_positions):
        return torch.linalg.norm(state.foot_pos - foot_positions, dim=-1).sum(dim=-1)

    def penalty_foot_pos_track_z(self, state, foot_positions):
        return (state.foot_pos[..., 2] - foot_positions[..., 2]).abs().sum(dim=-1)

    def penalty_foot_swing_contact(self, state: RaibertPlannerState,
                                   feet_contact_z: torch.Tensor):
        """``(state, penalty)``: the swinging feet in contact (vertical force
        [B, F] above 1 N, filtered with the last step's contacts)."""
        contact = feet_contact_z > 1.0
        contact_filt = contact | state.last_contacts
        state = state.replace(last_contacts=contact)
        return state, (contact_filt & self.swing_mask(state)).sum(dim=-1).to(torch.float32)

    def reward_base_pos_track(self, state, base_pos_real):
        return torch.exp(-self.penalty_base_pos_track(state, base_pos_real) / self.cfg.reward_sigma)

    def reward_base_quat_track(self, state, base_quat_real):
        return torch.exp(-self.penalty_base_quat_track(state, base_quat_real)
                         / self.cfg.reward_sigma)

    def reward_foot_pos_track(self, state, foot_positions):
        d = torch.linalg.norm(state.foot_pos - foot_positions, dim=-1)
        return torch.exp(-d / self.cfg.reward_sigma).sum(dim=-1)


# ---------------------------------------------------------------------------
# With random-walk pose targets
# ---------------------------------------------------------------------------

@configclass
class RaibertPlannerV2Cfg(SimpleRaibertPlannerCfg):
    nominal_foothold_base_sigma: float = 0.08
    # base walk bounds [x shift, y shift, height, yaw, pitch, roll]
    base_rand_low: list = [-0.1, -0.1, 0.16, -0.5, -0.3, -0.8]
    base_rand_high: list = [0.1, 0.1, 0.40, 0.5, 0.3, 0.8]
    basepose_target_update_interval: float = 0.5
    basepose_max_track_vel: float = 1.0
    foothold_target_update_interval: float = 0.5
    foothold_max_track_vel: float = 2.0


class RaibertPlanner(SimpleRaibertPlanner):
    """The integrator with its reference pose shifted by a 6-DoF random walk
    (uniform in the bounds) and its nominal footholds drifting (a normal
    walk about the nominals); the ideal height rides the pose walk."""

    def __init__(self, cfg: Optional[RaibertPlannerV2Cfg] = None):
        cfg = cfg or RaibertPlannerV2Cfg()
        super().__init__(cfg)
        flat_nom = np.asarray(cfg.nominal_foothold_base, np.float32).reshape(-1)
        self._walk_args = (
            (np.array([cfg.base_rand_low, cfg.base_rand_high], np.float32),
             cfg.basepose_target_update_interval, cfg.basepose_max_track_vel, "uniform"),
            (np.stack([flat_nom, np.full_like(flat_nom, cfg.nominal_foothold_base_sigma)]),
             cfg.foothold_target_update_interval, cfg.foothold_max_track_vel, "normal"))

    def walkers(self, B: int, device) -> Tuple[RandomWalker, RandomWalker]:
        """The (pose, foothold) walkers of ``B`` envs on ``device``."""
        return tuple(RandomWalker(b, B, interval, vel, dist, device)
                     for b, interval, vel, dist in self._walk_args)

    def init(self, base_pos, base_quat, generator=None, noise=None,
             base_walk: Optional[Sequence[torch.Tensor]] = None,
             foot_walk: Optional[Sequence[torch.Tensor]] = None) -> RaibertPlannerState:
        """As the integrator's, with the walks started (``*_walk`` = the
        walker's (current, target) draws, else drawn)."""
        base_w, foot_w = self.walkers(base_pos.shape[0], base_pos.device)
        state = super().init(base_pos, base_quat, generator, noise)
        base_rw = base_w.init(generator, *(base_walk or ()))
        foot_rw = foot_w.init(generator, *(foot_walk or ()))
        pos = torch.cat([state.base_pos[:, :2], base_rw.current[:, 2:3]], dim=-1)
        return state.replace(base_pos=pos, base_rw=base_rw, foot_rw=foot_rw)

    def step(self, state: RaibertPlannerState, command: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             base_targets: Optional[torch.Tensor] = None,
             foot_targets: Optional[torch.Tensor] = None) -> RaibertPlannerState:
        """The walks advance (``*_targets`` inject their new-target draws),
        the integrator steps on the drifted nominals, and the ideal height
        takes the pose walk's."""
        dt = self.cfg.dt
        base_w, foot_w = self.walkers(command.shape[0], command.device)
        base_rw = base_w.step(state.base_rw, dt, generator, base_targets)
        foot_rw = foot_w.step(state.foot_rw, dt, generator, foot_targets)
        state = self._step_core(state, command, foot_rw.current.reshape(state.foot_pos.shape))
        pos = torch.cat([state.base_pos[:, :2], base_rw.current[:, 2:3]], dim=-1)
        return state.replace(base_pos=pos, base_rw=base_rw, foot_rw=foot_rw)

    def _ref_pose(self, state: RaibertPlannerState):
        """The integrated pose shifted by the walk: x and y along the ideal
        heading, then yaw, pitch and roll."""
        rw = state.base_rw.current
        x_w, y_w = _axis(state.base_quat, 0), _axis(state.base_quat, 1)
        pos = state.base_pos + x_w * rw[:, :1] + y_w * rw[:, 1:2]
        quat = quat_mul(state.base_quat, ypr_to_quat(rw[:, 3], rw[:, 4], rw[:, 5]))
        return pos, quat


# ---------------------------------------------------------------------------
# The closed-form heuristic
# ---------------------------------------------------------------------------

@configclass
class RaibertHeuristicCfg:
    gait_period: float = 0.8
    duty: float = 0.6
    swing_height: float = 0.09
    base_height: float = 0.5
    feedback_gain: float = 0.03      # k in the Raibert correction
    hip_offsets: list = [[0.36, 0.23], [0.36, -0.23], [-0.36, 0.23], [-0.36, -0.23]]
    foot_phases: list = [0.0, 0.5, 0.5, 0.0]


class RaibertReferences(NamedTuple):
    base_pos_ref: torch.Tensor     # [B, 3]
    base_vel_ref: torch.Tensor     # [B, 3] world
    foot_pos_ref: torch.Tensor     # [B, F, 3] world touchdown / swing targets
    swing_mask: torch.Tensor       # [B, F] 1 where the foot should swing


class RaibertHeuristic:
    """Closed-form Raibert targets from the state, the commands and the
    clock: p_foot = p_hip + v T_st / 2 + k (v - v_cmd), no carried state."""

    def __init__(self, cfg: RaibertHeuristicCfg):
        self.cfg = cfg
        self.hips = torch.as_tensor(np.array(cfg.hip_offsets, np.float32))
        self.phases = torch.as_tensor(np.array(cfg.foot_phases, np.float32))

    def references(self, base_pos, base_quat, base_lin_vel_w, commands, t) -> RaibertReferences:
        """``t`` [B]: each env's time in its episode (seconds)."""
        cfg, dev = self.cfg, base_pos.device
        B, nf = base_pos.shape[0], self.hips.shape[0]
        cmd_vel_w = quat_apply_yaw(base_quat, torch.cat([commands[:, :2],
                                                         torch.zeros(B, 1, device=dev)], dim=-1))
        base_pos_ref = base_pos + cmd_vel_w * cfg.gait_period
        base_pos_ref = torch.cat([base_pos_ref[:, :2],
                                  torch.full((B, 1), float(cfg.base_height), device=dev)], dim=-1)
        ph = torch.remainder(t[:, None] / cfg.gait_period + self.phases.to(dev)[None, :], 1.0)
        swing = ph >= cfg.duty
        hips3 = torch.cat([self.hips.to(dev), torch.zeros(nf, 1, device=dev)], dim=-1)
        hips_w = base_pos[:, None, :] + quat_apply_yaw(base_quat[:, None, :], hips3[None, :, :])
        v_w = base_lin_vel_w[:, None, :]
        correction = cfg.feedback_gain * (v_w - cmd_vel_w[:, None, :])
        foot_ref = hips_w + v_w * (cfg.duty * cfg.gait_period / 2.0) + correction
        swing_prog = torch.clamp((ph - cfg.duty) / max(1 - cfg.duty, 1e-6), 0, 1)
        z = cfg.swing_height * torch.sin(swing_prog * math.pi) * swing
        foot_ref = torch.cat([foot_ref[..., :2], z[..., None]], dim=-1)
        return RaibertReferences(base_pos_ref, cmd_vel_w, foot_ref, swing.to(torch.float32))

    # tracking terms: penalties taken as rewards
    def reward_base_pos_track(self, refs: RaibertReferences, base_pos) -> torch.Tensor:
        return -torch.sum(torch.square(base_pos - refs.base_pos_ref), dim=-1)

    def reward_foot_pos_track(self, refs: RaibertReferences, foot_pos) -> torch.Tensor:
        err = torch.sum(torch.square(foot_pos[..., :2] - refs.foot_pos_ref[..., :2]), dim=-1)
        return -torch.sum(err * refs.swing_mask, dim=-1)

    def reward_foot_pos_track_z(self, refs: RaibertReferences, foot_pos) -> torch.Tensor:
        err = torch.square(foot_pos[..., 2] - refs.foot_pos_ref[..., 2])
        return -torch.sum(err * refs.swing_mask, dim=-1)

    def reward_foot_swing_contact(self, refs: RaibertReferences, contacts) -> torch.Tensor:
        """Contact during a commanded swing, penalized."""
        return -torch.sum(contacts.to(torch.float32) * refs.swing_mask, dim=-1)
