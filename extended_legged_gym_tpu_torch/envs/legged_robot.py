"""Legged-robot environment, flat subset (port of ``envs/legged_robot.py``).

The env object holds static configuration (model, terrain, index sets,
reward table) and the env's random generator; ``reset_all`` and ``step`` map
an :class:`EnvState` of ``[B, ...]`` tensors to a new one, as the JAX env's
pure functions do.  Physics runs through the fused decimated step
(``ops/physics_kernel.py``): the CUDA kernel on the card, its plain version on
the CPU.

Semantics kept from the JAX env, reference quirks included:
* observation layout [lin vel, ang vel, projected gravity, commands, dof pos,
  dof vel, actions] with scales and clipping;
* rewards: per-term scales × dt, ``only_positive_rewards`` clip;
* terminations: contact force > 1 N on a termination geom, non-finite state,
  or timeout; non-finite values are replaced by ``nan_to_num``;
* resets re-draw dof pos in [0.5, 1.5]×default, root velocities in ±0.5 and
  commands;
* the main env never updates ``last_actions`` / ``last_dof_vel`` after a
  reset (they stay zero, as in the JAX env); rollouts update them each step.

Not in this slice (the constructor raises): rough terrain and height scans,
heading commands, command curriculum, domain randomization, pushes,
observation noise, privileged observations, a termination reward, V control.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.physics_kernel import make_decimated_env_step
from ..physics.contact import default_contact_params
from ..physics.engine import EnvPhysParams, PhysState, StepReport, default_sim_params
from ..physics.model import geom_indices_matching
from ..physics.serialize import load_model
from ..terrain.heightfield import flat_terrain
from ..utils.config import class_to_dict
from ..utils.device import resolve_device
from ..utils.math import quat_rotate_inverse
from ..utils.tree import tree_map
from .legged_robot_config import LeggedRobotCfg


@dataclass
class EnvState:
    """Batched environment state: physics, episode bookkeeping, step outputs."""

    phys: PhysState
    env_params: EnvPhysParams
    episode_length: torch.Tensor     # [B] int64
    commands: torch.Tensor           # [B, 4]
    actions: torch.Tensor            # [B, A]
    last_actions: torch.Tensor       # [B, A]
    last_dof_vel: torch.Tensor       # [B, nj]
    torques: torch.Tensor            # [B, nj]
    feet_air_time: torch.Tensor      # [B, nf]
    feet_contact_time: torch.Tensor  # [B, nf]
    last_contacts: torch.Tensor      # [B, nf] bool
    base_lin_vel: torch.Tensor       # [B, 3] body frame
    base_ang_vel: torch.Tensor       # [B, 3] body frame
    projected_gravity: torch.Tensor  # [B, 3]
    foot_positions: torch.Tensor     # [B, nf, 3]
    foot_velocities: torch.Tensor    # [B, nf, 3]
    geom_forces: torch.Tensor        # [B, ng, 3]
    obs: torch.Tensor                # [B, obs_dim]
    rew: torch.Tensor                # [B]
    reset_buf: torch.Tensor          # [B] bool
    time_out_buf: torch.Tensor       # [B] bool
    episode_sums: Dict[str, torch.Tensor]
    episode_return: torch.Tensor     # [B]
    env_origins: torch.Tensor        # [B, 3]

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)


def _where(mask: torch.Tensor, new, old):
    """Per-env select over matching tensor trees."""
    return tree_map(lambda n, o: torch.where(mask.reshape((-1,) + (1,) * (o.dim() - 1)), n, o),
                    new, old)


class LeggedRobot:
    """Static env object with ``reset_all`` / ``step`` over :class:`EnvState`."""

    def __init__(self, cfg: LeggedRobotCfg, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self._check_supported(cfg)
        self.num_envs = cfg.env.num_envs
        self.num_actions = cfg.env.num_actions
        self.num_obs = cfg.env.num_observations
        self.dt = cfg.control.decimation * cfg.sim.dt
        self.max_episode_length_s = cfg.env.episode_length_s
        self.max_episode_length = int(np.ceil(self.max_episode_length_s / self.dt))

        self.model = model = load_model(cfg.asset.file)
        self.num_dof = model.nj
        self.terrain = flat_terrain(friction=cfg.terrain.static_friction)

        self.sim_params = default_sim_params(
            dt=cfg.sim.dt, gravity=tuple(cfg.sim.gravity),
            contact=default_contact_params(kp=cfg.sim.contact_kp, kd=cfg.sim.contact_kd,
                                           kt=cfg.sim.contact_kt,
                                           kt_spring=cfg.sim.contact_kt_spring),
            joint_damping=cfg.sim.joint_damping)

        # PD gains by joint-name matching
        p_gains = np.zeros(model.nj, np.float32)
        d_gains = np.zeros(model.nj, np.float32)
        for i, name in enumerate(model.joint_names):
            for k, v in cfg.control.stiffness.items():
                if k in name:
                    p_gains[i] = v
            for k, v in cfg.control.damping.items():
                if k in name:
                    d_gains[i] = v
        self.p_gains, self.d_gains = p_gains, d_gains

        self.feet_geoms = torch.as_tensor(np.asarray(model.foot_geom), device=self.device)
        self.num_feet = len(self.feet_geoms)
        self.termination_geoms = torch.as_tensor(
            geom_indices_matching(model, cfg.asset.terminate_after_contacts_on), dtype=torch.int64,
            device=self.device)
        self.penalised_geoms = torch.as_tensor(
            geom_indices_matching(model, cfg.asset.penalize_contacts_on), dtype=torch.int64,
            device=self.device)

        # grid origins on the plane
        n = int(np.ceil(np.sqrt(self.num_envs)))
        xx, yy = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        origins = np.zeros((self.num_envs, 3), np.float32)
        origins[:, 0] = cfg.env.env_spacing * xx.ravel()[: self.num_envs]
        origins[:, 1] = cfg.env.env_spacing * yy.ravel()[: self.num_envs]
        origins[:, :2] -= origins[:, :2].mean(axis=0, keepdims=True)
        self.grid_origins = torch.as_tensor(origins, device=self.device)

        rng = cfg.commands.ranges
        self.command_ranges = {k: tuple(float(x) for x in getattr(rng, k))
                               for k in ("lin_vel_x", "lin_vel_y", "ang_vel_yaw")}
        self.resampling_interval = int(np.clip(cfg.commands.resampling_time / self.dt, 1,
                                               np.iinfo(np.int32).max))
        self._prepare_reward_functions()

        self.decimated_step = make_decimated_env_step(
            model, self.sim_params, self.terrain, cfg.control.decimation, p_gains, d_gains,
            model.default_dof_pos, cfg.control.action_scale, control_type=cfg.control.control_type)

        T = model.torch(self.device)
        self.default_dof_pos = T["default_dof_pos"]
        self.torque_limits = T["torque_limits"]
        self.base_init_state = torch.tensor(
            list(cfg.init_state.pos) + list(cfg.init_state.rot)
            + list(cfg.init_state.lin_vel) + list(cfg.init_state.ang_vel),
            dtype=torch.float32, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)

    @staticmethod
    def _check_supported(cfg: LeggedRobotCfg):
        unsupported = {
            "terrain.mesh_type not plane": cfg.terrain.mesh_type not in ("plane", "none"),
            "terrain.measure_heights": cfg.terrain.measure_heights,
            "commands.heading_command": cfg.commands.heading_command,
            "commands.curriculum": cfg.commands.curriculum,
            "domain_rand.randomize_friction": cfg.domain_rand.randomize_friction,
            "domain_rand.randomize_base_mass": cfg.domain_rand.randomize_base_mass,
            "domain_rand.push_robots": cfg.domain_rand.push_robots,
            "rewards.scales.termination": cfg.rewards.scales.termination != 0,
            "noise.add_noise": cfg.noise.add_noise,
            "env.num_privileged_obs": cfg.env.num_privileged_obs is not None,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(f"not ported yet: {', '.join(bad)}")

    def _prepare_reward_functions(self):
        scales = class_to_dict(self.cfg.rewards.scales)
        names = []
        for name, v in scales.items():
            if v != 0 and name != "termination":
                if not hasattr(self, f"_reward_{name}"):
                    raise ValueError(f"reward term '{name}' has no _reward_{name} implementation")
                names.append(name)
        self.reward_names = names
        self.reward_scales = torch.tensor([scales[n] * self.dt for n in names],
                                          dtype=torch.float32, device=self.device)

    def _uniform(self, shape, lo, hi) -> torch.Tensor:
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return lo + (hi - lo) * u

    # ------------------------------------------------------------------ reset
    def reset_all(self, seed: Optional[int] = None) -> EnvState:
        """A fresh EnvState for all envs (re-seeds the generator if ``seed``)."""
        if seed is not None:
            self.generator.manual_seed(seed)
        B, dev = self.num_envs, self.device
        all_envs = torch.ones(B, dtype=torch.bool, device=dev)
        phys = self._sample_init_phys(self.grid_origins)
        commands = self._sample_commands(torch.zeros(B, 4, device=dev), all_envs)
        nf, ng = self.num_feet, self.model.ng
        z = lambda *s: torch.zeros(*s, device=dev)
        state = EnvState(
            phys=phys, env_params=EnvPhysParams(torch.ones(B, device=dev), torch.zeros(B, device=dev)),
            episode_length=torch.zeros(B, dtype=torch.int64, device=dev),
            commands=commands,
            actions=z(B, self.num_actions), last_actions=z(B, self.num_actions),
            last_dof_vel=z(B, self.num_dof), torques=z(B, self.num_dof),
            feet_air_time=z(B, nf), feet_contact_time=z(B, nf),
            last_contacts=torch.zeros(B, nf, dtype=torch.bool, device=dev),
            base_lin_vel=z(B, 3), base_ang_vel=z(B, 3),
            projected_gravity=torch.tensor([0.0, 0.0, -1.0], device=dev).repeat(B, 1),
            foot_positions=z(B, nf, 3), foot_velocities=z(B, nf, 3), geom_forces=z(B, ng, 3),
            obs=z(B, self.num_obs), rew=z(B),
            reset_buf=torch.zeros(B, dtype=torch.bool, device=dev),
            time_out_buf=torch.zeros(B, dtype=torch.bool, device=dev),
            episode_sums={n: z(B) for n in self.reward_names},
            episode_return=z(B), env_origins=self.grid_origins)
        state = self._refresh_derived(state)
        return state.replace(obs=self._compute_observations(state))

    def _sample_init_phys(self, env_origins) -> PhysState:
        """Fresh root and dof states for all envs (callers select)."""
        B, init = self.num_envs, self.base_init_state
        pos = env_origins + init[0:3]
        quat = init[3:7].repeat(B, 1)
        lin_vel = init[7:10] + self._uniform((B, 3), -0.5, 0.5)
        ang_vel = init[10:13] + self._uniform((B, 3), -0.5, 0.5)
        dof_pos = self.default_dof_pos * self._uniform((B, self.num_dof), 0.5, 1.5)
        anchor = pos[:, None, :2].expand(B, self.model.ng, 2).clone()
        return PhysState(base_pos=pos, base_quat=quat, joint_pos=dof_pos, base_lin_vel=lin_vel,
                         base_ang_vel=ang_vel, joint_vel=torch.zeros(B, self.num_dof, device=self.device),
                         contact_anchor=anchor)

    def _sample_commands(self, commands, mask):
        """Resample commands for masked envs."""
        B, cr = self.num_envs, self.command_ranges
        new = torch.zeros_like(commands)
        new[:, 0] = self._uniform((B,), *cr["lin_vel_x"])
        new[:, 1] = self._uniform((B,), *cr["lin_vel_y"])
        new[:, 2] = self._uniform((B,), *cr["ang_vel_yaw"])
        small = torch.linalg.norm(new[:, :2], dim=1) > 0.2
        new[:, :2] *= small[:, None]
        return torch.where(mask[:, None], new, commands)

    # ------------------------------------------------------------------ step
    def step(self, state: EnvState, actions: torch.Tensor) -> EnvState:
        """Full RL step: decimated PD physics + post-physics (rewards,
        terminations, resets, observations)."""
        clip_a = self.cfg.normalization.clip_actions
        actions = torch.clamp(actions, -clip_a, clip_a)
        phys, torques, report = self._physics_substeps(state.phys, actions, state.env_params)
        state = state.replace(phys=phys, actions=actions, torques=torques)
        state = self._refresh_derived(state, report)
        return self._post_physics_step(state)

    def _physics_substeps(self, phys: PhysState, actions: torch.Tensor,
                          env_params: EnvPhysParams):
        """Decimation loop (torques recomputed every substep), fused into one
        kernel launch on the card: ``(phys, tau_last, report)``."""
        return self.decimated_step(phys, actions, env_params)

    def _refresh_derived(self, state: EnvState, report: Optional[StepReport] = None) -> EnvState:
        """Base-frame velocities, gravity projection and foot/contact states."""
        phys = state.phys
        grav = torch.tensor([0.0, 0.0, -1.0], device=self.device).expand_as(phys.base_pos)
        upd = dict(base_lin_vel=quat_rotate_inverse(phys.base_quat, phys.base_lin_vel),
                   base_ang_vel=quat_rotate_inverse(phys.base_quat, phys.base_ang_vel),
                   projected_gravity=quat_rotate_inverse(phys.base_quat, grav))
        if report is not None:
            upd.update(foot_positions=report.foot_pos, foot_velocities=report.foot_vel,
                       geom_forces=report.geom_forces)
        return state.replace(**upd)

    def _post_physics_step(self, state: EnvState) -> EnvState:
        state = state.replace(episode_length=state.episode_length + 1)
        resample = (state.episode_length % self.resampling_interval) == 0
        state = state.replace(commands=self._sample_commands(state.commands, resample))

        reset_buf, time_out = self._check_termination(state)
        nan0 = torch.nan_to_num
        state = state.replace(
            reset_buf=reset_buf, time_out_buf=time_out,
            phys=tree_map(nan0, state.phys),
            base_lin_vel=nan0(state.base_lin_vel), base_ang_vel=nan0(state.base_ang_vel),
            projected_gravity=nan0(state.projected_gravity),
            geom_forces=nan0(state.geom_forces), foot_positions=nan0(state.foot_positions),
            foot_velocities=nan0(state.foot_velocities), torques=nan0(state.torques))

        state, rew = self._compute_reward(state)
        state = state.replace(rew=rew, episode_return=state.episode_return + rew)
        state = self._reset_envs(state, reset_buf)
        clip_obs = self.cfg.normalization.clip_observations
        return state.replace(obs=torch.clamp(self._compute_observations(state), -clip_obs, clip_obs))

    def _check_termination(self, state: EnvState) -> Tuple[torch.Tensor, torch.Tensor]:
        if len(self.termination_geoms):
            forces = state.geom_forces[:, self.termination_geoms]
            contact = torch.any(torch.linalg.norm(forces, dim=-1) > 1.0, dim=-1)
        else:
            contact = torch.zeros(self.num_envs, dtype=torch.bool, device=self.device)
        p = state.phys
        finite = (torch.isfinite(p.base_pos).all(-1) & torch.isfinite(p.base_quat).all(-1)
                  & torch.isfinite(p.joint_pos).all(-1) & torch.isfinite(p.base_lin_vel).all(-1)
                  & torch.isfinite(p.joint_vel).all(-1))
        time_out = state.episode_length > self.max_episode_length
        return contact | ~finite | time_out, time_out

    def _reset_envs(self, state: EnvState, mask: torch.Tensor) -> EnvState:
        """Re-draw root/dof states and commands where ``mask`` is set."""
        phys = _where(mask, self._sample_init_phys(state.env_origins), state.phys)
        commands = self._sample_commands(state.commands, mask)
        fmask = mask.to(torch.float32)
        zero = lambda x: torch.where(mask.reshape((-1,) + (1,) * (x.dim() - 1)), torch.zeros_like(x), x)
        return state.replace(
            phys=phys, commands=commands,
            episode_return=state.episode_return * (1.0 - fmask),
            episode_length=torch.where(mask, torch.zeros_like(state.episode_length), state.episode_length),
            last_actions=zero(state.last_actions), last_dof_vel=zero(state.last_dof_vel),
            feet_air_time=zero(state.feet_air_time), feet_contact_time=zero(state.feet_contact_time),
            last_contacts=state.last_contacts & ~mask[:, None],
            episode_sums={k: zero(v) for k, v in state.episode_sums.items()})

    # ------------------------------------------------------------------ obs
    def _compute_observations(self, state) -> torch.Tensor:
        os_ = self.cfg.normalization.obs_scales
        cmd_scale = torch.tensor([os_.lin_vel, os_.lin_vel, os_.ang_vel], device=self.device)
        return torch.cat([
            state.base_lin_vel * os_.lin_vel,
            state.base_ang_vel * os_.ang_vel,
            state.projected_gravity,
            state.commands[:, :3] * cmd_scale,
            (state.phys.joint_pos - self.default_dof_pos) * os_.dof_pos,
            state.phys.joint_vel * os_.dof_vel,
            state.actions,
        ], dim=-1)

    # ------------------------------------------------------------------ rewards
    def _contact_context(self, s):
        """Foot contact and air-time bookkeeping shared by the reward terms."""
        contact = s.geom_forces[:, self.feet_geoms, 2] > 1.0
        contact_filt = contact | s.last_contacts
        return dict(contact=contact, contact_filt=contact_filt,
                    first_contact=(s.feet_air_time > 0.0) & contact_filt,
                    feet_air_time=s.feet_air_time + self.dt,
                    feet_contact_time=s.feet_contact_time + self.dt)

    def _reward_sum(self, s, ctx) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Scaled terms and their sum (with the only-positive clip)."""
        terms = {name: getattr(self, f"_reward_{name}")(s, ctx) * self.reward_scales[j]
                 for j, name in enumerate(self.reward_names)}
        rew = torch.zeros(s.phys.base_pos.shape[0], device=self.device)
        for t in terms.values():
            rew = rew + t
        if self.cfg.rewards.only_positive_rewards:
            rew = rew.clamp(min=0.0)
        return rew, terms

    def _compute_reward(self, state: EnvState) -> Tuple[EnvState, torch.Tensor]:
        ctx = self._contact_context(state)
        state = state.replace(last_contacts=ctx["contact"])
        rew, terms = self._reward_sum(state, ctx)
        sums = {k: v + terms[k] for k, v in state.episode_sums.items()}
        state = state.replace(feet_air_time=ctx["feet_air_time"] * ~ctx["contact_filt"],
                              feet_contact_time=ctx["feet_contact_time"] * ctx["contact_filt"],
                              episode_sums=sums)
        return state, rew

    # --- reward terms the flat sampling-MPC config scales ---
    def _reward_lin_vel_z(self, s, ctx):
        return torch.square(s.base_lin_vel[:, 2])

    def _reward_ang_vel_xy(self, s, ctx):
        return torch.sum(torch.square(s.base_ang_vel[:, :2]), dim=1)

    def _reward_orientation(self, s, ctx):
        return torch.sum(torch.square(s.projected_gravity[:, :2]), dim=1)

    def _reward_torques(self, s, ctx):
        return torch.sum(torch.square(s.torques), dim=1)

    def _reward_dof_acc(self, s, ctx):
        return torch.sum(torch.square((s.last_dof_vel - s.phys.joint_vel) / self.dt), dim=1)

    def _reward_action_rate(self, s, ctx):
        return torch.sum(torch.square(s.last_actions - s.actions), dim=1)

    def _reward_collision(self, s, ctx):
        if not len(self.penalised_geoms):
            return torch.zeros(s.phys.base_pos.shape[0], device=self.device)
        f = s.geom_forces[:, self.penalised_geoms]
        return torch.sum((torch.linalg.norm(f, dim=-1) > 0.1).to(torch.float32), dim=1)

    def _reward_feet_air_time(self, s, ctx):
        rew = torch.sum((ctx["feet_air_time"] - 0.5) * ctx["first_contact"], dim=1)
        return rew * (torch.linalg.norm(s.commands[:, :2], dim=1) > 0.1)

    def _reward_tracking_lin_vel(self, s, ctx):
        err = torch.sum(torch.square(s.commands[:, :2] - s.base_lin_vel[:, :2]), dim=1)
        return torch.exp(-err / self.cfg.rewards.tracking_sigma)

    def _reward_tracking_ang_vel(self, s, ctx):
        err = torch.square(s.commands[:, 2] - s.base_ang_vel[:, 2])
        return torch.exp(-err / self.cfg.rewards.tracking_sigma)
