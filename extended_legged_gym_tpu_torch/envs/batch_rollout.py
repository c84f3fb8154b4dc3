"""Main-rollout batched environments and the sampling-MPC environment
(port of ``envs/batch_rollout.py``).

A rollout batch broadcasts each main env's state over its S samples,
flattens to one batch of E·S envs and plays the candidate control sequences
step by step; each control step is one launch of the fused physics kernel
(or, on the engine route, ``decimation`` calls of the plain engine).  The
main state is never mutated, so nothing needs to be frozen or restored.
Stones ride in the rollout state and are stepped with the robot, so the
candidates anticipate stone contact.

``differentiable=True`` plays the batch on the plain engine instead, so that
autograd (the gradient polish) and forward-mode Jacobians (the iLQR polish,
``trajopt/riccati.py``) flow through it; the diffusion sweep, the fd polish
and the iLQR's node-level scoring keep the kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..models.networks import ActorCritic, inference_policy, load_jax_checkpoint
from ..physics.engine import EnvPhysParams, PhysState
from ..terrain.dynamic_obstacles import StoneState
from ..trajopt.riccati import ilqr_solve_batched, make_flattener
from ..trajopt.sampling import TrajGradSampling, TrajOptConfig
from ..utils.config import configclass
from ..utils.math import quat_rotate_inverse
from ..utils.tracing import span
from ..utils.tree import tree_flatten, tree_map
from .legged_robot import EnvState, LeggedRobot
from .legged_robot_config import LeggedRobotCfg


@configclass
class TrajectoryOptCfg:
    # all fields of the JAX config, so the dict an artifact records
    # (GAIT_*.json "trajectory_opt") compares one to one; the port reads all
    # but enable_traj_opt and compute_predictions
    enable_traj_opt: bool = True
    num_diffuse_steps: int = 2
    num_diffuse_steps_init: int = 10
    num_samples: int = 127
    temp_sample: float = 0.1
    horizon_samples: int = 16
    horizon_nodes: int = 4
    horizon_diffuse_factor: float = 0.9
    traj_diffuse_factor: float = 0.5
    noise_scaling: float = 1.5
    update_method: str = "avwbfo"
    gamma: float = 1.0
    interp_method: str = "spline"
    compute_predictions: bool = True
    # refinement after the diffusion sweep:
    # "fd"       = normalized-gradient ascent with a batched central-difference
    #              gradient through the fast (kernel) rollout,
    # "gradient" = the same ascent with the exact gradient, autograd through
    #              the plain engine,
    # "ilqr"     = time-varying LQR (Riccati) sweeps on the plain engine's
    #              linearizations, regularized from ilqr_reg
    polish_iters: int = 0
    polish_method: str = "fd"
    polish_lr: float = 0.05
    polish_fd_eps: float = 0.05
    ilqr_reg: float = 1.0


@configclass
class RLWarmstartCfg:
    policy_checkpoint: str = ""
    actor_hidden_dims: list = [128, 64, 32]
    critic_hidden_dims: list = [128, 64, 32]
    activation: str = "elu"
    use_for_append: bool = True
    # re-seed a main env's plan from the warm-start policy when it tips past
    # the uprightness threshold or resets
    refresh_on_near_fall: bool = True
    near_fall_upright: float = -0.9


@configclass
class RobotBatchRolloutCfg(LeggedRobotCfg):
    pass


@configclass
class RobotTrajGradSamplingCfg(RobotBatchRolloutCfg):
    trajectory_opt: TrajectoryOptCfg = TrajectoryOptCfg()
    rl_warmstart: RLWarmstartCfg = RLWarmstartCfg()


@dataclass
class RolloutState:
    """What a rollout env carries while playing a candidate sequence.  Field
    names match EnvState so the env's reward terms read both."""

    phys: PhysState
    commands: torch.Tensor
    actions: torch.Tensor
    last_actions: torch.Tensor
    last_dof_vel: torch.Tensor
    torques: torch.Tensor
    feet_air_time: torch.Tensor
    feet_contact_time: torch.Tensor
    last_contacts: torch.Tensor
    base_lin_vel: torch.Tensor
    base_ang_vel: torch.Tensor
    projected_gravity: torch.Tensor
    foot_positions: torch.Tensor
    foot_velocities: torch.Tensor
    geom_forces: torch.Tensor
    reset_buf: torch.Tensor
    t: torch.Tensor              # rollout time [s]
    stones: Optional[StoneState] = None
    measured_heights: Optional[torch.Tensor] = None  # [B, P] under the height scan

    def replace(self, **changes) -> "RolloutState":
        return dataclasses.replace(self, **changes)


def _repeat_samples(x: torch.Tensor, S: int) -> torch.Tensor:
    """[E, ...] -> [E·S, ...], each env repeated S times in a row."""
    return x.repeat_interleave(S, dim=0)


class RobotBatchRollout(LeggedRobot):
    """LeggedRobot plus rollout batches.  ``num_envs`` counts main envs."""

    def main_to_rollout(self, state: EnvState) -> RolloutState:
        return RolloutState(
            phys=state.phys, commands=state.commands, actions=state.actions,
            last_actions=state.last_actions, last_dof_vel=state.last_dof_vel,
            torques=state.torques, feet_air_time=state.feet_air_time,
            feet_contact_time=state.feet_contact_time, last_contacts=state.last_contacts,
            base_lin_vel=state.base_lin_vel, base_ang_vel=state.base_ang_vel,
            projected_gravity=state.projected_gravity, foot_positions=state.foot_positions,
            foot_velocities=state.foot_velocities, geom_forces=state.geom_forces,
            reset_buf=torch.zeros_like(state.reset_buf),
            t=state.episode_length.to(torch.float32) * self.dt, stones=state.stones,
            measured_heights=state.measured_heights)

    @span("rollout.step")
    def rollout_step(self, rs: RolloutState, actions: torch.Tensor,
                     env_params: EnvPhysParams, differentiable: bool = False
                     ) -> Tuple[RolloutState, torch.Tensor]:
        """One control step of a rollout env: decimated physics + reward; no
        resets, pushes or command resampling."""
        clip_a = self.cfg.normalization.clip_actions
        actions = torch.clamp(actions, -clip_a, clip_a)
        with span("env.physics"):
            phys, torques, report, _ = self._physics_substeps(rs.phys, actions, env_params,
                                                              rs.last_dof_vel,
                                                              differentiable=differentiable)
        with span("rollout.derived"):
            grav = torch.tensor([0.0, 0.0, -1.0], dtype=phys.base_pos.dtype,
                                device=self.device).expand_as(phys.base_pos)
            rs = rs.replace(
                phys=phys, actions=actions, torques=torques,
                base_lin_vel=quat_rotate_inverse(phys.base_quat, phys.base_lin_vel),
                base_ang_vel=quat_rotate_inverse(phys.base_quat, phys.base_ang_vel),
                projected_gravity=quat_rotate_inverse(phys.base_quat, grav),
                foot_positions=report.foot_pos, foot_velocities=report.foot_vel,
                geom_forces=report.geom_forces, t=rs.t + self.dt)
        if self.obstacle_cfg is not None and rs.stones is not None:
            with span("env.obstacles"):
                phys, gf, stones = self._apply_obstacles(rs.phys, rs.foot_positions,
                                                         rs.foot_velocities, rs.geom_forces,
                                                         rs.stones)
            rs = rs.replace(phys=phys, geom_forces=gf, stones=stones)
        if self.num_height_points:
            with span("env.heights"):
                rs = rs.replace(measured_heights=self._get_heights(rs.phys))
        with span("rollout.reward"):
            if len(self.termination_geoms):
                forces = rs.geom_forces[:, self.termination_geoms]
                rs = rs.replace(reset_buf=torch.any(torch.linalg.norm(forces, dim=-1) > 1.0,
                                                    dim=-1))
            rs, rew = self._compute_rollout_reward(rs)
            return rs.replace(last_actions=rs.actions, last_dof_vel=rs.phys.joint_vel), rew

    def _compute_rollout_reward(self, rs: RolloutState) -> Tuple[RolloutState, torch.Tensor]:
        ctx = self._contact_context(rs)
        rs = rs.replace(last_contacts=ctx["contact"])
        rew, _ = self._reward_sum(rs, ctx)
        rs = rs.replace(feet_air_time=ctx["feet_air_time"] * ~ctx["contact_filt"],
                        feet_contact_time=ctx["feet_contact_time"] * ctx["contact_filt"])
        return rs, rew

    @span("rollout")
    def rollout_batch(self, state: EnvState, all_us: torch.Tensor,
                      differentiable: bool = False) -> torch.Tensor:
        """Per-step rewards ``[E, S, H+1]`` of S candidate control sequences
        ``all_us`` ``[E, S, H+1, A]`` per main env (on the plain engine, so
        that derivatives flow, with ``differentiable``)."""
        E, S, H1, A = all_us.shape
        rs = tree_map(lambda x: _repeat_samples(x, S), self.main_to_rollout(state))
        ep = tree_map(lambda x: _repeat_samples(x, S), state.env_params)
        us = all_us.reshape(E * S, H1, A)
        rews = []
        for t in range(H1):
            rs, rew = self.rollout_step(rs, us[:, t], ep, differentiable=differentiable)
            rews.append(rew)
        return torch.stack(rews, dim=1).reshape(E, S, H1)


class RobotTrajGradSampling(RobotBatchRollout):
    """Sampling-MPC environment: batch-rollout env + trajectory optimizer."""

    def __init__(self, cfg: RobotTrajGradSamplingCfg, **kw):
        super().__init__(cfg, **kw)
        to = cfg.trajectory_opt
        if to.polish_iters > 0 and to.polish_method not in ("fd", "gradient", "ilqr"):
            raise ValueError(f"unknown polish_method {to.polish_method!r}: 'fd', 'gradient' "
                             f"or 'ilqr'")
        self.traj_opt_cfg = TrajOptConfig(
            num_samples=to.num_samples, temp_sample=to.temp_sample,
            horizon_samples=to.horizon_samples, horizon_nodes=to.horizon_nodes,
            num_diffuse_steps=to.num_diffuse_steps,
            num_diffuse_steps_init=to.num_diffuse_steps_init,
            horizon_diffuse_factor=to.horizon_diffuse_factor,
            traj_diffuse_factor=to.traj_diffuse_factor, noise_scaling=to.noise_scaling,
            update_method=to.update_method, gamma=to.gamma, interp_method=to.interp_method)
        self.traj_sampler = TrajGradSampling(self.traj_opt_cfg, self.num_envs, self.num_actions,
                                             device=self.device)
        self.rl_policy = None

    # ---- RL warm start ----
    def setup_rl_warmstart(self, checkpoint: Optional[str] = None):
        """Load the warm-start actor: a reference rsl_rl ``.pt`` (bridged to
        the engine's DOF order, ``rl/torch_compat.py``) or a ``.pkl`` of the
        JAX runner or the port's."""
        ws = self.cfg.rl_warmstart
        path = checkpoint or ws.policy_checkpoint
        if path.endswith(".pt"):
            from ..rl.torch_compat import load_reference_policy

            self.rl_net, _, self.rl_policy = load_reference_policy(
                path, self.num_obs, self.num_actions, tuple(ws.actor_hidden_dims), ws.activation,
                our_joint_names=self.model.joint_names, device=self.device)
            return self.rl_policy
        net = ActorCritic(self.num_obs, self.num_actions, tuple(ws.actor_hidden_dims),
                          tuple(ws.critic_hidden_dims), ws.activation)
        state_dict, obs_norm = load_jax_checkpoint(path)
        net.load_state_dict(state_dict)
        net = net.to(self.device).eval()
        policy = inference_policy(net, obs_norm)
        self.rl_net, self.rl_policy = net, policy
        return policy

    def init_trajectories_from_rl(self, state: EnvState) -> torch.Tensor:
        """Node trajectories fitted to the warm-start policy's rollout from the
        current main state."""
        if self.rl_policy is None:
            raise RuntimeError("call setup_rl_warmstart first")
        rs = self.main_to_rollout(state)
        acts = []
        for _ in range(self.traj_opt_cfg.horizon_samples + 1):
            a = self.rl_policy(self._compute_observations(rs))
            rs, _ = self.rollout_step(rs, a, state.env_params)
            acts.append(a)
        return self.u2node_batch(torch.stack(acts, dim=1))

    def node2u_batch(self, nodes):
        return self.traj_sampler.node2u(nodes)

    def u2node_batch(self, us):
        return self.traj_sampler.u2node(us)

    def optimize_all_trajectories(self, state: EnvState, nodes: torch.Tensor,
                                  generator: Optional[torch.Generator] = None,
                                  initial: bool = False, n_diffuse: Optional[int] = None,
                                  noise: Optional[torch.Tensor] = None):
        """Diffuse the node trajectories against rollouts from the current main
        state, then polish them (``trajectory_opt.polish_method``).  ``noise``
        injects the sampling draws."""
        if n_diffuse is None:
            n_diffuse = (self.traj_opt_cfg.num_diffuse_steps_init if initial
                         else self.traj_opt_cfg.num_diffuse_steps)
        rollout_fn = lambda all_us: self.rollout_batch(state, all_us)
        nodes, info = self.traj_sampler.optimize(
            nodes, rollout_fn, n_diffuse, generator=generator or self.generator, noise=noise)
        to = self.cfg.trajectory_opt
        if to.polish_iters > 0:
            if to.polish_method == "ilqr":
                nodes, pinfo = self.polish_riccati(state, nodes, to.polish_iters)
            elif to.polish_method == "fd":
                nodes, pinfo = self.traj_sampler.polish_fd(nodes, rollout_fn, to.polish_iters,
                                                           to.polish_lr, eps=to.polish_fd_eps)
            else:
                diff_fn = lambda all_us: self.rollout_batch(state, all_us, differentiable=True)
                nodes, pinfo = self.traj_sampler.polish(nodes, diff_fn, to.polish_iters,
                                                        to.polish_lr)
            info = dict(info, **pinfo)
        return nodes, info

    # ---- Riccati / iLQR refinement ----
    @staticmethod
    def _rollout_dyn_split(rs: RolloutState) -> Dict[str, object]:
        """The fields a rollout step propagates (the iLQR state); the rest
        (commands, and what each step recomputes from ``phys``: torques,
        body-frame velocities, foot and contact states) is context."""
        return {f: getattr(rs, f) for f in ("phys", "last_actions", "last_dof_vel",
                                            "feet_air_time", "feet_contact_time",
                                            "last_contacts", "t")}

    def ilqr_problem(self, state: EnvState):
        """``(step_fn, x0, ctx)`` of the iLQR over the rollout dynamics from
        the main ``state``: ``step_fn(x [N, n], u [N, A], ctx_rows)`` is one
        differentiable rollout control step of the flat states ``x``
        (:func:`make_flattener` over :meth:`_rollout_dyn_split`), ``x0``
        ``[E, n]``, ``ctx`` the per-env rollout state and physics
        parameters."""
        rs0 = self.main_to_rollout(state)
        dyn0 = self._rollout_dyn_split(rs0)
        leaves, rebuild = tree_flatten(dyn0)
        flatten, unflatten, _ = make_flattener(rebuild([l[0] for l in leaves]))

        def step_fn(x, u, ctx):
            rs_ctx, ep = ctx
            rs_n, rew = self.rollout_step(rs_ctx.replace(**unflatten(x)), u, ep,
                                          differentiable=True)
            return flatten(self._rollout_dyn_split(rs_n)), rew

        return step_fn, flatten(dyn0), (rs0, state.env_params)

    @span("mpc.polish")
    def polish_riccati(self, state: EnvState, nodes: torch.Tensor,
                       n_iters: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Refine the mean node trajectories by batched time-varying LQR
        sweeps over the plain engine's linearizations, then project back to
        nodes (node 0 pinned).  Monotone at the node level: the projection
        is kept per env only where it scores better than the incumbent on
        the fast rollout (the spline projection of an iLQR-optimal dense
        sequence can lose the gain)."""
        to = self.cfg.trajectory_opt
        with torch.no_grad():
            step_fn, x0, ctx = self.ilqr_problem(state)
            us_opt, ilqr_info = ilqr_solve_batched(step_fn, x0, self.node2u_batch(nodes),
                                                   ctx=ctx, n_iters=n_iters,
                                                   reg_init=to.ilqr_reg)
            new_nodes = self.u2node_batch(us_opt)
            new_nodes[:, 0] = nodes[:, 0]
            disc = self.traj_sampler._disc()
            score = lambda nds: torch.sum(
                self.rollout_batch(state, self.node2u_batch(nds)[:, None])[:, 0] * disc, dim=-1)
            J_old, J_new = score(nodes), score(new_nodes)
            nodes = torch.where((J_new > J_old)[:, None, None], new_nodes, nodes)
        return nodes, dict(polish_gain=(J_new - J_old).clamp(min=0.0).mean(),
                           ilqr_accept=ilqr_info.improved.mean())

    def shift_trajectory_batch(self, nodes: torch.Tensor,
                               append_action: Optional[torch.Tensor] = None):
        return self.traj_sampler.shift(nodes, 1, append_action)

    @span("mpc.step")
    def mpc_step(self, state: EnvState, nodes: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 n_diffuse: Optional[int] = None) -> Tuple[EnvState, torch.Tensor, Dict]:
        """One MPC cycle: optimize -> execute the first action -> shift (tail
        from the warm-start policy), re-seeding tipping or reset envs."""
        with span("mpc.optimize"):
            nodes, info = self.optimize_all_trajectories(state, nodes, generator,
                                                         n_diffuse=n_diffuse)
        state = self.step(state, self.node2u_batch(nodes)[:, 0])
        with span("mpc.shift"):
            append = None
            if self.rl_policy is not None and self.cfg.rl_warmstart.use_for_append:
                append = self.rl_policy(state.obs)
            nodes = self.shift_trajectory_batch(nodes, append_action=append)
        if self.rl_policy is not None and self.cfg.rl_warmstart.refresh_on_near_fall:
            with span("mpc.refresh"):
                near = ((state.projected_gravity[:, 2] > self.cfg.rl_warmstart.near_fall_upright)
                        | state.reset_buf)
                if bool(near.any()):
                    nodes = torch.where(near[:, None, None], self.init_trajectories_from_rl(state),
                                        nodes)
        return state, nodes, info
