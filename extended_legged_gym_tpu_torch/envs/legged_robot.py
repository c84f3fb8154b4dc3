"""Legged-robot environment (port of ``envs/legged_robot.py``): flat ground,
generated heightfields, confined (ground + ceiling) and OBJ terrains, and
passive stone obstacles.

The env object holds static configuration (model, terrain, index sets,
reward table) and the env's random generator; ``reset_all`` and ``step`` map
an :class:`EnvState` of ``[B, ...]`` tensors to a new one, as the JAX env's
pure functions do.  Physics runs through the fused decimated step
(``ops/physics_kernel.py``): the CUDA kernel on the card (B1 on flat ground,
B2 on a heightfield), its plain version on the CPU.  Under V control the
torques depend on the control step's ``last_dof_vel`` and are computed here
once per substep, each substep one launch of the same kernel
(``make_env_step`` / ``make_env_step_rough``).  With the actuator network
(``control.use_actuator_network``) each substep's torques come from the
ANYdrive LSTM, whose hidden state advances per substep and rides in the
state (``actuator_hidden``), and each substep is one launch of the same
torques-in route; the JAX env takes this path off its fused kernel onto the
ABA engine, which the port's kernel follows.

The engine route: on a terrain with a ceiling (``has_ceiling``: confined and
OBJ terrains) or with contacts on its triangle mesh
(``terrain.trimesh_contacts``) the JAX env steps its plain XLA engine, since
its fused kernel has no ceiling branch and its tangent-plane contact scheme
assumes mostly vertical normals.  The port chooses the same scenes by the
same predicate at construction and steps them with
``physics/engine.EngineEnvStep``: each substep's torques computed here (P,
V, T or the actuator network), then one plain ABA step
(``EngineEnvStep.engine_substeps`` counts them).  A model with a prismatic
joint takes the same route on any terrain: the kernel has no prismatic
branch (nor has the JAX package's Pallas body, through which the JAX env
still sends such a model on a TPU).  The kernel routes never
give way to it: a kernel that fails to build or launch raises.  The
gradient and iLQR polish ask for the same route on any scene with
``differentiable=True``, since autograd and forward-mode derivatives flow
through the plain engine and not through a kernel.

``sim.solver`` chooses as the JAX env's does: ``"pallas"`` (the default) the
kernel routes above; ``"aba"`` or ``"crba"`` the engine route on any scene
and device, with that solver.  ``"pallas_interpret"``, the JAX tests' Pallas
interpreter, raises: the port's CPU always runs the kernel's plain version.
``sim.enforce_dof_vel_limits`` (the joint velocity clamp at the model's
limits, else at +-500 rad/s) and ``asset.armature`` (every joint's armature
in place of the model's, where non-zero) reach every route, the kernels
through their tables.

Semantics kept from the JAX env, reference quirks included:
* observation layout [lin vel, ang vel, projected gravity, commands, dof pos,
  dof vel, actions] with scales and clipping;
* rewards: per-term scales × dt, ``only_positive_rewards`` clip, then the
  ``termination`` term (scaled by dt, never staged, with its own episode
  sum) added after the clip;
* terminations: contact force > 1 N on a termination geom, non-finite state,
  or timeout; non-finite values are replaced by ``nan_to_num``;
* resets re-draw dof pos in [0.5, 1.5]×default, root velocities in ±0.5
  (zero on a fixed base, ``asset.fix_base_link``) and commands;
* the main env never updates ``last_actions`` / ``last_dof_vel`` after a
  reset (they stay zero, as in the JAX env); rollouts update them each step;
* on ``heightfield`` / ``trimesh`` terrains (both contact the generated
  heightfield): the curriculum grid of ``terrain/generator.py``, envs spawned
  on their (level, type) origins with a ±0.5 m xy offset, the spawn levels
  drawn from the generator's numpy stream right after the grid, the height
  scan (``measure_heights``) under the yaw-rotated grid of measured points,
  appended to the observation as ``clip(z - 0.5 - h, -1, 1)`` times its scale;
* terrain-curriculum promotion at reset (``curriculum`` without
  ``freeze_terrain_levels``): an env that walked more than half a subterrain
  from its origin moves up a level, one that walked less than half its
  commanded distance moves down; past the top row it gets a uniform level,
  and its new origin is set before its initial state is drawn;
* ray observations (``raycaster.enable_raycast`` builds the caster,
  ``attach_to_obs`` appends its normalized inverse distances to the
  observation after the height scan; they carry no noise);
* staged reward scales (``multi_stage_rewards``), selected by the state's
  ``reward_stage``;
* the actuator network's hidden state is zeroed for the envs that reset,
  after the step (it is not re-drawn);
* domain randomization drawn once per env at ``reset_all`` and kept for the
  env's lifetime: friction from 64 buckets in ``friction_range``, the base
  mass delta uniform in ``added_mass_range`` (both reach the kernel through
  ``EnvPhysParams``);
* pushes: every ``push_interval`` control steps of the global
  ``common_step`` counter the world-frame xy base velocity is overwritten
  with U(+-``max_push_vel_xy``), after the derived body-frame velocities were
  computed (so this step's observation and reward see the unpushed values);
* observation noise ``(2u - 1) * noise_scale_vec`` added before the clip, in
  ``step`` only;
* ``episode_metrics``: scalar sums over the episodes that ended (count,
  return, length and each term's sum over ``max_episode_length_s``), read and
  cleared by the runner;
* privileged observations (``env.num_privileged_obs``): after each step the
  noise-free observation, cut or zero-padded to that width and clipped, in
  ``EnvState.privileged_obs`` (zeros after ``reset_all``; ``None`` without);
* confined terrains (``confined_trimesh`` / ``confined_heightfield``): the
  curriculum grid of ``terrain/confined.py`` with its wall-corrected mesh
  attached, spawned like a generated terrain; ``obj``: the rasterized layers
  of ``terrain.terrain_file`` with its mesh, spawned on the plane's grid;
  ``terrain.trimesh_contacts`` needs a terrain with a mesh (ValueError);
* stones (``obstacle_gen.enable_obstacles``): spawned around each robot at
  ``reset_all`` and re-spawned for the envs that reset; after each step's
  physics the robot's base and feet spheres exchange penalty forces with
  them (the forces are added to those geoms' ``geom_forces`` rows, and
  their sum kicks the base velocity by ``F·dt / total mass``), then the
  stones take ``decimation`` substeps on the heightfield.

The env draws from its own ``torch.Generator``; each kind of draw in a step
has its own method (``_draw_push_vel``, ``_draw_obs_noise``,
``_draw_random_levels``, ``_draw_spawn_offset``, ``_draw_stones``,
``_draw_commands``), so a test can inject the JAX env's draws.

Command options:
* ``commands.heading_command``: a resample draws a heading into column 3 in
  place of the yaw rate, and every step sets column 2 to the yaw-rate P law
  ``clip(0.5 * wrap_to_pi(heading_cmd - heading), -1, 1)`` of the base's
  heading, after the resample (an env that resets keeps the zero its new
  commands carry in column 2 until its next step);
* ``commands.curriculum``: at a step whose ``common_step`` is a multiple of
  ``max_episode_length`` and in which some env resets, if the resetting
  envs' ``tracking_lin_vel`` episode sums average more than 0.8 of the
  term's scale per step, the lin-vel-x range (``EnvState.
  command_lin_vel_x_range``) widens by 0.5 each way, up to
  ``max_curriculum``; the resets draw from the new range.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.actuator_net import ActuatorNetLSTM
from ..ops.physics_kernel import make_decimated_env_step, make_env_step, make_env_step_rough
from ..perception.raycast import RayCaster
from ..physics.contact import default_contact_params
from ..physics.engine import (EngineEnvStep, EnvPhysParams, PhysState, StepReport,
                              default_sim_params)
from ..physics.model import RobotModel, geom_indices_matching
from ..physics.serialize import load_model
from ..terrain.confined import TerrainConfined
from ..terrain.dynamic_obstacles import (DynamicObstacleConfig, StoneDraws, StoneState,
                                         draw_stones, reset_stones, step_stones,
                                         stone_robot_forces, stones_from_draws)
from ..terrain.generator import Terrain
from ..terrain.heightfield import TerrainData, flat_terrain, sample_height
from ..terrain.mesh import TerrainObj
from ..utils.config import class_to_dict
from ..utils.device import resolve_device
from ..utils.math import quat_apply_yaw, quat_rotate, quat_rotate_inverse, wrap_to_pi
from ..utils.tracing import span
from ..utils.tree import tree_map
from .legged_robot_config import UNREAD_ENV_FIELDS, LeggedRobotCfg, refuse_unread


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
    common_step: torch.Tensor        # scalar int64, control steps since reset_all (pushes)
    episode_metrics: Dict[str, torch.Tensor]  # scalar sums over finished episodes
    measured_heights: Optional[torch.Tensor] = None  # [B, P] terrain under the height scan
    terrain_levels: Optional[torch.Tensor] = None    # [B] int64
    terrain_types: Optional[torch.Tensor] = None     # [B] int64
    reward_stage: Optional[torch.Tensor] = None      # scalar int64 (staged rewards)
    actuator_hidden: Optional[Tuple[torch.Tensor, torch.Tensor]] = None  # (h, c) [B, nj, L, H]
    privileged_obs: Optional[torch.Tensor] = None    # [B, num_privileged_obs]
    # EMA-filtered base-frame accelerations and the last step's world root
    # velocities (kept by the envs that read them: robots/anymal_c_variants.py)
    base_lin_acc: Optional[torch.Tensor] = None      # [B, 3]
    base_ang_acc: Optional[torch.Tensor] = None      # [B, 3]
    last_root_vel: Optional[torch.Tensor] = None     # [B, 6]
    stones: Optional[StoneState] = None              # [B, M] passive stones
    command_lin_vel_x_range: Optional[torch.Tensor] = None  # [2] (commands.curriculum)

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)


def _where(mask: torch.Tensor, new, old):
    """Per-env select over matching tensor trees."""
    return tree_map(lambda n, o: torch.where(mask.reshape((-1,) + (1,) * (o.dim() - 1)), n, o),
                    new, old)


class LeggedRobot:
    """Static env object with ``reset_all`` / ``step`` over :class:`EnvState`.

    ``model`` and ``terrain``, where given, take the place of the ones the
    config names (``asset.file``, ``terrain.mesh_type``), as in the JAX env;
    an injected terrain gives the envs the plane's grid of origins."""

    def __init__(self, cfg: LeggedRobotCfg, model: Optional[RobotModel] = None,
                 terrain: Optional[TerrainData] = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self._check_supported(cfg)
        self.num_envs = cfg.env.num_envs
        self.num_actions = cfg.env.num_actions
        self.num_obs = cfg.env.num_observations
        self.num_privileged_obs = cfg.env.num_privileged_obs
        self.dt = cfg.control.decimation * cfg.sim.dt
        self.max_episode_length_s = cfg.env.episode_length_s
        self.max_episode_length = int(np.ceil(self.max_episode_length_s / self.dt))

        if model is None:
            model = load_model(cfg.asset.file)
        if cfg.asset.armature:
            model = dataclasses.replace(model, _tensors={}, armature=np.full(
                model.nj, cfg.asset.armature, np.float32))
        if cfg.asset.fix_base_link and not model.fix_base:
            model = dataclasses.replace(model, _tensors={}, fix_base=True)
        self.model = model
        self.num_dof = model.nj
        tc = cfg.terrain
        self.terrain_gen = None
        if terrain is not None:
            self.terrain = terrain
        elif tc.mesh_type in ("heightfield", "trimesh"):
            self.terrain_gen = Terrain(tc, self.num_envs, seed=cfg.seed)
            self.terrain = self.terrain_gen.to_device(tc.static_friction)
        elif tc.mesh_type in ("confined_trimesh", "confined_heightfield"):
            self.terrain_gen = TerrainConfined(tc, self.num_envs, seed=cfg.seed)
            self.terrain = self.terrain_gen.to_device(tc.static_friction)
        elif tc.mesh_type == "obj":
            self.terrain = TerrainObj(tc.terrain_file, hscale=tc.horizontal_scale).to_device()
        else:
            self.terrain = flat_terrain(friction=tc.static_friction)
        self.custom_origins = self.terrain_gen is not None
        if tc.trimesh_contacts:
            if self.terrain.trimesh is None:
                raise ValueError(f"terrain.trimesh_contacts=True (triangle-mesh contacts) needs a "
                                 f"terrain with a triangle mesh; mesh_type {tc.mesh_type!r} "
                                 f"builds none")
            self.terrain = self.terrain.replace(contact_trimesh=True)

        self.sim_params = default_sim_params(
            dt=cfg.sim.dt, gravity=tuple(cfg.sim.gravity),
            contact=default_contact_params(kp=cfg.sim.contact_kp, kd=cfg.sim.contact_kd,
                                           kt=cfg.sim.contact_kt,
                                           kt_spring=cfg.sim.contact_kt_spring),
            joint_damping=cfg.sim.joint_damping,
            solver=cfg.sim.solver,
            enforce_dof_vel_limits=cfg.sim.enforce_dof_vel_limits)

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

        # stones: the robot's coupling spheres are the base geom and the feet
        self.obstacle_cfg = None
        if cfg.obstacle_gen.enable_obstacles:
            og = cfg.obstacle_gen
            self.obstacle_cfg = DynamicObstacleConfig(
                enable=True, min_stones=og.min_obstacles, max_stones=og.max_obstacles,
                spawn_height_range=list(og.spawn_height_range),
                spawn_radius_range=list(og.spawn_radius_range),
                density_range=list(og.stone_density_range),
                friction_range=list(og.stone_friction_range),
                restitution_range=list(og.stone_restitution_range),
                cluster_probability=og.cluster_probability)
            base_geoms = np.where(np.asarray(model.geom_body) == 0)[0]
            self._base_geom = int(base_geoms[0]) if len(base_geoms) else 0
            base_r = float(model.geom_radius[self._base_geom]) if len(base_geoms) else 0.3
            self._obstacle_sphere_radius = torch.as_tensor(np.concatenate(
                [[base_r], np.asarray(model.geom_radius)[np.asarray(model.foot_geom)]]
            ).astype(np.float32), device=self.device)
            self._total_mass = float(np.asarray(model.mass).sum())

        # height scan points [P, 2] in the base's yaw frame
        if cfg.terrain.measure_heights:
            gx, gy = np.meshgrid(cfg.terrain.measured_points_x, cfg.terrain.measured_points_y,
                                 indexing="ij")
            pts = np.stack([gx.ravel(), gy.ravel()], axis=-1).astype(np.float32)
        else:
            pts = np.zeros((0, 2), np.float32)
        self.height_points = torch.as_tensor(pts, device=self.device)
        self.num_height_points = pts.shape[0]

        self.raycaster = (RayCaster(cfg.raycaster, self.terrain, self.device)
                          if cfg.raycaster.enable_raycast else None)

        # joint soft limits (the dof_pos_limits term)
        lim = np.asarray(model.dof_pos_limits, np.float32)
        mid, rng_ = (lim[:, 0] + lim[:, 1]) / 2, lim[:, 1] - lim[:, 0]
        soft = cfg.rewards.soft_dof_pos_limit
        self.dof_pos_soft_limits = torch.as_tensor(
            np.stack([mid - 0.5 * rng_ * soft, mid + 0.5 * rng_ * soft], axis=1), device=self.device)

        self._init_env_origins()

        rng = cfg.commands.ranges
        self.command_ranges = {k: tuple(float(x) for x in getattr(rng, k))
                               for k in ("lin_vel_x", "lin_vel_y", "ang_vel_yaw", "heading")}
        self.resampling_interval = int(np.clip(cfg.commands.resampling_time / self.dt, 1,
                                               np.iinfo(np.int32).max))
        self.push_interval = max(1, int(cfg.domain_rand.push_interval_s / self.dt))
        self._prepare_reward_functions()
        self.noise_scale_vec = torch.as_tensor(self._make_noise_scale_vec(), device=self.device)

        self.actuator_net = (ActuatorNetLSTM.from_json(cfg.control.actuator_net_file, self.device)
                             if cfg.control.use_actuator_network and cfg.control.actuator_net_file
                             else None)
        # sim.solver "aba" or "crba", a ceiling, mesh contacts or a prismatic
        # joint: the plain engine, one call per substep; else the kernels
        # (sim.solver "pallas"): P and T control with torques and substeps
        # fused in one launch per control step, V control and the actuator
        # network one launch per substep with the torques passed in
        self.decimated_step = self.substep = self.engine_step = None
        if (cfg.sim.solver != "pallas" or self.terrain.has_ceiling
                or self.terrain.contact_trimesh or model.has_prismatic):
            self.engine_step = EngineEnvStep(model, self.sim_params, self.terrain)
        elif cfg.control.control_type == "V" or self.actuator_net is not None:
            self.substep = (make_env_step(model, self.sim_params, self.terrain.height00,
                                          self.terrain.friction)
                            if self.terrain.is_flat
                            else make_env_step_rough(model, self.sim_params, self.terrain))
        else:
            self.decimated_step = make_decimated_env_step(
                model, self.sim_params, self.terrain, cfg.control.decimation, p_gains, d_gains,
                model.default_dof_pos, cfg.control.action_scale,
                control_type=cfg.control.control_type)
        # the differentiable route (autograd and forward mode through the
        # plain engine, asked for by the gradient and iLQR polish)
        self.grad_step = self.engine_step or EngineEnvStep(model, self.sim_params, self.terrain)

        T = model.torch(self.device)
        self.default_dof_pos = T["default_dof_pos"]
        self.torque_limits = T["torque_limits"]
        self.p_gains_t = torch.as_tensor(p_gains, device=self.device)
        self.d_gains_t = torch.as_tensor(d_gains, device=self.device)
        self.base_init_state = torch.tensor(
            list(cfg.init_state.pos) + list(cfg.init_state.rot)
            + list(cfg.init_state.lin_vel) + list(cfg.init_state.ang_vel),
            dtype=torch.float32, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)

    @staticmethod
    def _check_supported(cfg: LeggedRobotCfg):
        tc = cfg.terrain
        unsupported = {
            f"terrain.mesh_type {tc.mesh_type!r}": tc.mesh_type not in (
                "plane", "none", "heightfield", "trimesh", "confined_trimesh",
                "confined_heightfield", "obj"),
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(f"not ported yet: {', '.join(bad)}")
        if cfg.sim.solver == "pallas_interpret":
            raise ValueError("sim.solver 'pallas_interpret' runs the JAX package's Pallas kernel "
                             "in its interpreter; the port has none: on the CPU, sim.solver "
                             "'pallas' always runs the kernel's plain version")
        if cfg.sim.solver not in ("pallas", "aba", "crba"):
            raise ValueError(f"unknown sim.solver {cfg.sim.solver!r}: 'pallas', 'aba' or 'crba'")
        refuse_unread(cfg, UNREAD_ENV_FIELDS)

    def _init_env_origins(self):
        """Spawn origins: on a generated terrain, (level, type) cells, the
        levels drawn from the generator's stream right after the grid; on a
        plane, a centred square grid."""
        if self.custom_origins:
            tg = self.terrain_gen
            max_init = min(self.cfg.terrain.max_init_terrain_level, tg.num_rows - 1)
            levels = tg.rng.randint(0, max_init + 1, self.num_envs)
            types = np.arange(self.num_envs) % tg.num_cols
            self.terrain_origins = torch.as_tensor(np.asarray(tg.env_origins, np.float32),
                                                   device=self.device)
            self.max_terrain_level = tg.num_rows
        else:
            n = int(np.ceil(np.sqrt(self.num_envs)))
            xx, yy = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
            origins = np.zeros((self.num_envs, 3), np.float32)
            origins[:, 0] = self.cfg.env.env_spacing * xx.ravel()[: self.num_envs]
            origins[:, 1] = self.cfg.env.env_spacing * yy.ravel()[: self.num_envs]
            origins[:, :2] -= origins[:, :2].mean(axis=0, keepdims=True)
            self.grid_origins = torch.as_tensor(origins, device=self.device)
            levels = types = np.zeros(self.num_envs)
        self.init_terrain_levels = torch.as_tensor(levels, dtype=torch.int64, device=self.device)
        self.init_terrain_types = torch.as_tensor(types, dtype=torch.int64, device=self.device)

    def _compute_env_origins(self, levels: torch.Tensor, types: torch.Tensor) -> torch.Tensor:
        if self.custom_origins:
            return self.terrain_origins[levels, types]
        return self.grid_origins

    def _prepare_reward_functions(self):
        """Active terms (non-zero at some stage) and their scales times dt,
        one row per stage: ``reward_scale_table`` [stages, terms];
        ``reward_scales`` is stage 0's row.  ``termination`` stays out of the
        table: ``termination_scale`` is its stage-0 scale times dt."""
        scales = class_to_dict(self.cfg.rewards.scales)
        multi = self.cfg.rewards.multi_stage_rewards
        n_stages = self.cfg.rewards.reward_max_stage + 1 if multi else 1

        def at_stage(v, stage):
            if isinstance(v, (list, tuple)):
                return v[min(stage, len(v) - 1)] if multi else v[-1]
            return v

        names = []
        for name, v in scales.items():
            if name != "termination" and any(at_stage(v, k) != 0 for k in range(n_stages)):
                if not hasattr(self, f"_reward_{name}"):
                    raise ValueError(f"reward term '{name}' has no _reward_{name} implementation")
                names.append(name)
        self.reward_names = names
        self.reward_scale_table = torch.tensor(
            [[at_stage(scales[n], k) * self.dt for n in names] for k in range(n_stages)],
            dtype=torch.float32, device=self.device).reshape(n_stages, len(names))
        self.reward_scales = self.reward_scale_table[0]
        term = scales.get("termination", 0.0)
        self.termination_scale = float(at_stage(term, 0)) * self.dt if term else 0.0
        # the terms with an episode sum
        self.episode_terms = names + ["termination"] * (self.termination_scale != 0)

    def _make_noise_scale_vec(self) -> np.ndarray:
        """Per-observation noise amplitude: the scales times ``noise_level``
        times the observation scales; zero on commands and actions."""
        cfg, nj = self.cfg, self.num_dof
        ns, os_, level = cfg.noise.noise_scales, cfg.normalization.obs_scales, cfg.noise.noise_level
        vec = np.zeros(self.num_obs, np.float32)
        vec[0:3] = ns.lin_vel * level * os_.lin_vel
        vec[3:6] = ns.ang_vel * level * os_.ang_vel
        vec[6:9] = ns.gravity * level
        n = 12                                           # commands carry no noise
        vec[n:n + nj] = ns.dof_pos * level * os_.dof_pos
        vec[n + nj:n + 2 * nj] = ns.dof_vel * level * os_.dof_vel
        n += 2 * nj + self.num_actions                   # nor do the previous actions
        if cfg.terrain.measure_heights and n < self.num_obs:
            vec[n:n + self.num_height_points] = (ns.height_measurements * level
                                                 * os_.height_measurements)
        return vec

    def _uniform(self, shape, lo, hi) -> torch.Tensor:
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return lo + (hi - lo) * u

    def _draw_env_params(self) -> EnvPhysParams:
        """Per-env friction (64 buckets in ``friction_range``) and base mass
        delta, where the config randomizes them."""
        B, dr = self.num_envs, self.cfg.domain_rand
        friction = torch.ones(B, device=self.device)
        mass_delta = torch.zeros(B, device=self.device)
        if dr.randomize_friction:
            buckets = self._uniform((64,), *dr.friction_range)
            ids = torch.randint(0, 64, (B,), generator=self.generator, device=self.device)
            friction = buckets[ids]
        if dr.randomize_base_mass:
            mass_delta = self._uniform((B,), *dr.added_mass_range)
        return EnvPhysParams(friction, mass_delta)

    def _draw_push_vel(self) -> torch.Tensor:
        """World-frame xy velocities [B, 2] for a push (drawn every step, used
        on push steps only, so the host never reads ``common_step``)."""
        m = self.cfg.domain_rand.max_push_vel_xy
        return self._uniform((self.num_envs, 2), -m, m)

    def _draw_random_levels(self) -> torch.Tensor:
        """Uniform levels [B] in ``[0, max_terrain_level)`` for envs promoted
        past the top row (drawn at every reset, used where needed)."""
        return torch.randint(0, self.max_terrain_level, (self.num_envs,),
                             generator=self.generator, device=self.device)

    def _draw_spawn_offset(self) -> torch.Tensor:
        """The xy spawn offset [B, 2] about a generated terrain's origin."""
        return self._uniform((self.num_envs, 2), -0.5, 0.5)

    def _draw_stones(self) -> StoneDraws:
        """The draws of a spawn of every env's stones (used where an env
        resets)."""
        return draw_stones(self.num_envs, self.obstacle_cfg, self.generator, self.device)

    def _draw_commands(self, lin_vel_x_range) -> torch.Tensor:
        """Command draws [B, 3]: lin vel x in ``lin_vel_x_range``, lin vel y,
        and the heading (``heading_command``) or the yaw rate (drawn for all
        envs, used where a command is resampled)."""
        B, cr = self.num_envs, self.command_ranges
        third = cr["heading"] if self.cfg.commands.heading_command else cr["ang_vel_yaw"]
        return torch.stack([self._uniform((B,), lin_vel_x_range[0], lin_vel_x_range[1]),
                            self._uniform((B,), *cr["lin_vel_y"]), self._uniform((B,), *third)],
                           dim=1)

    def _draw_obs_noise(self, shape) -> torch.Tensor:
        """Uniform noise in [-1, 1) of ``shape``, scaled by ``noise_scale_vec``
        by the caller."""
        return 2.0 * torch.rand(shape, generator=self.generator, device=self.device) - 1.0

    def zero_episode_metrics(self) -> Dict[str, torch.Tensor]:
        keys = ["count", "return_sum", "length_sum"] + ["rew_" + n for n in self.episode_terms]
        return {k: torch.zeros((), device=self.device) for k in keys}

    # ------------------------------------------------------------------ reset
    def reset_all(self, seed: Optional[int] = None) -> EnvState:
        """A fresh EnvState for all envs (re-seeds the generator if ``seed``)."""
        if seed is not None:
            self.generator.manual_seed(seed)
        B, dev = self.num_envs, self.device
        all_envs = torch.ones(B, dtype=torch.bool, device=dev)
        levels, types = self.init_terrain_levels, self.init_terrain_types
        env_origins = self._compute_env_origins(levels, types)
        env_params = self._draw_env_params()
        phys = self._sample_init_phys(env_origins)
        lin_range = (torch.tensor(self.command_ranges["lin_vel_x"], device=dev)
                     if self.cfg.commands.curriculum else None)
        commands = self._sample_commands(torch.zeros(B, 4, device=dev), all_envs, lin_range)
        nf, ng = self.num_feet, self.model.ng
        z = lambda *s: torch.zeros(*s, device=dev)
        state = EnvState(
            phys=phys, env_params=env_params,
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
            episode_sums={n: z(B) for n in self.episode_terms},
            episode_return=z(B), env_origins=env_origins,
            common_step=torch.zeros((), dtype=torch.int64, device=dev),
            episode_metrics=self.zero_episode_metrics(),
            measured_heights=z(B, self.num_height_points), terrain_levels=levels,
            terrain_types=types, reward_stage=torch.zeros((), dtype=torch.int64, device=dev),
            actuator_hidden=(self.actuator_net.init_hidden((B, self.num_dof))
                             if self.actuator_net is not None else None),
            privileged_obs=z(B, self.num_privileged_obs) if self.num_privileged_obs else None,
            stones=(stones_from_draws(self._draw_stones(), phys.base_pos, self.obstacle_cfg)
                    if self.obstacle_cfg is not None else None),
            command_lin_vel_x_range=lin_range)
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
        if self.model.fix_base:
            # the physics zero a fixed base's acceleration, not its velocity
            lin_vel, ang_vel = torch.zeros_like(lin_vel), torch.zeros_like(ang_vel)
        if self.custom_origins:
            pos = pos + F.pad(self._draw_spawn_offset(), (0, 1))
        anchor = pos[:, None, :2].expand(B, self.model.ng, 2).clone()
        return PhysState(base_pos=pos, base_quat=quat, joint_pos=dof_pos, base_lin_vel=lin_vel,
                         base_ang_vel=ang_vel, joint_vel=torch.zeros(B, self.num_dof, device=self.device),
                         contact_anchor=anchor)

    def _sample_commands(self, commands, mask, lin_vel_x_range=None):
        """Resample commands for masked envs, lin vel x in
        ``lin_vel_x_range`` (the command curriculum's; by default the
        config's)."""
        draws = self._draw_commands(self.command_ranges["lin_vel_x"] if lin_vel_x_range is None
                                    else lin_vel_x_range)
        new = torch.zeros_like(commands)
        new[:, :2] = draws[:, :2]
        new[:, 3 if self.cfg.commands.heading_command else 2] = draws[:, 2]
        small = torch.linalg.norm(new[:, :2], dim=1) > 0.2
        new[:, :2] *= small[:, None]
        return torch.where(mask[:, None], new, commands)

    # ------------------------------------------------------------------ step
    @span("env.step")
    def step(self, state: EnvState, actions: torch.Tensor) -> EnvState:
        """Full RL step: decimated PD physics + post-physics (rewards,
        terminations, resets, observations)."""
        clip_a = self.cfg.normalization.clip_actions
        actions = torch.clamp(actions, -clip_a, clip_a)
        with span("env.physics"):
            phys, torques, report, hidden = self._physics_substeps(
                state.phys, actions, state.env_params, state.last_dof_vel, state.actuator_hidden)
        state = state.replace(phys=phys, actions=actions, torques=torques, actuator_hidden=hidden)
        with span("env.derived"):
            state = self._refresh_derived(state, report)
        if self.obstacle_cfg is not None:
            with span("env.obstacles"):
                phys, gf, stones = self._apply_obstacles(state.phys, state.foot_positions,
                                                         state.foot_velocities, state.geom_forces,
                                                         state.stones)
            state = state.replace(phys=phys, geom_forces=gf, stones=stones)
        return self._post_physics_step(state)

    def _apply_obstacles(self, phys: PhysState, foot_positions, foot_velocities, geom_forces,
                         stones: StoneState):
        """Robot-stone coupling for one control step (the main step and the
        rollouts): penalty forces between the base and feet spheres and the
        stones, added to those geoms' forces, their sum a velocity kick of
        the base; then the stones take ``decimation`` substeps.  Returns
        ``(phys, geom_forces, stones)``."""
        oc = self.obstacle_cfg
        sphere_pos = torch.cat([phys.base_pos[:, None], foot_positions], dim=1)
        sphere_vel = torch.cat([phys.base_lin_vel[:, None], foot_velocities], dim=1)
        f_robot, stones = stone_robot_forces(stones, sphere_pos, self._obstacle_sphere_radius,
                                             self.dt, oc, sphere_vel=sphere_vel)
        stones = step_stones(stones, self.terrain, self.cfg.sim.dt, oc,
                             n_substeps=self.cfg.control.decimation)
        gf = geom_forces.clone()
        gf[:, self._base_geom] += f_robot[:, 0]
        gf[:, self.feet_geoms] += f_robot[:, 1:]
        dv = f_robot.sum(dim=1) * (self.dt / self._total_mass)
        return phys.replace(base_lin_vel=phys.base_lin_vel + dv), gf, stones

    def _physics_substeps(self, phys: PhysState, actions: torch.Tensor,
                          env_params: EnvPhysParams, last_dof_vel: torch.Tensor,
                          actuator_hidden=None, differentiable: bool = False):
        """Decimation loop (torques recomputed every substep):
        ``(phys, tau_last, report, actuator_hidden)``.  P and T control run it
        fused in one kernel launch on the card; V control and the actuator
        network launch one substep at a time, the network's hidden state
        advancing per substep; the engine route calls the plain engine once
        per substep.  ``differentiable=True`` (and only that) takes the
        engine route on any scene, the torques computed here, so that
        gradients and Jacobians flow through the step: the kernels define no
        derivative, as the JAX package's fused kernels define no VJP."""
        if differentiable:
            step = self.grad_step
        elif self.decimated_step is not None:
            return (*self.decimated_step(phys, actions, env_params), actuator_hidden)
        else:
            step = self.engine_step if self.engine_step is not None else self.substep
        for _ in range(self.cfg.control.decimation):
            tau, actuator_hidden = self._compute_torques(actions, phys, last_dof_vel,
                                                         actuator_hidden)
            phys, report = step(phys, tau, env_params)
        return phys, tau, report, actuator_hidden

    def _compute_torques(self, actions: torch.Tensor, phys: PhysState,
                         last_dof_vel: torch.Tensor, actuator_hidden=None):
        """Torques clamped to the limits and the actuator network's next
        hidden state: with the network, its torque for the position error
        ``scaled + default - q`` and the velocity (the control type is
        ignored); under P control the PD law about ``scaled + default``;
        under V control a P term on the velocity error and a D term on the
        joint acceleration since the control step began (``last_dof_vel``);
        under T control the scaled actions.  (On the kernel routes P and T
        torques are computed inside the fused step.)"""
        scaled = actions * self.cfg.control.action_scale
        ctrl = self.cfg.control.control_type
        if self.actuator_net is not None:
            x = torch.stack([scaled + self.default_dof_pos - phys.joint_pos, phys.joint_vel], dim=-1)
            tau, actuator_hidden = self.actuator_net(x, actuator_hidden)
        elif ctrl == "P":
            tau = (self.p_gains_t * (scaled + self.default_dof_pos - phys.joint_pos)
                   - self.d_gains_t * phys.joint_vel)
        elif ctrl == "V":
            tau = (self.p_gains_t * (scaled - phys.joint_vel)
                   - self.d_gains_t * (phys.joint_vel - last_dof_vel) / self.cfg.sim.dt)
        elif ctrl == "T":
            tau = scaled
        else:
            raise NameError(f"Unknown controller type: {ctrl}")
        return torch.maximum(torch.minimum(tau, self.torque_limits), -self.torque_limits), actuator_hidden

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
        if self.num_height_points:
            with span("env.heights"):
                upd["measured_heights"] = self._get_heights(phys)
        return state.replace(**upd)

    def _get_heights(self, phys: PhysState) -> torch.Tensor:
        """Terrain heights [B, P] under the yaw-rotated measurement grid."""
        pts3 = F.pad(self.height_points, (0, 1))
        world = quat_apply_yaw(phys.base_quat[:, None, :], pts3[None, :, :])
        world = world + phys.base_pos[:, None, :]
        return sample_height(self.terrain, world[..., :2])

    def _post_physics_step(self, state: EnvState) -> EnvState:
        with span("env.commands"):
            state = state.replace(episode_length=state.episode_length + 1,
                                  common_step=state.common_step + 1)
            resample = (state.episode_length % self.resampling_interval) == 0
            commands = self._sample_commands(state.commands, resample,
                                             state.command_lin_vel_x_range)
            if self.cfg.commands.heading_command:
                fwd = quat_rotate(state.phys.base_quat,
                                  torch.tensor([1.0, 0.0, 0.0], device=self.device).expand(
                                      self.num_envs, 3))
                heading = torch.atan2(fwd[:, 1], fwd[:, 0])
                commands = torch.cat([commands[:, :2], torch.clamp(
                    0.5 * wrap_to_pi(commands[:, 3] - heading), -1.0, 1.0)[:, None],
                    commands[:, 3:]], dim=1)
            state = state.replace(commands=commands)
            if self.cfg.domain_rand.push_robots:
                push_now = (state.common_step % self.push_interval) == 0
                lin = state.phys.base_lin_vel
                pushed = torch.cat([self._draw_push_vel(), lin[:, 2:]], dim=1)
                state = state.replace(phys=state.phys.replace(
                    base_lin_vel=torch.where(push_now, pushed, lin)))

        with span("env.termination"):
            reset_buf, time_out = self._check_termination(state)
            nan0 = torch.nan_to_num
            state = state.replace(
                reset_buf=reset_buf, time_out_buf=time_out,
                phys=tree_map(nan0, state.phys),
                base_lin_vel=nan0(state.base_lin_vel), base_ang_vel=nan0(state.base_ang_vel),
                projected_gravity=nan0(state.projected_gravity),
                geom_forces=nan0(state.geom_forces), foot_positions=nan0(state.foot_positions),
                foot_velocities=nan0(state.foot_velocities), torques=nan0(state.torques),
                measured_heights=tree_map(nan0, state.measured_heights))

        with span("env.reward"):
            state, rew = self._compute_reward(state)
            state = state.replace(rew=rew, episode_return=state.episode_return + rew)
        with span("env.reset"):
            state = self._reset_envs(state, reset_buf)
        with span("env.obs"):
            obs = self._compute_observations(state)
            if self.cfg.noise.add_noise:
                obs = obs + self._draw_obs_noise(obs.shape) * self.noise_scale_vec
            clip_obs = self.cfg.normalization.clip_observations
            state = state.replace(obs=torch.clamp(obs, -clip_obs, clip_obs))
            if self.num_privileged_obs:
                state = state.replace(privileged_obs=torch.clamp(
                    self._compute_privileged_observations(state), -clip_obs, clip_obs))
        return state

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

    def _promote_levels(self, state: EnvState, mask: torch.Tensor) -> torch.Tensor:
        """Terrain-curriculum levels after the resets of ``mask``: up a level
        past half a subterrain from the origin, down a level short of half
        the commanded distance, a uniform level past the top row."""
        levels = state.terrain_levels
        dist = torch.linalg.norm(state.phys.base_pos[:, :2] - state.env_origins[:, :2], dim=1)
        move_up = dist > self.terrain_gen.env_length / 2
        cmd_dist = torch.linalg.norm(state.commands[:, :2], dim=1) * self.max_episode_length_s * 0.5
        move_down = (dist < cmd_dist) & ~move_up
        new = levels + move_up.to(levels.dtype) - move_down.to(levels.dtype)
        new = torch.where(new >= self.max_terrain_level, self._draw_random_levels(),
                          new.clamp(min=0))
        return torch.where(mask, new, levels)

    def _widen_lin_vel_x(self, state: EnvState, mask: torch.Tensor) -> torch.Tensor:
        """The command curriculum's lin-vel-x range after the resets of
        ``mask``: widened by 0.5 each way (up to ``max_curriculum``) where
        the resetting envs tracked well, at the reference's timing."""
        lin_range, cc = state.command_lin_vel_x_range, self.cfg.commands
        scale = self.reward_scale_table[state.reward_stage,
                                        self.reward_names.index("tracking_lin_vel")]
        fmask = mask.to(lin_range.dtype)
        mean_rew = ((state.episode_sums["tracking_lin_vel"] * fmask).sum()
                    / fmask.sum().clamp(min=1.0) / self.max_episode_length)
        widened = torch.stack([torch.clamp(lin_range[0] - 0.5, -cc.max_curriculum, 0.0),
                               torch.clamp(lin_range[1] + 0.5, 0.0, cc.max_curriculum)])
        do = ((mean_rew > 0.8 * scale) & (state.common_step % self.max_episode_length == 0)
              & mask.any())
        return torch.where(do, widened, lin_range)

    def _reset_envs(self, state: EnvState, mask: torch.Tensor) -> EnvState:
        """Re-draw root/dof states and commands where ``mask`` is set, on the
        origins of the promoted levels under the terrain curriculum."""
        tc = self.cfg.terrain
        levels, origins = state.terrain_levels, state.env_origins
        if self.custom_origins and tc.curriculum and not tc.freeze_terrain_levels:
            levels = self._promote_levels(state, mask)
            origins = self._compute_env_origins(levels, state.terrain_types)
        lin_range = state.command_lin_vel_x_range
        if self.cfg.commands.curriculum and "tracking_lin_vel" in self.reward_names:
            lin_range = self._widen_lin_vel_x(state, mask)
        phys = _where(mask, self._sample_init_phys(origins), state.phys)
        commands = self._sample_commands(state.commands, mask, lin_range)
        fmask = mask.to(torch.float32)
        zero = lambda x: torch.where(mask.reshape((-1,) + (1,) * (x.dim() - 1)), torch.zeros_like(x), x)
        hidden = state.actuator_hidden
        if hidden is not None:
            hidden = tuple(zero(h) for h in hidden)
        stones = state.stones
        if stones is not None:
            stones = reset_stones(stones, phys.base_pos, mask, self.obstacle_cfg,
                                  draws=self._draw_stones())
        # fold the finished episodes into the accumulators before zeroing
        em = dict(state.episode_metrics)
        em["count"] = em["count"] + fmask.sum()
        em["return_sum"] = em["return_sum"] + (state.episode_return * fmask).sum()
        em["length_sum"] = em["length_sum"] + (state.episode_length * fmask).sum()
        for k, v in state.episode_sums.items():
            em["rew_" + k] = em["rew_" + k] + (v * fmask).sum() / self.max_episode_length_s
        return state.replace(
            phys=phys, commands=commands, episode_metrics=em, actuator_hidden=hidden,
            stones=stones, terrain_levels=levels, env_origins=origins,
            command_lin_vel_x_range=lin_range, episode_return=state.episode_return * (1.0 - fmask),
            episode_length=torch.where(mask, torch.zeros_like(state.episode_length), state.episode_length),
            last_actions=zero(state.last_actions), last_dof_vel=zero(state.last_dof_vel),
            feet_air_time=zero(state.feet_air_time), feet_contact_time=zero(state.feet_contact_time),
            last_contacts=state.last_contacts & ~mask[:, None],
            episode_sums={k: zero(v) for k, v in state.episode_sums.items()})

    # ------------------------------------------------------------------ obs
    def _proprio_obs(self, state) -> torch.Tensor:
        """The proprioceptive part [lin vel, ang vel, projected gravity,
        commands, dof pos, dof vel, actions] with its scales."""
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

    def _compute_observations(self, state) -> torch.Tensor:
        os_ = self.cfg.normalization.obs_scales
        parts = [self._proprio_obs(state)]
        if self.num_height_points:
            parts.append(torch.clamp(state.phys.base_pos[:, 2:3] - 0.5 - state.measured_heights,
                                     -1.0, 1.0) * os_.height_measurements)
        if self.raycaster is not None and self.cfg.raycaster.attach_to_obs:
            parts.append(self.raycaster.observations(state.phys.base_pos, state.phys.base_quat))
        return torch.cat(parts, dim=-1)

    def _compute_privileged_observations(self, state) -> torch.Tensor:
        """The noise-free observation, cut or zero-padded to
        ``num_privileged_obs``."""
        obs, n = self._compute_observations(state), self.num_privileged_obs
        return obs[:, :n] if obs.shape[-1] >= n else F.pad(obs, (0, n - obs.shape[-1]))

    # ------------------------------------------------------------------ rewards
    def _contact_context(self, s):
        """Foot contact and air-time bookkeeping shared by the reward terms."""
        contact = s.geom_forces[:, self.feet_geoms, 2] > 1.0
        contact_filt = contact | s.last_contacts
        return dict(contact=contact, contact_filt=contact_filt,
                    first_contact=(s.feet_air_time > 0.0) & contact_filt,
                    feet_air_time=s.feet_air_time + self.dt,
                    feet_contact_time=s.feet_contact_time + self.dt)

    def _reward_sum(self, s, ctx, stage=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Scaled terms (at reward ``stage``, default 0) and their sum (with the
        only-positive clip)."""
        scales = self.reward_scales if stage is None else self.reward_scale_table[stage]
        terms = {name: getattr(self, f"_reward_{name}")(s, ctx) * scales[j]
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
        rew, terms = self._reward_sum(state, ctx, state.reward_stage)
        if self.termination_scale:
            terms["termination"] = self._reward_termination(state, ctx) * self.termination_scale
            rew = rew + terms["termination"]
        sums = {k: v + terms[k] for k, v in state.episode_sums.items()}
        state = state.replace(feet_air_time=ctx["feet_air_time"] * ~ctx["contact_filt"],
                              feet_contact_time=ctx["feet_contact_time"] * ctx["contact_filt"],
                              episode_sums=sums)
        return state, rew

    # --- the reward term library ---
    speed_min = 0.1
    def _reward_lin_vel_z(self, s, ctx):
        return torch.square(s.base_lin_vel[:, 2])

    def _reward_ang_vel_xy(self, s, ctx):
        return torch.sum(torch.square(s.base_ang_vel[:, :2]), dim=1)

    def _reward_orientation(self, s, ctx):
        return torch.sum(torch.square(s.projected_gravity[:, :2]), dim=1)

    def _reward_base_height(self, s, ctx):
        if self.num_height_points:
            ground = torch.mean(s.measured_heights, dim=1)
        else:
            ground = sample_height(self.terrain, s.phys.base_pos[:, :2])
        return torch.square(s.phys.base_pos[:, 2] - ground - self.cfg.rewards.base_height_target)

    def _reward_base_foot_height(self, s, ctx):
        """Base height above the mean height of the feet in contact (the
        base's own height less the target where none is)."""
        contact = ctx["feet_contact_time"] > 1e-3
        n = contact.sum(dim=1)
        foot_sum = torch.where(contact, s.foot_positions[:, :, 2], 0.0).sum(dim=1)
        target = self.cfg.rewards.base_height_target
        ground = torch.where(n > 0, foot_sum / n.clamp(min=1), s.phys.base_pos[:, 2] - target)
        return torch.square(s.phys.base_pos[:, 2] - ground - target)

    def _reward_torques(self, s, ctx):
        return torch.sum(torch.square(s.torques), dim=1)

    def _reward_dof_vel(self, s, ctx):
        return torch.sum(torch.square(s.phys.joint_vel), dim=1)

    def _reward_dof_vel_limits(self, s, ctx):
        lim = self.model.torch(self.device)["dof_vel_limits"] * self.cfg.rewards.soft_dof_vel_limit
        return torch.sum((s.phys.joint_vel.abs() - lim).clamp(min=0.0, max=1.0), dim=1)

    def _reward_torque_limits(self, s, ctx):
        lim = self.torque_limits * self.cfg.rewards.soft_torque_limit
        return torch.sum((s.torques.abs() - lim).clamp(min=0.0), dim=1)

    def _reward_dof_acc(self, s, ctx):
        return torch.sum(torch.square((s.last_dof_vel - s.phys.joint_vel) / self.dt), dim=1)

    def _reward_action_rate(self, s, ctx):
        return torch.sum(torch.square(s.last_actions - s.actions), dim=1)

    def _reward_collision(self, s, ctx):
        if not len(self.penalised_geoms):
            return torch.zeros(s.phys.base_pos.shape[0], device=self.device)
        f = s.geom_forces[:, self.penalised_geoms]
        return torch.sum((torch.linalg.norm(f, dim=-1) > 0.1).to(torch.float32), dim=1)

    def _feet_stumbling(self, s) -> torch.Tensor:
        """Feet [B, nf] whose horizontal contact force exceeds 5x the vertical."""
        f = s.geom_forces[:, self.feet_geoms]
        return torch.linalg.norm(f[..., :2], dim=-1) > 5 * f[..., 2].abs()

    def _reward_feet_stumble(self, s, ctx):
        return self._feet_stumbling(s).any(dim=1).to(torch.float32)

    def _reward_feet_stumble_liftup(self, s, ctx):
        return torch.sum(self._feet_stumbling(s) * s.foot_velocities[..., 2], dim=1)

    def _reward_jump_air(self, s, ctx):
        """Air time beyond 0.5 s summed over the airborne feet, past half
        the feet."""
        airborne = ~ctx["contact_filt"]
        return (torch.sum(airborne * (ctx["feet_air_time"] - 0.5), dim=1)
                - self.num_feet / 2).clamp(min=0.0)

    def _reward_four_footup(self, s, ctx):
        return 0.1 * (s.geom_forces[:, self.feet_geoms, 2] < 1.0).all(dim=1).to(torch.float32)

    def _reward_feet_contact_forces(self, s, ctx):
        f = torch.linalg.norm(s.geom_forces[:, self.feet_geoms], dim=-1)
        return torch.sum((f - self.cfg.rewards.max_contact_force).clamp(min=0.0), dim=1)

    def _reward_stand_still(self, s, ctx):
        still = torch.linalg.norm(s.commands[:, :2], dim=1) < self.speed_min
        return torch.sum((s.phys.joint_pos - self.default_dof_pos).abs(), dim=1) * still

    def _reward_termination(self, s, ctx):
        return (s.reset_buf & ~s.time_out_buf).to(torch.float32)

    def _reward_no_fly(self, s, ctx):
        """At least one foot pressing the ground by more than 0.1 N."""
        return ((s.geom_forces[:, self.feet_geoms, 2] > 0.1).sum(dim=1) >= 1).to(torch.float32)

    def _reward_feet_air_time(self, s, ctx):
        rew = torch.sum((ctx["feet_air_time"] - 0.5) * ctx["first_contact"], dim=1)
        return rew * (torch.linalg.norm(s.commands[:, :2], dim=1) > 0.1)

    def _reward_tracking_lin_vel(self, s, ctx):
        err = torch.sum(torch.square(s.commands[:, :2] - s.base_lin_vel[:, :2]), dim=1)
        return torch.exp(-err / self.cfg.rewards.tracking_sigma)

    def _reward_tracking_ang_vel(self, s, ctx):
        err = torch.square(s.commands[:, 2] - s.base_ang_vel[:, 2])
        return torch.exp(-err / self.cfg.rewards.tracking_sigma)

    def _reward_dof_pos_limits(self, s, ctx):
        lo = -(s.phys.joint_pos - self.dof_pos_soft_limits[:, 0]).clamp(max=0.0)
        hi = (s.phys.joint_pos - self.dof_pos_soft_limits[:, 1]).clamp(min=0.0)
        return torch.sum(lo + hi, dim=1)

    def _reward_feet_slip(self, s, ctx):
        vxy2 = torch.sum(torch.square(s.foot_velocities[..., :2]), dim=-1)
        return torch.sum(ctx["contact_filt"] * vxy2, dim=1)

    def _gait_active(self, s) -> torch.Tensor:
        """Envs whose command moves them (the gait terms apply only there)."""
        c = s.commands
        idx = 3 if self.cfg.commands.heading_command else 2
        return (torch.linalg.norm(c[:, :2], dim=1) > self.speed_min) | (
            torch.abs(c[:, idx]) >= self.speed_min / 2)

    def _reward_gait_2_step(self, s, ctx):
        """Quadruped trot: feet (0, 3) and (1, 2) in phase, the pairs in
        antiphase."""
        sync = (self._sync_rew(ctx, 0, 3) + self._sync_rew(ctx, 1, 2)) / 2
        async_ = (self._async_rew(ctx, 0, 1) + self._async_rew(ctx, 0, 2)
                  + self._async_rew(ctx, 3, 2) + self._async_rew(ctx, 3, 1)) / 4
        return (sync + async_) * self._gait_active(s)

    def _sync_rew(self, ctx, f0, f1, max_err=2.0):
        at, ct = ctx["feet_air_time"], ctx["feet_contact_time"]
        return (torch.square(at[:, f0] - at[:, f1]).clamp(max=max_err ** 2)
                + torch.square(ct[:, f0] - ct[:, f1]).clamp(max=max_err ** 2))

    def _async_rew(self, ctx, f0, f1, max_err=2.0):
        at, ct = ctx["feet_air_time"], ctx["feet_contact_time"]
        return (torch.square(at[:, f0] - ct[:, f1]).clamp(max=max_err ** 2)
                + torch.square(ct[:, f0] - at[:, f1]).clamp(max=max_err ** 2))
