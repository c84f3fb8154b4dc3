"""Base pose adaptation in confined terrain (port of ``envs/pose_adapt.py``).

The robot is unactuated, in zero gravity, and its base is steered by a
capped wrench PD toward pose targets integrated from velocity actions
(or, with ``control.use_direct_pose_control``, placed on the targets).  With
the joints frozen the robot is one rigid body: the robot's composite mass
and inertia (``physics.model.composite_rigid_body``) with its full set of
collision spheres, which touch the ground and the ceiling of the terrain
(or, with ``terrain.contact_trimesh``, its triangle mesh), stepped by
semi-implicit Euler.  Observations are spherical ray distances, the height
and orientation deviations and the commands; the rewards penalize
collisions, non-conformity to the terrain and tilt and reward velocity
tracking and downward motion.  Spawn origins are rejection-sampled on the
host in numpy, on ground-to-ceiling clearance, exactly as the JAX package
samples them.  No kernel: the JAX package runs this step in plain XLA too.

The random draws (spawn jitter and yaw, commands, pushes) come from the
env's ``torch.Generator`` through the ``_draw_*`` methods; tests inject the
JAX package's draws there.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..perception.raycast import RayCaster
from ..physics.contact import default_contact_params, sphere_terrain_contact
from ..physics.model import composite_rigid_body
from ..physics.serialize import load_model
from ..terrain.heightfield import TerrainData
from ..utils.config import configclass
from ..utils.device import resolve_device
from ..utils.math import (cross, quat_conjugate, quat_from_axis_angle, quat_integrate, quat_mul,
                          quat_rotate, quat_rotate_inverse, quat_to_matrix)
from .legged_robot_config import NormalizationCfg, RaycasterCfg


@configclass
class PoseAdaptEnvCfg:
    num_envs: int = 1024
    num_observations: int = 0       # computed: num_rays + 5 + num_commands
    num_actions: int = 6            # lin vel (3) + ang vel (3), base frame
    episode_length_s: float = 10.0


@configclass
class PoseAdaptSimCfg:
    dt: float = 0.005
    gravity: list = [0.0, 0.0, 0.0]
    # sphere-vs-triangle-mesh contacts against the confined terrain's mesh
    trimesh_contacts: bool = False


@configclass
class PoseAdaptControlCfg:
    decimation: int = 5
    position_p_gain: float = 50.0
    position_d_gain: float = 5.0
    rotation_p_gain: float = 50.0
    rotation_d_gain: float = 5.0
    action_scale: float = 1.0
    max_force: float = 500.0          # wrench caps
    max_torque: float = 100.0
    use_direct_pose_control: bool = False
    # the rigid body without a robot model
    mass: float = 30.0
    inertia: float = 2.0
    body_radius: float = 0.25


@configclass
class PoseAdaptCommandsCfg:
    num_commands: int = 3             # lin_x, lin_y, ang_yaw
    resampling_time: float = 2.0
    lin_vel_x: list = [-0.5, 0.5]
    lin_vel_y: list = [-0.5, 0.5]
    ang_vel_yaw: list = [-0.5, 0.5]


@configclass
class PoseAdaptRewardsCfg:
    collision_penalty: float = 1.0
    terrain_conformity_penalty: float = 1.0
    orientation_penalty: float = 0.2
    lin_vel_tracking: float = 0.5
    ang_vel_tracking: float = 0.5
    downward_vel_reward: float = 0.5
    downward_vel_scale: float = 0.5
    max_contact_force: float = 50.0
    min_safe_distance: float = 0.2


@configclass
class PoseAdaptAssetCfg:
    nominal_height: float = 0.25
    robot_model: str = ""             # path to a robot model JSON


@configclass
class PoseAdaptOriginsCfg:
    random_origins: bool = True
    max_attempts: int = 10000
    x_range: list = [-1e9, 1e9]       # clipped to the terrain extent
    y_range: list = [-1e9, 1e9]
    height_clearance_factor: float = 2.0


@configclass
class PoseAdaptDomainRandCfg:
    push_robots: bool = True
    push_interval_s: float = 15.0
    max_push_vel_xy: float = 1.0
    randomize_init_pos: bool = True   # ±0.1 m xy jitter
    randomize_init_yaw: bool = True


@configclass
class BasePoseAdaptCfg:
    seed: int = 1
    env: PoseAdaptEnvCfg = PoseAdaptEnvCfg()
    sim: PoseAdaptSimCfg = PoseAdaptSimCfg()
    control: PoseAdaptControlCfg = PoseAdaptControlCfg()
    commands: PoseAdaptCommandsCfg = PoseAdaptCommandsCfg()
    rewards: PoseAdaptRewardsCfg = PoseAdaptRewardsCfg()
    asset: PoseAdaptAssetCfg = PoseAdaptAssetCfg()
    origins: PoseAdaptOriginsCfg = PoseAdaptOriginsCfg()
    domain_rand: PoseAdaptDomainRandCfg = PoseAdaptDomainRandCfg()
    raycaster: RaycasterCfg = RaycasterCfg()
    normalization: NormalizationCfg = NormalizationCfg()


@dataclass
class PoseAdaptState:
    pos: torch.Tensor            # [B, 3]
    quat: torch.Tensor           # [B, 4] xyzw
    lin_vel: torch.Tensor        # [B, 3] world
    ang_vel: torch.Tensor        # [B, 3] world
    target_pos: torch.Tensor     # [B, 3]
    target_quat: torch.Tensor    # [B, 4]
    commands: torch.Tensor       # [B, 3]
    actions: torch.Tensor        # [B, 6]
    last_actions: torch.Tensor
    base_contact_force: torch.Tensor  # [B] |sum of the base geoms' contact forces|
    ray_dist: torch.Tensor       # [B, R] hit distances
    ray_hit: torch.Tensor        # [B, R] bool
    episode_length: torch.Tensor  # [B] int64
    episode_return: torch.Tensor
    episode_metrics: Dict[str, torch.Tensor]
    obs: torch.Tensor
    rew: torch.Tensor
    reset_buf: torch.Tensor
    time_out_buf: torch.Tensor
    privileged_obs: Optional[torch.Tensor] = None

    def replace(self, **changes) -> "PoseAdaptState":
        return dataclasses.replace(self, **changes)


class BasePoseAdapt:
    """Floating-base pose-adaptation env over a (typically confined)
    terrain, with LeggedRobot's training protocol (obs, rew, reset_buf,
    time_out_buf, episode_metrics)."""

    custom_origins = False
    reward_stage_count = 1

    def __init__(self, cfg: BasePoseAdaptCfg, terrain: TerrainData, model=None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.terrain = terrain
        self.num_envs = cfg.env.num_envs
        self.num_actions = cfg.env.num_actions
        self.sim_dt = cfg.sim.dt
        self.dt = cfg.sim.dt * cfg.control.decimation   # control dt
        self.max_episode_length = int(cfg.env.episode_length_s / self.dt)
        self.resample_interval = max(1, int(cfg.commands.resampling_time / self.dt))
        self.push_interval = max(1, int(cfg.domain_rand.push_interval_s / self.dt))
        self.nominal_height = cfg.asset.nominal_height

        # the composite rigid body, host side
        if model is None and cfg.asset.robot_model:
            model = load_model(cfg.asset.robot_model)
        if model is not None:
            mass, inertia, _, geom_off = composite_rigid_body(model)
            self.mass = float(mass)
            self.inertia = np.asarray(inertia, np.float32)
            self.geom_offset = np.asarray(geom_off, np.float32)
            self.geom_radius = np.asarray(model.geom_radius, np.float32)
            # termination on the base link's contacts only
            self.base_geoms = (np.asarray(model.geom_body) == 0).astype(np.float32)
        else:
            c = cfg.control
            self.mass = float(c.mass)
            self.inertia = np.eye(3, dtype=np.float32) * np.float32(c.inertia)
            self.geom_offset = np.zeros((1, 3), np.float32)
            self.geom_radius = np.asarray([c.body_radius], np.float32)
            self.base_geoms = np.ones(1, np.float32)
        self.inertia_inv = np.linalg.inv(self.inertia).astype(np.float32)
        self.gravity = np.asarray(cfg.sim.gravity, np.float32)
        self.contact_params = default_contact_params(kp=2.0e4, kd=1.0e3, kt=5.0e3, mu=1.0)
        t = lambda a: torch.as_tensor(a, device=self.device)
        self._geom_offset, self._geom_radius = t(self.geom_offset), t(self.geom_radius)
        self._base_geoms, self._inertia_inv = t(self.base_geoms), t(self.inertia_inv)
        self._gravity = t(self.gravity)

        # perception
        cfg.raycaster.enable_raycast = True
        if cfg.raycaster.ray_pattern == "cone":
            cfg.raycaster.ray_pattern = "spherical"
        self.raycaster = RayCaster(cfg.raycaster, terrain, self.device)
        self.num_rays = self.raycaster.num_rays
        # rays + height deviation (1) + orientation deviation (4) + commands
        self.num_obs = self.num_rays + 5 + cfg.commands.num_commands
        cfg.env.num_observations = self.num_obs
        self.num_privileged_obs = None

        self.origins = self._generate_origins()
        self._origins = t(self.origins)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)

    # ------------------------------------------------------------------ origins
    def _generate_origins(self) -> np.ndarray:
        """Rejection-sample spawn points whose ground-to-ceiling clearance is
        at least ``nominal_height x height_clearance_factor`` over the robot's
        footprint (plus the reset jitter): the grids are box-filtered, the
        ground by max and the ceiling by min, before the test.  Host numpy,
        the JAX package's draws and arithmetic."""
        o = self.cfg.origins
        t = self.terrain
        ground = np.asarray(t.height)
        ceiling = np.asarray(t.ceiling)
        half_extent = float(np.abs(self.geom_offset[:, :2]).max() + self.geom_radius.max() + 0.15)
        w = max(1, int(np.ceil(half_extent / float(t.hscale))))
        gpad = np.pad(ground, w, mode="edge")
        cpad = np.pad(ceiling, w, mode="edge")
        H0, W0 = ground.shape
        gmax = ground.copy()
        cmin = ceiling.copy()
        for di in range(-w, w + 1):
            for dj in range(-w, w + 1):
                gmax = np.maximum(gmax, gpad[w + di:w + di + H0, w + dj:w + dj + W0])
                cmin = np.minimum(cmin, cpad[w + di:w + di + H0, w + dj:w + dj + W0])
        ground, ceiling = gmax, cmin
        H, W = ground.shape
        hs = float(t.hscale)
        ox, oy = float(t.origin[0]), float(t.origin[1])
        x_lo = max(o.x_range[0], ox + hs)
        x_hi = min(o.x_range[1], ox + (H - 2) * hs)
        y_lo = max(o.y_range[0], oy + hs)
        y_hi = min(o.y_range[1], oy + (W - 2) * hs)
        need = self.num_envs
        clearance = self.nominal_height * o.height_clearance_factor
        rng = np.random.RandomState(self.cfg.seed)

        valid = []
        attempts = 0
        while len(valid) < need and attempts < o.max_attempts:
            n = min(2048, o.max_attempts - attempts)
            attempts += n
            xs = rng.uniform(x_lo, x_hi, n)
            ys = rng.uniform(y_lo, y_hi, n)
            gi = np.clip(((xs - ox) / hs).astype(int), 0, H - 1)
            gj = np.clip(((ys - oy) / hs).astype(int), 0, W - 1)
            g = ground[gi, gj]
            c = ceiling[gi, gj]
            ok = (c - g) >= clearance
            for x, y, gz in zip(xs[ok], ys[ok], g[ok]):
                valid.append((x, y, gz + self.nominal_height))
        if len(valid) < need:  # the centre of the grid
            cx, cy = ox + H * hs / 2, oy + W * hs / 2
            while len(valid) < need:
                valid.append((cx, cy, float(ground[H // 2, W // 2]) + self.nominal_height))
        return np.asarray(valid[:need], dtype=np.float32)

    # ------------------------------------------------------------------ draws
    def _uniform(self, shape, lo, hi) -> torch.Tensor:
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return lo + (hi - lo) * u

    def _draw_spawn(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Spawn poses ``(pos [B, 3], quat [B, 4])``: the origins with
        ±0.1 m xy jitter (±1 cm in z) and a uniform yaw, where configured."""
        dr, B = self.cfg.domain_rand, self.num_envs
        pos = self._origins[:B]
        if dr.randomize_init_pos:
            noise = self._uniform((B, 3), -0.1, 0.1)
            pos = pos + noise * torch.tensor([1.0, 1.0, 0.1], device=self.device)
        if dr.randomize_init_yaw:
            yaw = self._uniform((B,), -math.pi, math.pi)
            z = torch.zeros(B, 3, device=self.device)
            z[:, 2] = 1.0
            quat = quat_from_axis_angle(z, yaw)
        else:
            quat = torch.tensor([0.0, 0.0, 0.0, 1.0], device=self.device).repeat(B, 1)
        return pos, quat

    def _draw_commands(self) -> torch.Tensor:
        c, B = self.cfg.commands, self.num_envs
        return torch.stack([self._uniform((B,), *c.lin_vel_x), self._uniform((B,), *c.lin_vel_y),
                            self._uniform((B,), *c.ang_vel_yaw)], dim=-1)

    def _draw_push(self) -> torch.Tensor:
        m = self.cfg.domain_rand.max_push_vel_xy
        return self._uniform((self.num_envs, 2), -m, m)

    # ------------------------------------------------------------------ reset
    def zero_episode_metrics(self) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros((), device=self.device) for k in ("count", "return_sum", "length_sum")}

    def reset_all(self, seed: Optional[int] = None) -> PoseAdaptState:
        if seed is not None:
            self.generator.manual_seed(seed)
        B, dev = self.num_envs, self.device
        pos, quat = self._draw_spawn()
        z = lambda *s: torch.zeros(*s, device=dev)
        state = PoseAdaptState(
            pos=pos, quat=quat, lin_vel=z(B, 3), ang_vel=z(B, 3), target_pos=pos,
            target_quat=quat, commands=self._draw_commands(), actions=z(B, 6),
            last_actions=z(B, 6), base_contact_force=z(B), ray_dist=z(B, self.num_rays),
            ray_hit=torch.zeros(B, self.num_rays, dtype=torch.bool, device=dev),
            episode_length=torch.zeros(B, dtype=torch.int64, device=dev), episode_return=z(B),
            episode_metrics=self.zero_episode_metrics(), obs=z(B, self.num_obs), rew=z(B),
            reset_buf=torch.zeros(B, dtype=torch.bool, device=dev),
            time_out_buf=torch.zeros(B, dtype=torch.bool, device=dev))
        state = self._update_percept(state)
        return state.replace(obs=self._obs(state))

    # ------------------------------------------------------------------ step
    def _wrench_substep(self, pos, quat, v, w, target_pos, target_quat):
        """One sim substep of the wrench PD with the terrain contacts:
        ``(pos, quat, v, w, |base contact force|)``."""
        cc = self.cfg.control
        force = cc.position_p_gain * (target_pos - pos) - cc.position_d_gain * v
        fnorm = torch.linalg.norm(force, dim=-1, keepdim=True)
        force = force * torch.clamp(cc.max_force / (fnorm + 1e-6), max=1.0)

        qe = quat_mul(target_quat, quat_conjugate(quat))
        w_err = torch.clamp(qe[:, 3], -1.0, 1.0)
        angle = 2.0 * torch.arccos(torch.abs(w_err))
        sxyz = qe[:, :3] * torch.sign(w_err)[:, None]
        sin_half = torch.sqrt(torch.clamp(1.0 - w_err * w_err, min=1e-12))
        rot_err = sxyz / sin_half[:, None] * angle[:, None]
        rot_err = torch.where((angle > 1e-2)[:, None], rot_err, 2.0 * sxyz)
        torque = cc.rotation_p_gain * rot_err - cc.rotation_d_gain * w
        tnorm = torch.linalg.norm(torque, dim=-1, keepdim=True)
        torque = torque * torch.clamp(cc.max_torque / (tnorm + 1e-6), max=1.0)

        # terrain contacts on the full collision-sphere set
        r = quat_rotate(quat[:, None, :], self._geom_offset[None, :, :])
        g_pos = pos[:, None, :] + r
        g_vel = v[:, None, :] + cross(w[:, None, :], r)
        contact = sphere_terrain_contact(self.terrain, self.contact_params, g_pos, g_vel,
                                         self._geom_radius[None, :])
        f_c = contact.f_el - contact.apply_D(g_vel)
        f_c = f_c * (contact.depth > 0.0)[..., None].to(f_c.dtype)

        F = force + f_c.sum(dim=1) + self.mass * self._gravity
        tau = torque + cross(r, f_c).sum(dim=1)
        R = quat_to_matrix(quat)
        tau_b = torch.einsum("bij,bi->bj", R, tau)          # world -> body
        dw_b = torch.einsum("ij,bj->bi", self._inertia_inv, tau_b)
        dw = torch.einsum("bij,bj->bi", R, dw_b)             # body -> world

        v = v + (F / self.mass) * self.sim_dt
        w = w + dw * self.sim_dt
        pos = pos + v * self.sim_dt
        quat = quat_integrate(quat, w, self.sim_dt)
        f_base = (f_c * self._base_geoms[None, :, None]).sum(dim=1)
        return pos, quat, v, w, torch.linalg.norm(f_base, dim=-1)

    def step(self, state: PoseAdaptState, actions: torch.Tensor) -> PoseAdaptState:
        cfg = self.cfg
        cc = cfg.control
        clip = cfg.normalization.clip_actions
        actions = torch.clamp(actions, -clip, clip)

        # velocity actions integrated into pose targets
        cmd_vel = actions[:, :3] * cc.action_scale
        cmd_ang = actions[:, 3:6] * cc.action_scale
        target_pos = state.target_pos + quat_rotate(state.target_quat, cmd_vel) * self.dt
        ang = torch.linalg.norm(cmd_ang, dim=-1)
        axis = cmd_ang / torch.clamp(ang, min=1e-9)[:, None]
        target_quat = quat_mul(state.target_quat, quat_from_axis_angle(axis, ang * self.dt))

        if cc.use_direct_pose_control:
            # placed on the targets, with the consistent velocity
            state = state.replace(
                pos=target_pos, quat=target_quat, lin_vel=(target_pos - state.pos) / self.dt,
                ang_vel=torch.zeros_like(state.ang_vel),
                base_contact_force=torch.zeros_like(state.base_contact_force))
        else:
            pos, quat, v, w = state.pos, state.quat, state.lin_vel, state.ang_vel
            f_max = None
            for _ in range(cc.decimation):
                pos, quat, v, w, f = self._wrench_substep(pos, quat, v, w, target_pos, target_quat)
                f_max = f if f_max is None else torch.maximum(f_max, f)
            state = state.replace(pos=pos, quat=quat, lin_vel=v, ang_vel=w,
                                  base_contact_force=f_max)

        state = state.replace(target_pos=target_pos, target_quat=target_quat,
                              last_actions=state.actions, actions=actions,
                              episode_length=state.episode_length + 1)
        state = self._update_percept(state)
        rew = self._reward(state)
        state = state.replace(episode_return=state.episode_return + rew)

        crash = state.base_contact_force > self.cfg.rewards.max_contact_force * 2.0
        timeout = state.episode_length > self.max_episode_length
        reset = crash | timeout

        do_resample = (state.episode_length % self.resample_interval) == 0
        commands = torch.where(do_resample[:, None], self._draw_commands(), state.commands)
        if self.cfg.domain_rand.push_robots:
            do_push = (state.episode_length % self.push_interval) == 0
            push = self._draw_push()
            push = torch.where(do_push[:, None], push, torch.zeros_like(push))
            state = state.replace(lin_vel=state.lin_vel + torch.cat(
                [push, torch.zeros_like(push[:, :1])], dim=-1))
        state = self._reset_where(state.replace(commands=commands), reset)
        state = self._update_percept(state)
        return state.replace(rew=rew, reset_buf=reset, time_out_buf=timeout, obs=self._obs(state))

    # ------------------------------------------------------------------ obs
    def _update_percept(self, state: PoseAdaptState) -> PoseAdaptState:
        res = self.raycaster.cast(state.pos, state.quat)
        return state.replace(ray_dist=res.distance, ray_hit=res.hit)

    def _obs(self, state: PoseAdaptState) -> torch.Tensor:
        """[inverse-normalized ray distances, height deviation, orientation
        deviation from upright, commands], clipped."""
        rd = 1.0 - torch.clamp(state.ray_dist / self.cfg.raycaster.max_distance, 0.0, 1.0)
        height_diff = state.pos[:, 2:3] - self.nominal_height
        nominal = torch.tensor([0.0, 0.0, 0.0, 1.0], device=self.device)
        quat_diff = quat_mul(state.quat, quat_conjugate(nominal).expand_as(state.quat))
        obs = torch.cat([rd, height_diff, quat_diff, state.commands], dim=-1)
        clip = self.cfg.normalization.clip_observations
        return torch.clamp(obs, -clip, clip)

    # ------------------------------------------------------------------ rewards
    def _reward(self, state: PoseAdaptState) -> torch.Tensor:
        rc = self.cfg.rewards
        collision = torch.clamp(state.base_contact_force / rc.max_contact_force, 0.0, 1.0) \
            * rc.collision_penalty

        # terrain conformity: each ray's expected hit distance is the nominal
        # height over the cosine of its angle to straight down, the rays
        # weighted toward the downward ones
        dirs_w = quat_rotate(state.quat[:, None, :], self.raycaster.ray_dirs[None, :, :])
        cos = -dirs_w[..., 2]
        expected = torch.clamp(self.nominal_height / torch.clamp(cos, min=0.1),
                               max=5.0 * self.nominal_height)
        actual = torch.where(state.ray_hit, state.ray_dist,
                             torch.full_like(state.ray_dist, self.cfg.raycaster.max_distance))
        err = torch.abs(actual - expected)
        weights = torch.square((cos + 1.0) / 2.0) * state.ray_hit
        wsum = weights.sum(dim=1)
        conform = torch.where(wsum > 0, (err * weights).sum(dim=1) / torch.clamp(wsum, min=1e-9),
                              torch.zeros_like(wsum))
        conform = torch.clamp(conform / self.nominal_height, 0.0, 1.0) \
            * rc.terrain_conformity_penalty

        down = torch.tensor([0.0, 0.0, -1.0], device=self.device).expand_as(state.pos)
        grav = quat_rotate_inverse(state.quat, down)
        orient = torch.clamp(torch.sum(torch.square(grav[:, :2]), dim=-1), 0.0, 1.0) \
            * rc.orientation_penalty

        v_b = quat_rotate_inverse(state.quat, state.lin_vel)
        w_b = quat_rotate_inverse(state.quat, state.ang_vel)
        cmd_lin = torch.cat([state.commands[:, :2], torch.zeros_like(v_b[:, :1])], dim=-1)
        cmd_ang = torch.cat([torch.zeros_like(w_b[:, :2]), state.commands[:, 2:3]], dim=-1)
        lin_track = torch.exp(-torch.sum(torch.square(v_b - cmd_lin), dim=1) / 0.25) \
            * rc.lin_vel_tracking
        ang_track = torch.exp(-torch.sum(torch.square(w_b - cmd_ang), dim=1) / 0.25) \
            * rc.ang_vel_tracking

        vz = v_b[:, 2]
        down_bonus = torch.where(vz < 0, 1.0 - torch.exp(vz / rc.downward_vel_scale),
                                 torch.zeros_like(vz)) * rc.downward_vel_reward
        return -collision - conform - orient + lin_track + ang_track + down_bonus

    # ------------------------------------------------------------------ resets
    def _reset_where(self, state: PoseAdaptState, mask: torch.Tensor) -> PoseAdaptState:
        """New spawn poses, zero velocities and new commands where ``mask``;
        the finished episodes folded into the metrics."""
        pos, quat = self._draw_spawn()
        cmd = self._draw_commands()
        m = mask[:, None]
        fmask = mask.to(torch.float32)
        em = dict(state.episode_metrics)
        em["count"] = em["count"] + fmask.sum()
        em["return_sum"] = em["return_sum"] + (state.episode_return * fmask).sum()
        em["length_sum"] = em["length_sum"] + (state.episode_length * fmask).sum()
        zero = torch.zeros((), device=self.device)
        return state.replace(
            episode_return=state.episode_return * (1.0 - fmask), episode_metrics=em,
            pos=torch.where(m, pos, state.pos), quat=torch.where(m, quat, state.quat),
            lin_vel=torch.where(m, zero, state.lin_vel), ang_vel=torch.where(m, zero, state.ang_vel),
            target_pos=torch.where(m, pos, state.target_pos),
            target_quat=torch.where(m, quat, state.target_quat),
            commands=torch.where(m, cmd, state.commands),
            base_contact_force=torch.where(mask, zero, state.base_contact_force),
            episode_length=torch.where(mask, torch.zeros_like(state.episode_length),
                                       state.episode_length))
