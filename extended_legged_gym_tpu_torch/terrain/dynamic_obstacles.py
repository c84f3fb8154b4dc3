"""Passive stone obstacles (port of ``terrain/dynamic_obstacles.py``).

Boxes, spheres and capsules of random size, density, friction and
restitution are dropped around each robot (an annulus, some in clusters)
and simulated as bounding-sphere rigid bodies: gravity, ground contact with
restitution, Coulomb friction and rolling against the same heightfield the
robot walks on, stone-stone sphere contacts over the full M x M pair grid,
and linear and angular damping.  The stones of E envs are one
:class:`StoneState` of ``[E, M]`` tensors with an ``active`` mask (M =
``max_stones``); inactive slots hold valid data and stay frozen.  Robot
coupling (:func:`stone_robot_forces`) is a sphere-sphere penalty against
the robot's collision spheres, returning the force on the robot and
applying the reaction impulse to the stones.

The random draws of a spawn are one :class:`StoneDraws` (:func:`draw_stones`
from a ``torch.Generator``); :func:`stones_from_draws` turns them into the
state, so a test can inject the JAX package's draws.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.config import configclass
from ..utils.math import cross
from .heightfield import TerrainData, sample_height_and_normal

# stone type codes
BOX, SPHERE, CAPSULE = 0, 1, 2
# the stones' RGB palette (a stone's color is an index into it)
STONE_COLORS = (
    (0.6, 0.6, 0.6), (0.7, 0.7, 0.7), (0.5, 0.5, 0.5), (0.6, 0.5, 0.4),
    (0.7, 0.6, 0.5), (0.5, 0.4, 0.3), (0.4, 0.4, 0.4),
)
NUM_COLORS = len(STONE_COLORS)


@configclass
class DynamicObstacleConfig:
    enable: bool = False
    min_stones: int = 5
    max_stones: int = 15                # also the array size M
    type_probabilities: list = [0.6, 0.3, 0.1]   # box / sphere / capsule
    box_size_range: list = [0.08, 0.25]
    sphere_radius_range: list = [0.05, 0.15]
    capsule_radius_range: list = [0.03, 0.08]
    capsule_length_range: list = [0.1, 0.2]
    density_range: list = [800.0, 2000.0]
    restitution_range: list = [0.1, 0.4]
    friction_range: list = [0.3, 0.9]
    spawn_height_range: list = [0.3, 1.0]
    spawn_radius_range: list = [1.5, 6.0]
    initial_horizontal_vel_range: list = [-0.5, 0.5]
    initial_vertical_vel_range: list = [-0.2, 0.0]
    cluster_probability: float = 0.3
    cluster_size_range: list = [2, 5]
    cluster_radius_range: list = [0.3, 1.0]
    linear_damping: float = 0.05
    angular_damping: float = 0.05
    contact_stiffness: float = 4000.0
    contact_damping: float = 60.0
    bounce_threshold: float = 0.25    # |v_n| above which restitution applies
    rolling_resistance: float = 0.05  # rolling-friction coefficient (spheres, capsules)


@dataclass
class StoneState:
    """Batched stone rigid bodies, [E, M] with a validity mask."""

    pos: torch.Tensor           # [E, M, 3] world
    vel: torch.Tensor           # [E, M, 3]
    ang_vel: torch.Tensor       # [E, M, 3]
    quat: torch.Tensor          # [E, M, 4] xyzw
    radius: torch.Tensor        # [E, M] bounding / contact sphere
    half_extents: torch.Tensor  # [E, M, 3]
    mass: torch.Tensor          # [E, M]
    inv_inertia: torch.Tensor   # [E, M] scalar (solid-sphere approximation)
    friction: torch.Tensor      # [E, M]
    restitution: torch.Tensor   # [E, M]
    stone_type: torch.Tensor    # [E, M] int64 (BOX / SPHERE / CAPSULE)
    color: torch.Tensor         # [E, M] int64 palette index
    active: torch.Tensor        # [E, M] bool

    def replace(self, **changes) -> "StoneState":
        return dataclasses.replace(self, **changes)


class StoneDraws(NamedTuple):
    """The random draws of one spawn of E envs' stones, each already in its
    range."""

    count: torch.Tensor           # [E] int64 in [min_stones, M]
    stone_type: torch.Tensor      # [E, M] int64 by type_probabilities
    box_size: torch.Tensor        # [E, M, 3]
    sphere_radius: torch.Tensor   # [E, M]
    capsule_radius: torch.Tensor  # [E, M]
    capsule_length: torch.Tensor  # [E, M]
    density: torch.Tensor         # [E, M]
    spawn_radius: torch.Tensor    # [E, M] annulus radius
    spawn_angle: torch.Tensor     # [E, M] in [0, 2π)
    spawn_height: torch.Tensor    # [E, M] above the robot
    cluster: torch.Tensor         # [E, M] bool, joins a cluster (before the caps)
    parent_u: torch.Tensor        # [E, M] uniform [0, 1): picks the parent among earlier stones
    cluster_radius: torch.Tensor  # [E, M]
    cluster_angle: torch.Tensor   # [E, M] in [0, 2π)
    cluster_dist_u: torch.Tensor  # [E, M] uniform [0, 1): sqrt of it scales the radius
    cluster_dz: torch.Tensor      # [E, M] in [-0.1, 0.1)
    vel_xy: torch.Tensor          # [E, M, 2]
    vel_z: torch.Tensor           # [E, M]
    quat_normal: torch.Tensor     # [E, M, 4] standard normal (normalized later)
    color: torch.Tensor           # [E, M] int64 in [0, NUM_COLORS)
    friction: torch.Tensor        # [E, M]
    restitution: torch.Tensor     # [E, M]


def draw_stones(E: int, cfg: DynamicObstacleConfig, generator: torch.Generator,
                device) -> StoneDraws:
    """Fresh draws for E envs from ``generator``."""
    M = int(cfg.max_stones)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand((E, M) + shape, generator=generator, device=device)

    cum = torch.cumsum(torch.tensor(cfg.type_probabilities, dtype=torch.float32, device=device), 0)
    cum = cum / cum[-1]
    stone_type = torch.searchsorted(cum, u(0.0, 1.0).contiguous(), right=True)
    stone_type = stone_type.clamp(max=len(cum) - 1)
    return StoneDraws(
        count=torch.randint(int(cfg.min_stones), M + 1, (E,), generator=generator, device=device),
        stone_type=stone_type,
        box_size=u(*cfg.box_size_range, 3), sphere_radius=u(*cfg.sphere_radius_range),
        capsule_radius=u(*cfg.capsule_radius_range),
        capsule_length=u(*cfg.capsule_length_range), density=u(*cfg.density_range),
        spawn_radius=u(*cfg.spawn_radius_range), spawn_angle=u(0.0, 2.0 * math.pi),
        spawn_height=u(*cfg.spawn_height_range),
        cluster=u(0.0, 1.0) < cfg.cluster_probability, parent_u=u(0.0, 1.0),
        cluster_radius=u(*cfg.cluster_radius_range), cluster_angle=u(0.0, 2.0 * math.pi),
        cluster_dist_u=u(0.0, 1.0), cluster_dz=u(-0.1, 0.1),
        vel_xy=u(*cfg.initial_horizontal_vel_range, 2), vel_z=u(*cfg.initial_vertical_vel_range),
        quat_normal=torch.randn((E, M, 4), generator=generator, device=device),
        color=torch.randint(0, NUM_COLORS, (E, M), generator=generator, device=device),
        friction=u(*cfg.friction_range), restitution=u(*cfg.restitution_range))


def stones_from_draws(d: StoneDraws, robot_pos: torch.Tensor,
                      cfg: DynamicObstacleConfig) -> StoneState:
    """The stones of ``d`` around ``robot_pos`` [E, 3]: the first ``count``
    slots active; sizes, bounding radius, mass and inertia by type; each
    stone on the annulus, or, where it joins a cluster, within the cluster
    radius of an earlier parent's own spot (a parent keeps at most
    ``cluster_size_range[1] - 1`` joiners, the earlier ones)."""
    E, M = d.stone_type.shape
    dev = robot_pos.device
    idx = torch.arange(M, device=dev)
    active = idx[None, :] < d.count[:, None]
    st = d.stone_type
    t3 = st[..., None]

    he_box = d.box_size * 0.5
    sr, cr, cl = d.sphere_radius, d.capsule_radius, d.capsule_length
    he_sph = torch.stack([sr, sr, sr], -1)
    he_cap = torch.stack([cr, cr, cr + cl * 0.5], -1)
    half_extents = torch.where(t3 == BOX, he_box, torch.where(t3 == SPHERE, he_sph, he_cap))
    radius = torch.where(st == BOX, he_box.mean(-1), torch.where(st == SPHERE, sr, cr))
    volume = torch.where(st == BOX, d.box_size.prod(-1),
                         torch.where(st == SPHERE, (4.0 / 3.0) * math.pi * sr ** 3,
                                     math.pi * cr ** 2 * cl + (4.0 / 3.0) * math.pi * cr ** 3))
    mass = d.density * volume
    inv_inertia = 1.0 / (0.4 * mass * radius ** 2 + 1e-9)

    x = robot_pos[:, None, 0] + d.spawn_radius * torch.cos(d.spawn_angle)
    y = robot_pos[:, None, 1] + d.spawn_radius * torch.sin(d.spawn_angle)
    z = robot_pos[:, None, 2] + d.spawn_height

    clustered = d.cluster & (idx[None, :] > 0)
    parent = torch.floor(d.parent_u * idx.clamp(min=1)[None, :].to(d.parent_u.dtype))
    parent = parent.to(torch.int64)
    same_parent = ((parent[:, :, None] == parent[:, None, :])
                   & clustered[:, :, None] & clustered[:, None, :])
    earlier = idx[None, :, None] > idx[None, None, :]
    join_rank = (same_parent & earlier).sum(-1)
    clustered = clustered & (join_rank < int(cfg.cluster_size_range[1]) - 1)
    dist = torch.sqrt(d.cluster_dist_u) * d.cluster_radius
    px = x.gather(1, parent) + dist * torch.cos(d.cluster_angle)
    py = y.gather(1, parent) + dist * torch.sin(d.cluster_angle)
    pz = z.gather(1, parent) + d.cluster_dz
    pos = torch.stack([torch.where(clustered, px, x), torch.where(clustered, py, y),
                       torch.where(clustered, pz, z)], dim=-1)

    vel = torch.cat([d.vel_xy, d.vel_z[..., None]], dim=-1)
    quat = d.quat_normal / torch.linalg.norm(d.quat_normal, dim=-1, keepdim=True)
    return StoneState(pos=pos, vel=vel, ang_vel=torch.zeros_like(vel), quat=quat, radius=radius,
                      half_extents=half_extents, mass=mass, inv_inertia=inv_inertia,
                      friction=d.friction, restitution=d.restitution, stone_type=st,
                      color=d.color, active=active)


def generate_stones(robot_pos: torch.Tensor, cfg: DynamicObstacleConfig,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[StoneDraws] = None) -> StoneState:
    """Spawn stones around each robot (``draws`` replaces the draws from
    ``generator``)."""
    if draws is None:
        draws = draw_stones(robot_pos.shape[0], cfg, generator, robot_pos.device)
    return stones_from_draws(draws, robot_pos, cfg)


def reset_stones(state: StoneState, robot_pos: torch.Tensor, env_mask: torch.Tensor,
                 cfg: DynamicObstacleConfig, generator: Optional[torch.Generator] = None,
                 draws: Optional[StoneDraws] = None) -> StoneState:
    """Re-spawn the stones of the envs in ``env_mask``; the others keep
    theirs."""
    fresh = generate_stones(robot_pos, cfg, generator, draws)

    def blend(new, old):
        return torch.where(env_mask.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)

    return StoneState(**{f.name: blend(getattr(fresh, f.name), getattr(state, f.name))
                         for f in dataclasses.fields(StoneState)})


def _quat_integrate(quat: torch.Tensor, omega: torch.Tensor, dt: float) -> torch.Tensor:
    """q <- normalize(q + ½ Ω(ω) q dt), xyzw."""
    qx, qy, qz, qw = quat.unbind(-1)
    ox, oy, oz = omega.unbind(-1)
    dq = 0.5 * torch.stack([ox * qw + oy * qz - oz * qy,
                            oy * qw + oz * qx - ox * qz,
                            oz * qw + ox * qy - oy * qx,
                            -(ox * qx + oy * qy + oz * qz)], dim=-1)
    q = quat + dq * dt
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-9)


def step_stones(state: StoneState, terrain: TerrainData, dt: float, cfg: DynamicObstacleConfig,
                n_substeps: int = 1, gravity: float = -9.81) -> StoneState:
    """Advance all stones ``n_substeps`` x ``dt``: gravity, ground contact
    (a restitution flip on fast impacts, a spring-damper otherwise; never
    both), Coulomb friction with rolling, rolling resistance, stone-stone
    contacts, damping, an anti-tunnelling floor at half the radius.
    Inactive slots are frozen."""
    k, c = cfg.contact_stiffness, cfg.contact_damping
    act = state.active
    act3 = act[..., None]
    M = state.pos.shape[1]
    eye = torch.eye(M, dtype=torch.bool, device=act.device)[None]
    pair_act = act[:, :, None] & act[:, None, :] & ~eye
    rolls = (state.stone_type != BOX)[..., None]
    m, r = state.mass, state.radius
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    for _ in range(n_substeps):
        pos, vel, omega = state.pos, state.vel, state.ang_vel
        vel = vel + torch.tensor([0.0, 0.0, gravity], dtype=vel.dtype, device=vel.device) * dt

        # ground contact (bounding sphere vs heightfield)
        h, nrm = sample_height_and_normal(terrain, pos[..., :2])
        pen = (h + r) - pos[..., 2]
        in_contact = (pen > 0.0) & act
        v_n = (vel * nrm).sum(-1)
        bounce = in_contact & (v_n < -cfg.bounce_threshold)
        v_n_new = torch.where(bounce, -state.restitution * v_n, v_n)
        f_n = torch.where(in_contact & ~bounce, k * pen - c * v_n.clamp(max=0.0), zero)
        dv_n = (v_n_new - v_n) + f_n / m * dt
        vel = vel + nrm * dv_n[..., None]
        # Coulomb friction on the tangential surface velocity (spin included)
        v_surf = vel + cross(omega, -nrm * r[..., None])
        v_t = v_surf - nrm * (v_surf * nrm).sum(-1, keepdim=True)
        vt_mag = torch.linalg.norm(v_t, dim=-1)
        mu = state.friction.clamp(max=terrain.friction)
        max_dv = mu * f_n / m * dt + torch.where(bounce, mu * (v_n_new - v_n).abs(), zero)
        scale = torch.where(vt_mag > 1e-6, (max_dv / (vt_mag + 1e-9)).clamp(max=1.0), zero)
        dv_t = -v_t * scale[..., None]
        vel = vel + dv_t
        # the friction force at the contact point spins rolling stones; a
        # box's spin is damped while it touches
        torque = cross(-nrm * r[..., None], dv_t * m[..., None] / dt)
        omega = torch.where(rolls, omega + torque * state.inv_inertia[..., None] * dt,
                            omega * torch.where(in_contact[..., None], 0.8, 1.0))
        # rolling resistance
        v_xy = vel - nrm * (vel * nrm).sum(-1, keepdim=True)
        vxy_mag = torch.linalg.norm(v_xy, dim=-1)
        dv_rr = torch.where(in_contact,
                            torch.minimum(cfg.rolling_resistance * f_n / m * dt, vxy_mag), zero)
        vel = vel - v_xy * torch.where(vxy_mag > 1e-6, dv_rr / (vxy_mag + 1e-9), zero)[..., None]

        # stone-stone contacts over the M x M pair grid
        d = pos[:, :, None, :] - pos[:, None, :, :]
        dist = torch.sqrt((d * d).sum(-1) + 1e-12)
        rsum = r[:, :, None] + r[:, None, :]
        overlap = torch.where(pair_act, (rsum - dist).clamp(min=0.0), zero)
        n_ij = d / dist[..., None]
        vn_ij = ((vel[:, :, None, :] - vel[:, None, :, :]) * n_ij).sum(-1)
        f_ij = torch.where(overlap > 0.0, k * overlap - c * vn_ij.clamp(max=0.0), zero)
        vel = vel + (n_ij * f_ij[..., None]).sum(dim=2) / m[..., None] * dt

        # damping, integration, anti-tunnelling floor
        vel = vel * (1.0 - cfg.linear_damping * dt)
        omega = omega * (1.0 - cfg.angular_damping * dt)
        pos2 = pos + vel * dt
        h2, _ = sample_height_and_normal(terrain, pos2[..., :2])
        pos2 = torch.cat([pos2[..., :2], torch.maximum(pos2[..., 2], h2 + r * 0.5)[..., None]], -1)
        quat = _quat_integrate(state.quat, omega, dt)
        state = state.replace(pos=torch.where(act3, pos2, state.pos),
                              vel=torch.where(act3, vel, state.vel),
                              ang_vel=torch.where(act3, omega, state.ang_vel),
                              quat=torch.where(act3, quat, state.quat))
    return state


def stone_robot_forces(state: StoneState, sphere_pos: torch.Tensor, sphere_radius: torch.Tensor,
                       dt: float, cfg: DynamicObstacleConfig,
                       sphere_vel: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, StoneState]:
    """Sphere-sphere coupling of the robot's spheres ``sphere_pos`` [E, B, 3]
    (radius [B], velocity ``sphere_vel`` [E, B, 3] for the damper's relative
    normal speed) with the stones: ``(force on the robot [E, B, 3], stones
    with the reaction impulse applied)``.  Coincident centres push straight
    up."""
    k, c = cfg.contact_stiffness, cfg.contact_damping
    d = sphere_pos[:, :, None, :] - state.pos[:, None, :, :]        # [E, B, M, 3]
    dist = torch.sqrt((d * d).sum(-1) + 1e-12)
    rsum = sphere_radius[None, :, None] + state.radius[:, None, :]
    overlap = (rsum - dist).clamp(min=0.0) * state.active[:, None, :]
    up = torch.zeros_like(d)
    up[..., 2] = 1.0
    n = torch.where(dist[..., None] > 1e-5, d / dist[..., None], up)
    v_rel = -state.vel[:, None, :, :]
    if sphere_vel is not None:
        v_rel = v_rel + sphere_vel[:, :, None, :]
    v_n = (v_rel * n).sum(-1)
    f = torch.where(overlap > 0.0, k * overlap - c * v_n.clamp(max=0.0), torch.zeros_like(v_n))
    f_robot = (n * f[..., None]).sum(dim=2)
    imp_stone = -(n * f[..., None]).sum(dim=1) * dt
    vel = state.vel + imp_stone / state.mass[..., None]
    return f_robot, state.replace(vel=torch.where(state.active[..., None], vel, state.vel))
