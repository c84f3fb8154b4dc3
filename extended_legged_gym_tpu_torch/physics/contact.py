"""Sphere-vs-terrain penalty contact (port of ``physics/contact.py``).

The model, as in the JAX package:
* normal force ``fn = kp·φ − kd_g·vn`` with the damper capped so the total
  normal force never pulls (no adhesion): ``kd_g = min(kd, kp·φ / vn)``;
* penetration clamped to ``2r + 5 cm``, which bounds the impulse after a
  teleporting reset;
* friction = implicit viscous damper ``kt_eff = min(kt, μ·fn/|vt|)`` plus an
  explicit anchor spring (stiction) that gets the friction-cone budget the
  damper leaves free; where the budget clamps the spring, the anchor slides
  with the point;
* the damping part is returned as ``D = kt·I + (kd_g − kt)·n nᵀ`` per geom,
  which the engine folds into the articulated inertias (implicit damping);
* on a heightfield, ``n`` is the normal of the bilinear patch under the
  sphere and the gap is vertical; the anchor displacement is projected onto
  the tangent plane.  A flat terrain gives ``n = z``;
* under a ceiling (two-layer terrains) the gap of the sphere's top to the
  ceiling counts where it is the deeper one, with ``n = -z``;
* with ``terrain.contact_trimesh`` the depth and normal come from the
  triangle mesh's signed distance (``perception/trimesh.query_sdf_trimesh``):
  walls and ceilings push along their true normals.  Beyond the mesh's SDF
  radius the distance reads positive, so the contact is inactive.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..perception.trimesh import query_sdf_trimesh
from ..terrain.heightfield import TerrainData, sample_ceiling, sample_height_and_normal


@dataclass(frozen=True)
class ContactParams:
    kp: float = 3.0e4         # normal stiffness [N/m]
    kd: float = 1.5e3         # normal damping [N·s/m] (no-adhesion capped)
    kt: float = 1.0e4         # max tangential damping [N·s/m]
    mu: float = 1.0           # friction coefficient
    kt_spring: float = 3.0e4  # tangential anchor-spring stiffness [N/m]


def default_contact_params(kp=3.0e4, kd=1.5e3, kt=1.0e4, mu=1.0,
                           kt_spring=3.0e4) -> ContactParams:
    return ContactParams(kp=float(kp), kd=float(kd), kt=float(kt), mu=float(mu),
                         kt_spring=float(kt_spring))


class ContactResult(NamedTuple):
    f_el: torch.Tensor        # [..., ng, 3] elastic force incl. anchor spring, world
    n: torch.Tensor           # [..., ng, 3] contact normal
    kt: torch.Tensor          # [..., ng] tangential damping (0 if inactive)
    kd_minus_kt: torch.Tensor # [..., ng] normal minus tangential damping (0 if inactive)
    depth: torch.Tensor       # [..., ng] penetration depth (> 0 when touching)
    anchor: torch.Tensor      # [..., ng, 2] updated anchors (world xy)

    def apply_D(self, v: torch.Tensor) -> torch.Tensor:
        """D @ v for per-geom vectors [..., ng, 3]."""
        vn = torch.sum(v * self.n, dim=-1, keepdim=True)
        return self.kt[..., None] * v + self.kd_minus_kt[..., None] * vn * self.n


def sphere_terrain_contact(terrain: TerrainData, params: ContactParams,
                           pos: torch.Tensor, vel: torch.Tensor, radius: torch.Tensor,
                           anchor: Optional[torch.Tensor] = None,
                           mu: Optional[torch.Tensor] = None) -> ContactResult:
    """Contacts of spheres at ``pos`` [..., ng, 3] moving at ``vel`` against
    the terrain.  ``mu`` overrides ``params.mu`` and may be a tensor that
    broadcasts against [..., ng] (per-env friction)."""
    xy = pos[..., :2]
    if anchor is None:
        anchor = xy
    if mu is None:
        mu = params.mu
    if terrain.contact_trimesh:
        sdf, n, _ = query_sdf_trimesh(terrain.trimesh, pos)
        depth = radius - sdf
    else:
        h, n = sample_height_and_normal(terrain, xy)
        # ground contact: vertical gap of the sphere's lowest point
        depth = (h + radius) - pos[..., 2]
        if terrain.has_ceiling:
            # ceiling contact: gap of the sphere's highest point
            depth_c = pos[..., 2] + radius - sample_ceiling(terrain, xy)
            use_ceiling = depth_c > depth
            depth = torch.maximum(depth, depth_c)
            down = torch.zeros_like(n)
            down[..., 2] = -1.0
            n = torch.where(use_ceiling[..., None], down, n)
    active = (depth > 0.0).to(pos.dtype)
    depth_a = torch.minimum(depth.clamp(min=0.0), 2.0 * radius + 0.05)

    vn = torch.sum(vel * n, dim=-1)
    vt = vel - vn[..., None] * n
    vt_norm = torch.linalg.norm(vt, dim=-1)

    fn_el = params.kp * depth_a
    kd_g = torch.minimum(torch.full_like(fn_el, params.kd), fn_el / vn.clamp(min=1e-6))
    fn_est = (fn_el - kd_g * vn).clamp(min=0.0) * active
    kt_eff = torch.minimum(torch.full_like(fn_el, params.kt),
                           mu * fn_est / vt_norm.clamp(min=1e-3))

    d_xy = xy - anchor
    d3 = torch.cat([d_xy, torch.zeros_like(d_xy[..., :1])], dim=-1)
    d_t = d3 - torch.sum(d3 * n, dim=-1, keepdim=True) * n
    dn = torch.linalg.norm(d_t, dim=-1)
    budget = (mu * fn_est - kt_eff * vt_norm).clamp(min=0.0)
    cf = torch.clamp(budget / (params.kt_spring * dn).clamp(min=1e-9), max=1.0)
    f_spring = -params.kt_spring * (cf * active)[..., None] * d_t

    f_el = fn_el[..., None] * n * active[..., None] + f_spring
    new_anchor = torch.where(active[..., None] > 0.0, xy - cf[..., None] * d_xy, xy)
    return ContactResult(f_el=f_el, n=n, kt=kt_eff * active,
                         kd_minus_kt=(kd_g - kt_eff) * active,
                         depth=depth, anchor=new_anchor)
