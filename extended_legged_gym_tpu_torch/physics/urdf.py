"""URDF -> :class:`RobotModel` loader (port of ``physics/urdf.py``), in host
numpy.

The parser follows Isaac Gym's asset pipeline where the engine can:
* fixed joints are always collapsed: a fixed child's inertia is merged into
  its nearest movable ancestor by the parallel-axis theorem and its
  collision geometry re-expressed in that body's frame;
* collision boxes and cylinders are packed with spheres (contact is
  sphere-vs-terrain); spheres are kept as they are;
* mesh collision shapes are skipped;
* revolute, continuous and prismatic joints become the model's joints (a
  continuous joint is revolute), in depth-first order from the root.
"""
from __future__ import annotations

import dataclasses
import sys
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .model import RobotModel

# a joint's limits where its URDF gives none
_NO_LIMIT = {"lower": -1e9, "upper": 1e9, "velocity": 1e9, "effort": 1e9}


def rpy_to_matrix(rpy) -> np.ndarray:
    """URDF fixed-axis roll-pitch-yaw to a rotation matrix (Rz @ Ry @ Rx)."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


@dataclass
class _Link:
    name: str
    mass: float = 0.0
    com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    inertia: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))
    # collision spheres in the link frame: (offset [3], radius, source link)
    spheres: List[Tuple[np.ndarray, float, str]] = field(default_factory=list)


@dataclass
class _Joint:
    name: str
    jtype: str
    parent: str
    child: str
    origin_rot: np.ndarray
    origin_pos: np.ndarray
    axis: np.ndarray
    lower: float
    upper: float
    velocity: float
    effort: float


def _parse_origin(elem) -> Tuple[np.ndarray, np.ndarray]:
    if elem is None:
        return np.eye(3), np.zeros(3)
    xyz = np.array([float(x) for x in elem.get("xyz", "0 0 0").split()])
    rpy = [float(x) for x in elem.get("rpy", "0 0 0").split()]
    return rpy_to_matrix(rpy), xyz


def _pack_spheres(geom, rot: np.ndarray, pos: np.ndarray, link: str):
    """Spheres (link frame) standing in for a URDF collision primitive: a
    sphere itself; a cylinder as up to 6 spheres of its radius along its z
    axis; a box as a grid of up to 2 per axis of its half-extent's smallest
    component."""
    out = []
    tag = geom.tag
    if tag == "sphere":
        out.append((pos, float(geom.get("radius")), link))
    elif tag == "cylinder":
        r = float(geom.get("radius"))
        length = float(geom.get("length"))
        n = min(max(1, int(np.ceil(length / (2.0 * r)))), 6)
        half = length / 2 - min(r, length / 2)
        zs = np.linspace(-half, half, n) if n > 1 else [0.0]
        for z in zs:
            out.append((pos + rot @ np.array([0.0, 0.0, z]), r, link))
    elif tag == "box":
        h = np.array([float(x) for x in geom.get("size").split()]) / 2.0
        r = float(np.min(h))
        counts = np.minimum(np.maximum((h / r).round().astype(int), 1), 2)
        axes = [np.linspace(-h[k] + r, h[k] - r, counts[k]) if counts[k] > 1 else [0.0]
                for k in range(3)]
        for x in axes[0]:
            for y in axes[1]:
                for z in axes[2]:
                    out.append((pos + rot @ np.array([x, y, z]), r, link))
    return out


def _parse_urdf(path: str):
    robot = ET.parse(path).getroot()
    links: Dict[str, _Link] = {}
    joints: List[_Joint] = []
    for le in robot.findall("link"):
        link = _Link(name=le.get("name"))
        ie = le.find("inertial")
        if ie is not None:
            rot, pos = _parse_origin(ie.find("origin"))
            link.mass = float(ie.find("mass").get("value"))
            link.com = pos
            ine = ie.find("inertia")
            g = lambda k, d=None: float(ine.get(k, d))
            I = np.array([[g("ixx"), g("ixy", 0), g("ixz", 0)],
                          [g("ixy", 0), g("iyy"), g("iyz", 0)],
                          [g("ixz", 0), g("iyz", 0), g("izz")]])
            # the tensor is given in the inertial frame: rotate it into the link's
            link.inertia = rot @ I @ rot.T
        for ce in le.findall("collision"):
            rot, pos = _parse_origin(ce.find("origin"))
            ge = ce.find("geometry")
            if ge is None:
                continue
            for prim in ge:
                link.spheres.extend(_pack_spheres(prim, rot, pos, link.name))
        links[le.get("name")] = link

    for je in robot.findall("joint"):
        rot, pos = _parse_origin(je.find("origin"))
        ax = je.find("axis")
        axis = (np.array([float(x) for x in ax.get("xyz").split()]) if ax is not None
                else np.array([1.0, 0.0, 0.0]))
        lim = je.find("limit")
        get = lambda k: float(lim.get(k, _NO_LIMIT[k])) if lim is not None else _NO_LIMIT[k]
        joints.append(_Joint(je.get("name"), je.get("type"), je.find("parent").get("link"),
                             je.find("child").get("link"), rot, pos, axis, get("lower"),
                             get("upper"), get("velocity"), get("effort")))
    return links, joints


def _merge_into(body: _Link, rot: np.ndarray, pos: np.ndarray, link: _Link):
    """Fold ``link`` (its frame at ``rot, pos`` in ``body``'s frame) into
    ``body``: masses, COMs and inertias by the parallel-axis theorem, and the
    spheres."""
    m2 = link.mass
    if m2 > 0:
        com2 = pos + rot @ link.com
        m1 = body.mass
        com = (m1 * body.com + m2 * com2) / max(m1 + m2, 1e-12)
        shift = lambda I, m, d: I + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
        body.inertia = (shift(body.inertia, m1, body.com - com)
                        + shift(rot @ link.inertia @ rot.T, m2, com2 - com))
        body.com = com
        body.mass = m1 + m2
    for off, r, src in link.spheres:
        body.spheres.append((pos + rot @ off, r, src))


def load_urdf(path: str, default_joint_angles: Optional[Dict[str, float]] = None,
              armature: float = 0.0, base_init_height: float = 0.6,
              fix_base: bool = False) -> RobotModel:
    """The :class:`RobotModel` of a URDF, without feet (:func:`attach_feet`).
    ``default_joint_angles`` maps joint names (exact, else the first key that
    is a substring of the name) to the default pose; ``armature`` is every
    joint's rotor armature."""
    links, joints = _parse_urdf(path)
    child_names = {j.child for j in joints}
    roots = [n for n in links if n not in child_names]
    if len(roots) != 1:
        roots = [r for r in roots if "base" in r] or roots
    root = roots[0]
    joints_by_parent: Dict[str, List[_Joint]] = {}
    for j in joints:
        joints_by_parent.setdefault(j.parent, []).append(j)

    body_names: List[str] = []
    body_parent: List[int] = []
    joint_list: List[Optional[_Joint]] = []
    merged: List[_Link] = []

    def build(link_name: str, parent_body: int, via: Optional[_Joint]):
        body_idx = len(body_names)
        src = links[link_name]
        body = _Link(name=link_name, mass=src.mass, com=src.com.copy(),
                     inertia=src.inertia.copy(), spheres=list(src.spheres))
        body_names.append(link_name)
        body_parent.append(parent_body)
        joint_list.append(via)
        merged.append(body)
        # depth first: fixed children merge into this body, movable ones recurse
        stack = [(link_name, np.eye(3), np.zeros(3))]
        while stack:
            cur, R_cur, p_cur = stack.pop()
            for j in joints_by_parent.get(cur, []):
                R_j = R_cur @ j.origin_rot
                p_j = p_cur + R_cur @ j.origin_pos
                if j.jtype == "fixed":
                    _merge_into(body, R_j, p_j, links[j.child])
                    stack.append((j.child, R_j, p_j))
                elif j.jtype in ("revolute", "continuous", "prismatic"):
                    # the joint's origin re-rooted in the merged body's frame
                    build(j.child, body_idx, _Joint(j.name, j.jtype, body.name, j.child, R_j, p_j,
                                                    j.axis, j.lower, j.upper, j.velocity,
                                                    j.effort))
                else:
                    raise ValueError(f"unsupported joint type {j.jtype}")

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(10000)
    try:
        build(root, -1, None)
    finally:
        sys.setrecursionlimit(old_limit)

    nb = len(body_names)
    nj = nb - 1
    joint_origin_rot = np.tile(np.eye(3), (nb, 1, 1))
    joint_origin_pos = np.zeros((nb, 3))
    joint_axis = np.zeros((nb, 3))
    dof_limits, dof_vel, dof_eff = np.zeros((nj, 2)), np.zeros(nj), np.zeros(nj)
    joint_names: List[str] = []
    for i in range(1, nb):
        j = joint_list[i]
        joint_names.append(j.name)
        joint_origin_rot[i] = j.origin_rot
        joint_origin_pos[i] = j.origin_pos
        joint_axis[i] = j.axis / np.linalg.norm(j.axis)      # in the child's frame
        dof_limits[i - 1] = [j.lower, j.upper]
        dof_vel[i - 1] = j.velocity
        dof_eff[i - 1] = j.effort

    geom_body, geom_offset, geom_radius, geom_links = [], [], [], []
    for bi, b in enumerate(merged):
        for off, r, src in b.spheres:
            geom_body.append(bi)
            geom_offset.append(off)
            geom_radius.append(r)
            geom_links.append(src)
    if not geom_body:
        geom_body, geom_offset, geom_radius, geom_links = [0], [np.zeros(3)], [0.02], [body_names[0]]

    anc = np.zeros((nb, nj), dtype=np.float32)          # anc[b, j]: joint j on base -> b
    for b in range(1, nb):
        cur = b
        while cur > 0:
            anc[b, cur - 1] = 1.0
            cur = body_parent[cur]

    ddp = np.zeros(nj)
    if default_joint_angles:
        for i, jn in enumerate(joint_names):
            if jn in default_joint_angles:
                ddp[i] = default_joint_angles[jn]
            else:
                for k, v in default_joint_angles.items():
                    if k in jn:
                        ddp[i] = v
                        break

    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return RobotModel(
        nb=nb, nj=nj, body_names=tuple(body_names), joint_names=tuple(joint_names),
        parent=tuple(body_parent),
        joint_types=tuple("prismatic" if j.jtype == "prismatic" else "revolute"
                          for j in joint_list[1:]),
        fix_base=bool(fix_base), geom_links=tuple(geom_links), foot_names=(),
        joint_origin_rot=f32(joint_origin_rot), joint_origin_pos=f32(joint_origin_pos),
        joint_axis=f32(joint_axis), mass=f32([b.mass for b in merged]),
        com=f32(np.stack([b.com for b in merged])),
        inertia=f32(np.stack([b.inertia for b in merged])), armature=f32(np.full(nj, armature)),
        dof_pos_limits=f32(dof_limits), dof_vel_limits=f32(dof_vel), torque_limits=f32(dof_eff),
        default_dof_pos=f32(ddp), geom_body=np.asarray(geom_body, dtype=np.int32),
        geom_offset=f32(np.stack(geom_offset)), geom_radius=f32(np.array(geom_radius)),
        foot_body=np.zeros((0,), dtype=np.int32), foot_offset=np.zeros((0, 3), dtype=np.float32),
        foot_radius=np.zeros((0,), dtype=np.float32), foot_geom=np.zeros((0,), dtype=np.int32),
        ancestor_mask=f32(anc), base_init_height=f32(base_init_height))


def attach_feet(model: RobotModel, foot_name: str) -> RobotModel:
    """``model`` with its foot sites: the collision spheres whose source link
    name contains ``foot_name``, one per source link (its last sphere), in
    sorted link-name order."""
    sites: Dict[str, int] = {}
    for gi, src in enumerate(model.geom_links):
        if foot_name in src:
            sites[src] = gi
    names = sorted(sites)
    fg = [sites[n] for n in names]
    return dataclasses.replace(
        model, _tensors={},
        foot_body=np.asarray(np.asarray(model.geom_body)[fg], dtype=np.int32),
        foot_offset=np.asarray(np.asarray(model.geom_offset)[fg], dtype=np.float32).reshape(-1, 3),
        foot_radius=np.asarray(np.asarray(model.geom_radius)[fg], dtype=np.float32),
        foot_geom=np.asarray(fg, dtype=np.int32), foot_names=tuple(names))
