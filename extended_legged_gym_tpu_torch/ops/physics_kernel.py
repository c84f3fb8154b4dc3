"""Fused, decimated physics step on flat ground or a heightfield (port of
``ops/physics_kernel.py``).

:func:`make_decimated_env_step` is the counterpart of the JAX function of the
same name: PD torques plus ``decimation`` physics substeps per call.  The
returned :class:`DecimatedEnvStep` takes ``(phys, actions, env_params)`` and
returns ``(new_phys, tau_last, report)``:

* on CUDA tensors it launches one hand-written kernel of
  ``csrc/physics_step.cu`` once per call (or raises): B1 on a flat terrain,
  B2 on a heightfield, whose corner-packed texture it keeps on the device;
  a fixed-base model (``model.fix_base``: zero base acceleration, no 6x6
  base solve) runs the same kernels with the int table's fixed-base flag;
* on CPU tensors it runs the plain version, ``physics/aba.py`` once per
  substep.

:func:`make_env_step` and :func:`make_env_step_rough` are the V-control
routes: one physics substep per call with the torques passed in, the same
kernels launched with ``decimation = 1``, direct torques and action scale 1
(:class:`EnvStep`, counted apart from the fused control steps).

A terrain with a ceiling or with contacts on its triangle mesh is refused:
the kernels have no ceiling branch and their contact assumes a
heightfield; the env steps such scenes with ``physics/engine.EngineEnvStep``
(the JAX env likewise leaves its fused step for the XLA engine there).

On a heightfield the JAX package's fused step carries each geom's position
from the previous control step and samples one tangent plane there per
control step; the port's B2, like the ABA engine, samples the heightfield at
the current geom position in every substep, so the env state has no
``geom_pos``.

The kernel is built with nvcc into a shared library with a plain C interface
at first use and loaded with ctypes; the build goes into ``_build/`` beside
this package.  The model reaches the kernel as two small device tables, one of
floats and one of ints, whose layout mirrors the offsets in the CUDA source.
The kernel runs one warp per env with the env's working set in shared memory;
:func:`workspace_words` mirrors its layout, so the wrapper sizes the launch
from the model and refuses a model whose block would not fit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np
import torch

from ..physics.aba import aba_physics_step, foot_geoms
from ..physics.engine import EnvPhysParams, PhysState, SimParams, StepReport
from ..physics.model import RobotModel
from ..terrain.heightfield import TerrainData, flat_terrain
from ..utils.tree import tree_map

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "physics_step.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# table layout, mirrored from csrc/physics_step.cu
MAX_NB, MAX_NJ, MAX_NG, MAX_NF = 32, 31, 64, 8
TI_NB, TI_NJ, TI_NG, TI_NF, TI_DECIM, TI_CTRL, TI_TH, TI_TW = range(8)
TI_PARENT = 8
TI_GBODY = TI_PARENT + MAX_NB
TI_FGEOM = TI_GBODY + MAX_NG
TI_SIZE = TI_FGEOM + MAX_NF
# the schedule after TI_SIZE: depths, bodies by level, geom slots, children
TI_DEPTH = TI_SIZE
TI_LVL = TI_DEPTH + MAX_NB
TI_LOFF = TI_LVL + MAX_NB
TI_GOFF = TI_LOFF + MAX_NB + 1
TI_GSLOT = TI_GOFF + MAX_NB + 1
TI_COFF = TI_GSLOT + MAX_NG
TI_CLIST = TI_COFF + MAX_NB + 1
TI_FIX = TI_CLIST + MAX_NB - 1          # the fixed-base flag, after the children
TI_MAXD = TI_FIX + 1
TI_FULL = TI_MAXD + 1
TF_DT, TF_G, TF_KP, TF_KD, TF_KT, TF_MU, TF_KTS, TF_JDAMP, TF_H0, TF_ASCALE = (
    0, 1, 4, 5, 6, 7, 8, 9, 10, 11)
TF_JROT = 16
TF_JPOS = TF_JROT + MAX_NB * 9
TF_JAXIS = TF_JPOS + MAX_NB * 3
TF_ISP = TF_JAXIS + MAX_NB * 3
TF_IUNIT0 = TF_ISP + MAX_NB * 36
TF_MASS = TF_IUNIT0 + 36
TF_COM = TF_MASS + MAX_NB
TF_ARM = TF_COM + MAX_NB * 3
TF_TLIM = TF_ARM + MAX_NJ
TF_VLIM = TF_TLIM + MAX_NJ
TF_PGAIN = TF_VLIM + MAX_NJ
TF_DGAIN = TF_PGAIN + MAX_NJ
TF_DDP = TF_DGAIN + MAX_NJ
TF_GOFF = TF_DDP + MAX_NJ
TF_GRAD = TF_GOFF + MAX_NG * 3
TF_FOFF = TF_GRAD + MAX_NG
TF_HS = TF_FOFF + MAX_NF * 3
TF_ORG = TF_HS + 1
TF_GMAX = TF_ORG + 2
TF_SIZE = TF_GMAX + 2
CONTROL_TYPES = {"P": 0, "T": 1}

# launch geometry and per-env workspace, mirrored from csrc/physics_step.cu
ENVS_PER_BLOCK = 4                      # one warp per env
SMEM_PER_BLOCK = 232448                 # shared memory one H100 block can use (227 KB)
BSTR, GC_STR = 92, 28                   # words per body block, per geom's terms

_libs = {}
_build_logs = {}


def _skew_np(v):
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]])


def _spatial_inertia_np(inertia, com, m):
    cx = _skew_np(com)
    return np.block([[inertia + m * (cx @ cx.T), m * cx], [m * cx.T, m * np.eye(3)]])


def build_library(source: str = SOURCE, extra_flags=()) -> str:
    """Compile ``source`` (by default ``csrc/physics_step.cu``) with nvcc and
    ``extra_flags`` into ``_build/`` unless a library of the same source and
    flags is there.  Returns its path."""
    flags = NVCC_FLAGS + list(extra_flags)
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libphysics_step_{digest}.so")
    if os.path.exists(path):
        return path
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the physics kernel")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *flags, "-o", tmp, source],
                              capture_output=True, text=True, timeout=600)
        log = _build_logs[(source, tuple(extra_flags))] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def build_log(source: str = SOURCE, extra_flags=()) -> str:
    """nvcc's output (with the ``-Xptxas -v`` register and spill report) from
    this process's build of ``source``; empty if its library was already built."""
    return _build_logs.get((source, tuple(extra_flags)), "")


def load_library(source: str = SOURCE, extra_flags=()) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library of ``source`` (with
    ``extra_flags``); check its table layout."""
    key = (source, tuple(extra_flags))
    if key not in _libs:
        lib = ctypes.CDLL(build_library(source, extra_flags))
        lib.physics_table_layout.argtypes = [ctypes.c_void_p]
        lib.physics_table_layout.restype = ctypes.c_int
        lib.physics_decimated_step.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_void_p]
        lib.physics_decimated_step.restype = ctypes.c_int
        lib.physics_decimated_step_rough.argtypes = ([ctypes.c_void_p] * 12
                                                     + [ctypes.c_int, ctypes.c_void_p])
        lib.physics_decimated_step_rough.restype = ctypes.c_int
        try:
            lib.physics_workspace_bytes.argtypes = [ctypes.c_int] * 5
            lib.physics_workspace_bytes.restype = ctypes.c_int
            lib.physics_set_workspace_bytes.argtypes = [ctypes.c_int]
            lib.physics_set_workspace_bytes.restype = ctypes.c_int
            if lib.physics_int_table_size() != TI_FULL:
                raise RuntimeError(f"kernel int table of {lib.physics_int_table_size()} entries "
                                   f"!= wrapper's {TI_FULL}")
            lib.shared_workspace = True
        except AttributeError:          # an older source: one thread per env, no workspace
            lib.shared_workspace = False
        try:
            lib.fixed_base = lib.physics_has_fixed_base() == 1
        except AttributeError:          # an older source, which ignores TI_FIX
            lib.fixed_base = False
        layout = (ctypes.c_int * 6)()
        lib.physics_table_layout(ctypes.addressof(layout))
        want = (MAX_NB, MAX_NJ, MAX_NG, MAX_NF, TI_SIZE, TF_SIZE)
        if tuple(layout) != want:
            raise RuntimeError(f"kernel table layout {tuple(layout)} != wrapper's {want}")
        _libs[key] = lib
    return _libs[key]


def workspace_words(nb: int, nj: int, ng: int, nf: int, rough: bool = False) -> int:
    """4-byte words of one env's working set in the kernel's shared memory
    (``ws_layout`` in the CUDA source): per body a block of ``BSTR`` words
    (articulated inertia, frame, joint rotation, position, velocity, bias
    velocity, acceleration, bias force, U, 1/D, u); the state row, actions,
    torques, joint accelerations, friction and mass delta; the base's inertia
    at the env's mass; per geom its damper and wrench terms (reused for each
    body's terms for its parent in the backward sweep, then for the report)
    and the report stash."""
    up4 = lambda n: (n + 3) // 4 * 4          # 16-byte aligned regions
    o = up4(BSTR * nb + (13 + 2 * nj + 2 * ng) + 3 * nj + 2) + 36
    o = up4(o) + GC_STR * max(ng, nb) + (13 if rough else 9) * ng
    return up4(o)


def block_shared_bytes(nb: int, nj: int, ng: int, nf: int, rough: bool = False) -> int:
    """Dynamic shared memory of one block: ``ENVS_PER_BLOCK`` env workspaces
    and a copy of the model tables; raises ``ValueError`` with the model's
    sizes if a block cannot hold it."""
    nbytes = ENVS_PER_BLOCK * 4 * workspace_words(nb, nj, ng, nf, rough) + 4 * (TF_SIZE + TI_FULL)
    if nbytes > SMEM_PER_BLOCK:
        raise ValueError(f"model sizes nb={nb} nj={nj} ng={ng} nf={nf}: a block of "
                         f"{ENVS_PER_BLOCK} envs needs {nbytes} bytes of shared memory, "
                         f"more than the {SMEM_PER_BLOCK} a block can use")
    return nbytes


def _write_schedule(ti: np.ndarray, parent: np.ndarray, geom_body: np.ndarray):
    """The kernel's tree schedule into the int table: each body's depth, the
    bodies by depth (then index) with the first slot of each depth, each
    geom's slot (geoms body by body, then by index) with each body's first
    slot, each body's children (by index) with each body's first entry, and
    the deepest depth."""
    nb, ng = len(parent), len(geom_body)
    depth = np.zeros(nb, np.int32)
    for i in range(1, nb):
        depth[i] = depth[parent[i]] + 1
    ti[TI_DEPTH:TI_DEPTH + nb] = depth
    ti[TI_LVL:TI_LVL + nb] = np.lexsort((np.arange(nb), depth))
    ti[TI_LOFF:TI_LOFF + nb + 1] = [int((depth < d).sum()) for d in range(nb + 1)]
    ti[TI_GOFF:TI_GOFF + nb + 1] = [int((geom_body < b).sum()) for b in range(nb + 1)]
    ti[TI_GSLOT + np.lexsort((np.arange(ng), geom_body))] = np.arange(ng)
    ti[TI_COFF:TI_COFF + nb + 1] = [int((parent[1:] < b).sum()) for b in range(nb + 1)]
    ti[TI_CLIST:TI_CLIST + nb - 1] = 1 + np.lexsort((np.arange(nb - 1), parent[1:]))
    # nb - 1 <= MAX_NB - 1 children: the list ends before TI_FIX
    ti[TI_MAXD] = depth.max()


def control_step_flops(nb: int, nj: int, ng: int, nf: int, decimation: int,
                       rough: bool = False, fix_base: bool = False) -> int:
    """Float operations one env's control step needs (PD torques, clamps and
    ``decimation`` substeps; the report on the last).  Each add, multiply,
    min/max, divide, square root, sine, cosine or floor counts one.  The 6x6
    and 3x3 products are counted blockwise: zero blocks, the zeros of skew
    matrices and the mirrored half of symmetric results cost nothing.
    ``rough`` counts B2: the heightfield sample and the general normal;
    ``fix_base`` drops the base work a fixed base skips: the 6x6 solve, the
    mass delta, body 0's IA v, v x* (IA v) and gravity wrench, and the base's
    world acceleration."""
    per_sub = (13 * nj               # torques and clamp (7); joint integration (6)
               + 407                 # base frame (60), mass delta (43), 6x6 Cholesky solve (175),
                                     # base integration and exp-map quaternion (129)
               + 129 * nb            # IA v and v x* (IA v) (96); gravity wrench (33)
               + 864 * (nb - 1)      # per joint: sin, cos, Rodrigues (36), two 3x3 rotation
                                     # products (90), position (18), velocity (48), bias (18);
                                     # backward sweep: U, d, u (47), Ia = IA - U U^T / d (48),
                                     # Ia c + U u / d (84), X^T Ia X blockwise (360), X^T pa (48);
                                     # forward sweep (67)
               + 247 * ng)           # per geom: point position and velocity (45); penalty,
                                     # caps and stiction (50); wrench (37); damper dt Ds (115)
    if fix_base:
        per_sub -= 175 + 43 + 129 + 42   # no base solve, mass delta or body 0 terms; no base
                                         # world acceleration (cross, 3 adds, two 3x3 products)
    report = nf * 45 + ng * 76       # foot kinematics; implicit-consistent geom forces
    if rough:
        per_sub += 98 * ng           # per geom: grid coordinates, clip and floor (12), bilinear
                                     # height (13), gradient (12), normal (8); v.n, tangential
                                     # velocity and its norm (13); projected anchor displacement
                                     # (10); elastic force along n (7); D v with a general n (8);
                                     # n in body coordinates (15)
        report += 13 * ng            # D v_new with a general n
    return decimation * per_sub + report


def control_step_bytes(nj: int, ng: int, nf: int, decimation: int, rough: bool = False) -> int:
    """Bytes one env's control step must move: its state read and written,
    actions, friction and mass delta read, torques, geom forces and foot
    kinematics written (float32), and for B2 one 16-byte corner read per geom
    per substep (the texture cells the geoms touch; the tables are extra, once
    per launch)."""
    ns = 13 + 2 * nj + 2 * ng
    per_env = 4 * (2 * ns + 2 * nj + 2 + 3 * ng + 6 * nf)
    return per_env + (16 * ng * decimation if rough else 0)


class DecimatedEnvStep:
    """One control step of B envs: PD (or direct) torques, clamped to the
    model's torque limits, and ``decimation`` physics substeps, on flat ground
    (kernel B1) or on a heightfield (kernel B2).  ``launches`` counts the B1
    launches of all instances of the class, ``rough_launches`` the B2
    launches, ``fixed_launches`` the launches of either with a fixed base
    (which count in neither of the others; :class:`EnvStep` keeps its
    own)."""

    launches = 0
    rough_launches = 0
    fixed_launches = 0

    def __init__(self, model: RobotModel, sp: SimParams, terrain: TerrainData, decimation: int,
                 p_gains, d_gains, default_dof_pos, action_scale: float,
                 control_type: str = "P"):
        if control_type not in CONTROL_TYPES:
            raise NotImplementedError(f"fused step supports control types P and T, not {control_type}")
        if sp.solver not in ("aba", "pallas"):
            raise ValueError(f"the fused step is the ABA step: SimParams.solver must be 'aba', "
                             f"not {sp.solver!r} ('pallas' is the env's name for it)")
        if any(t != "revolute" for t in model.joint_types):
            raise NotImplementedError("the kernel takes revolute-joint robots")
        if terrain.has_ceiling or terrain.contact_trimesh:
            raise ValueError("the fused kernel has no ceiling or triangle-mesh contacts; such "
                             "scenes take physics/engine.EngineEnvStep")
        fg = foot_geoms(model)
        nb, nj, ng, nf = model.nb, model.nj, model.ng, len(fg)
        if nb > MAX_NB or nj > MAX_NJ or ng > MAX_NG or nf > MAX_NF:
            raise ValueError(f"model sizes nb={nb} nj={nj} ng={ng} nf={nf} exceed the kernel's "
                             f"maxima {MAX_NB}/{MAX_NJ}/{MAX_NG}/{MAX_NF}")
        self.rough = not terrain.is_flat
        block_shared_bytes(nb, nj, ng, nf, self.rough)     # raises if a block cannot hold it
        self.ws_bytes = 4 * workspace_words(nb, nj, ng, nf, self.rough)
        self._ws_checked = set()
        if self.rough and terrain.shape[0] * terrain.shape[1] >= 2 ** 31:
            raise ValueError(f"heightfield {terrain.shape} too large for the kernel's int index")
        self.model, self.sp, self.terrain = model, sp, terrain
        self.decimation, self.action_scale, self.control_type = decimation, float(action_scale), control_type
        self.nf = nf
        self.NS = 13 + 2 * nj + 2 * ng
        tl = model.torque_limits
        # the joint velocity clamp: the model's limits capped at 500 rad/s,
        # or 500 rad/s with sp.enforce_dof_vel_limits off (the plain step's)
        vl = (np.minimum(model.dof_vel_limits, 500.0) if sp.enforce_dof_vel_limits
              else np.full(nj, 500.0, np.float32))
        self._host = dict(p=np.asarray(p_gains, np.float32), d=np.asarray(d_gains, np.float32),
                          ddp=np.asarray(default_dof_pos, np.float32), tl=np.asarray(tl, np.float32))
        self._dev = {}

        ti = np.zeros(TI_FULL, np.int32)
        ti[[TI_NB, TI_NJ, TI_NG, TI_NF, TI_DECIM, TI_CTRL, TI_TH, TI_TW]] = (
            nb, nj, ng, nf, decimation, CONTROL_TYPES[control_type], *terrain.shape)
        ti[TI_PARENT:TI_PARENT + nb] = model.parent
        ti[TI_GBODY:TI_GBODY + ng] = model.geom_body
        ti[TI_FGEOM:TI_FGEOM + nf] = fg
        _write_schedule(ti, np.asarray(model.parent), np.asarray(model.geom_body))
        ti[TI_FIX] = int(model.fix_base)
        tf = np.zeros(TF_SIZE, np.float64)
        c = sp.contact
        tf[TF_DT] = sp.dt
        tf[TF_G:TF_G + 3] = sp.gravity
        tf[[TF_KP, TF_KD, TF_KT, TF_MU, TF_KTS, TF_JDAMP, TF_H0, TF_ASCALE]] = (
            c.kp, c.kd, c.kt, c.mu * terrain.friction, c.kt_spring, sp.joint_damping,
            terrain.height00, action_scale)
        tf[TF_HS] = terrain.hscale
        tf[TF_ORG:TF_ORG + 2] = terrain.origin
        tf[TF_GMAX:TF_GMAX + 2] = (terrain.shape[0] - 1.001, terrain.shape[1] - 1.001)
        for i in range(nb):
            tf[TF_JROT + 9 * i:TF_JROT + 9 * i + 9] = model.joint_origin_rot[i].reshape(-1)
            tf[TF_JPOS + 3 * i:TF_JPOS + 3 * i + 3] = model.joint_origin_pos[i]
            tf[TF_JAXIS + 3 * i:TF_JAXIS + 3 * i + 3] = model.joint_axis[i]
            tf[TF_ISP + 36 * i:TF_ISP + 36 * i + 36] = _spatial_inertia_np(
                model.inertia[i].astype(np.float64), model.com[i].astype(np.float64),
                float(model.mass[i])).reshape(-1)
            tf[TF_COM + 3 * i:TF_COM + 3 * i + 3] = model.com[i]
        tf[TF_IUNIT0:TF_IUNIT0 + 36] = _spatial_inertia_np(
            np.zeros((3, 3)), model.com[0].astype(np.float64), 1.0).reshape(-1)
        tf[TF_MASS:TF_MASS + nb] = model.mass
        for off, vals in ((TF_ARM, model.armature), (TF_TLIM, tl), (TF_VLIM, vl),
                          (TF_PGAIN, p_gains), (TF_DGAIN, d_gains), (TF_DDP, default_dof_pos)):
            tf[off:off + nj] = np.asarray(vals, np.float64)
        tf[TF_GOFF:TF_GOFF + 3 * ng] = model.geom_offset.reshape(-1)
        tf[TF_GRAD:TF_GRAD + ng] = model.geom_radius
        tf[TF_FOFF:TF_FOFF + 3 * nf] = model.foot_offset[:nf].reshape(-1)
        self.tf_host = tf.astype(np.float32)
        self.ti_host = ti

    # ---------------------------------------------------------------- helpers
    def _tensors(self, device: torch.device):
        key = str(device)
        if key not in self._dev:
            t = {k: torch.as_tensor(v, device=device) for k, v in self._host.items()}
            t["tf"] = torch.as_tensor(self.tf_host, device=device)
            t["ti"] = torch.as_tensor(self.ti_host, device=device)
            if self.rough:
                t["tex"] = self.terrain.torch(device)["corner_tex"]
            self._dev[key] = t
        return self._dev[key]

    def pd_torques(self, scaled_actions: torch.Tensor, phys: PhysState) -> torch.Tensor:
        """Joint torques for already scaled actions, clamped to the limits."""
        t = self._tensors(scaled_actions.device)
        if self.control_type == "P":
            tau = t["p"] * (scaled_actions + t["ddp"] - phys.joint_pos) - t["d"] * phys.joint_vel
        else:
            tau = scaled_actions
        return torch.maximum(torch.minimum(tau, t["tl"]), -t["tl"])

    def plain(self, phys: PhysState, actions: torch.Tensor, env_params: EnvPhysParams,
              dtype: Optional[torch.dtype] = None):
        """The plain version: torques then ``aba_physics_step``, per substep;
        with ``dtype`` (``torch.float64``) computed in that type and returned
        as float32."""
        if dtype is not None:
            cast = lambda x: x.to(dtype)
            out = self.plain(tree_map(cast, phys), cast(actions), tree_map(cast, env_params))
            return tree_map(lambda x: x.to(torch.float32), out)
        scaled = actions * self.action_scale
        for _ in range(self.decimation):
            tau = self.pd_torques(scaled, phys)
            phys, report = aba_physics_step(self.model, self.terrain, self.sp, phys, tau, env_params)
        return phys, tau, report

    def _check(self, phys: PhysState, actions: torch.Tensor, env_params: EnvPhysParams):
        B, nj, ng = phys.base_pos.shape[0], self.model.nj, self.model.ng
        want = dict(base_pos=(B, 3), base_quat=(B, 4), joint_pos=(B, nj), base_lin_vel=(B, 3),
                    base_ang_vel=(B, 3), joint_vel=(B, nj), contact_anchor=(B, ng, 2),
                    actions=(B, nj), friction_scale=(B,), base_mass_delta=(B,))
        got = dict(actions=actions, friction_scale=env_params.friction_scale,
                   base_mass_delta=env_params.base_mass_delta,
                   **{k: getattr(phys, k) for k in want if hasattr(phys, k)})
        dev = phys.base_pos.device
        for name, shape in want.items():
            x = got[name]
            if tuple(x.shape) != shape or x.dtype != torch.float32 or x.device != dev:
                raise ValueError(f"{name}: expected float32 {shape} on {dev}, got "
                                 f"{x.dtype} {tuple(x.shape)} on {x.device}")

    # ---------------------------------------------------------------- call
    def __call__(self, phys: PhysState, actions: torch.Tensor, env_params: EnvPhysParams):
        self._check(phys, actions, env_params)
        if phys.base_pos.device.type == "cpu":
            return self.plain(phys, actions, env_params)
        if phys.base_pos.device.type != "cuda":
            raise ValueError(f"unsupported device {phys.base_pos.device}")
        return self.launch(phys, actions, env_params)

    def pack(self, phys: PhysState, actions: torch.Tensor, env_params: EnvPhysParams) -> dict:
        """The kernel's SoA inputs ``[rows, B]`` for these CUDA tensors and
        freshly allocated outputs."""
        dev = phys.base_pos.device
        B, nj, ng, nf = phys.base_pos.shape[0], self.model.nj, self.model.ng, self.nf
        state = torch.cat([phys.base_pos.T, phys.base_quat.T, phys.joint_pos.T,
                           phys.base_lin_vel.T, phys.base_ang_vel.T, phys.joint_vel.T,
                           phys.contact_anchor.reshape(B, 2 * ng).T]).contiguous()
        return dict(B=B, state=state, act=actions.T.contiguous(),
                    fric=env_params.friction_scale.contiguous(),
                    delta=env_params.base_mass_delta.contiguous(),
                    out=torch.empty(self.NS, B, device=dev), tau=torch.empty(nj, B, device=dev),
                    gf=torch.empty(3 * ng, B, device=dev), fpos=torch.empty(3 * nf, B, device=dev),
                    fvel=torch.empty(3 * nf, B, device=dev))

    def run(self, bufs: dict, lib: Optional[ctypes.CDLL] = None):
        """One launch of the kernel, B2 on a heightfield, else B1, on buffers
        from :meth:`pack`, on the current stream; counts it.  ``lib`` is a
        library from :func:`load_library`, by default the package's own
        source."""
        lib = lib or load_library()
        if self.model.fix_base and not lib.fixed_base:
            raise RuntimeError("this kernel build has no fixed-base regime (TI_FIX)")
        if lib.shared_workspace:
            if id(lib) not in self._ws_checked:
                got = lib.physics_workspace_bytes(self.model.nb, self.model.nj, self.model.ng,
                                                  self.nf, int(self.rough))
                if got != self.ws_bytes:
                    raise RuntimeError(f"kernel workspace {got} bytes != wrapper's {self.ws_bytes}")
                self._ws_checked.add(id(lib))
            rc = lib.physics_set_workspace_bytes(self.ws_bytes)
            if rc != 0:
                raise RuntimeError(f"setting the kernel's shared memory failed: cudaError {rc}")
        dev = bufs["state"].device
        t = self._tensors(dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
        ins = [bufs[k].data_ptr() for k in ("state", "act", "fric", "delta")]
        ins += [t["tf"].data_ptr(), t["ti"].data_ptr()]
        outs = [bufs[k].data_ptr() for k in ("out", "tau", "gf", "fpos", "fvel")]
        if self.rough:
            rc = lib.physics_decimated_step_rough(*ins, t["tex"].data_ptr(), *outs, bufs["B"], stream)
        else:
            rc = lib.physics_decimated_step(*ins, *outs, bufs["B"], stream)
        if rc != 0:
            raise RuntimeError(f"physics kernel {'B2' if self.rough else 'B1'} launch failed: "
                               f"cudaError {rc}")
        if self.model.fix_base:
            type(self).fixed_launches += 1
        elif self.rough:
            type(self).rough_launches += 1
        else:
            type(self).launches += 1

    def unpack(self, bufs: dict):
        """``(new_phys, tau_last, report)`` as views of :meth:`pack`'s outputs."""
        B, nj, ng, nf = bufs["B"], self.model.nj, self.model.ng, self.nf
        o = bufs["out"].T
        new_phys = PhysState(
            base_pos=o[:, 0:3], base_quat=o[:, 3:7], joint_pos=o[:, 7:7 + nj],
            base_lin_vel=o[:, 7 + nj:10 + nj], base_ang_vel=o[:, 10 + nj:13 + nj],
            joint_vel=o[:, 13 + nj:13 + 2 * nj],
            contact_anchor=o[:, 13 + 2 * nj:].reshape(B, ng, 2))
        report = StepReport(geom_forces=bufs["gf"].T.reshape(B, ng, 3),
                            foot_pos=bufs["fpos"].T.reshape(B, nf, 3),
                            foot_vel=bufs["fvel"].T.reshape(B, nf, 3))
        return new_phys, bufs["tau"].T, report

    def launch(self, phys: PhysState, actions: torch.Tensor, env_params: EnvPhysParams,
               lib: Optional[ctypes.CDLL] = None):
        """Run the CUDA kernel, B2 on a heightfield, else B1 (CUDA tensors
        only): pack, one launch, unpack."""
        bufs = self.pack(phys, actions, env_params)
        self.run(bufs, lib)
        return self.unpack(bufs)


def make_decimated_env_step(model: RobotModel, sp: SimParams, terrain: TerrainData,
                            decimation: int, p_gains, d_gains, default_dof_pos,
                            action_scale: float, control_type: str = "P") -> DecimatedEnvStep:
    """Fused decimated control step (JAX counterpart of the same name, without
    the rough-terrain geom-position carry): B1 on a flat terrain, B2 on a
    heightfield."""
    return DecimatedEnvStep(model, sp, terrain, decimation, p_gains, d_gains,
                            default_dof_pos, action_scale, control_type)


class EnvStep(DecimatedEnvStep):
    """One physics substep of B envs with the torques passed in (the V-control
    routes): the fused kernel at ``decimation = 1``, control T, action scale
    1; the torques are clamped to the model's limits as in the control step.
    Called as ``(phys, tau, env_params) -> (new_phys, report)``.
    ``EnvStep.launches`` counts its B1 launches, ``EnvStep.rough_launches``
    its B2 launches, ``EnvStep.fixed_launches`` those with a fixed base."""

    launches = 0
    rough_launches = 0
    fixed_launches = 0

    def __init__(self, model: RobotModel, sp: SimParams, terrain: TerrainData):
        zeros = np.zeros(model.nj, np.float32)
        super().__init__(model, sp, terrain, 1, zeros, zeros, zeros, 1.0, control_type="T")

    def __call__(self, phys: PhysState, tau: torch.Tensor, env_params: EnvPhysParams):
        new_phys, _, report = super().__call__(phys, tau, env_params)
        return new_phys, report


def make_env_step(model: RobotModel, sp: SimParams, terrain_height: float = 0.0,
                  friction: float = 1.0) -> EnvStep:
    """One flat physics substep per call with the torques passed in (JAX
    counterpart of the same name): B1 at ``decimation = 1`` against the plane
    at ``terrain_height``.  Unlike the Pallas B1 it applies the terrain's
    ``friction``, as the ABA engine does."""
    return EnvStep(model, sp, flat_terrain(friction=friction, height=terrain_height))


def make_env_step_rough(model: RobotModel, sp: SimParams, terrain: TerrainData) -> EnvStep:
    """One rough physics substep per call with the torques passed in (JAX
    counterpart of the same name, without the geom-position carry): B2 at
    ``decimation = 1``, sampling the heightfield at the current geom
    positions."""
    if terrain.is_flat:
        raise ValueError("make_env_step_rough takes a heightfield; use make_env_step on flat ground")
    return EnvStep(model, sp, terrain)
