"""Fused, decimated flat-terrain physics step (port of ``ops/physics_kernel.py``).

:func:`make_decimated_env_step` is the counterpart of the JAX function of the
same name: PD torques plus ``decimation`` physics substeps per call.  The
returned :class:`DecimatedEnvStep` takes ``(phys, actions, env_params)`` and
returns ``(new_phys, tau_last, report)``:

* on CUDA tensors it launches the hand-written kernel
  ``csrc/physics_step.cu`` once per call (or raises);
* on CPU tensors it runs the plain version, ``physics/aba.py`` once per
  substep.

The kernel is built with nvcc into a shared library with a plain C interface
at first use and loaded with ctypes; the build goes into ``_build/`` beside
this package.  The model reaches the kernel as two small device tables, one of
floats and one of ints, whose layout mirrors the offsets in the CUDA source.
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
from ..terrain.heightfield import TerrainData

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "physics_step.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# table layout, mirrored from csrc/physics_step.cu
MAX_NB, MAX_NJ, MAX_NG, MAX_NF = 32, 31, 64, 8
TI_NB, TI_NJ, TI_NG, TI_NF, TI_DECIM, TI_CTRL = range(6)
TI_PARENT = 8
TI_GBODY = TI_PARENT + MAX_NB
TI_FGEOM = TI_GBODY + MAX_NG
TI_SIZE = TI_FGEOM + MAX_NF
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
TF_SIZE = TF_FOFF + MAX_NF * 3
CONTROL_TYPES = {"P": 0, "T": 1}

_libs = {}
_build_logs = {}


def _skew_np(v):
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]])


def _spatial_inertia_np(inertia, com, m):
    cx = _skew_np(com)
    return np.block([[inertia + m * (cx @ cx.T), m * cx], [m * cx.T, m * np.eye(3)]])


def build_library(source: str = SOURCE) -> str:
    """Compile ``source`` (by default ``csrc/physics_step.cu``) with nvcc into
    ``_build/`` unless a library of the same source and flags is there.
    Returns its path."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
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
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, source],
                              capture_output=True, text=True, timeout=600)
        log = _build_logs[source] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def build_log(source: str = SOURCE) -> str:
    """nvcc's output (with the ``-Xptxas -v`` register and spill report) from
    this process's build of ``source``; empty if its library was already built."""
    return _build_logs.get(source, "")


def load_library(source: str = SOURCE) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library of ``source``; check its
    table layout."""
    if source not in _libs:
        lib = ctypes.CDLL(build_library(source))
        lib.physics_table_layout.argtypes = [ctypes.c_void_p]
        lib.physics_table_layout.restype = ctypes.c_int
        lib.physics_decimated_step.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_void_p]
        lib.physics_decimated_step.restype = ctypes.c_int
        layout = (ctypes.c_int * 6)()
        lib.physics_table_layout(ctypes.addressof(layout))
        want = (MAX_NB, MAX_NJ, MAX_NG, MAX_NF, TI_SIZE, TF_SIZE)
        if tuple(layout) != want:
            raise RuntimeError(f"kernel table layout {tuple(layout)} != wrapper's {want}")
        _libs[source] = lib
    return _libs[source]


def control_step_flops(nb: int, nj: int, ng: int, nf: int, decimation: int) -> int:
    """Float operations one env's control step needs (PD torques, clamps and
    ``decimation`` substeps; the report on the last).  Each add, multiply,
    min/max, divide, square root, sine or cosine counts one.  The 6x6 and 3x3
    products are counted blockwise: zero blocks, the zeros of skew matrices
    and the mirrored half of symmetric results cost nothing."""
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
    report = nf * 45 + ng * 76       # foot kinematics; implicit-consistent geom forces
    return decimation * per_sub + report


class DecimatedEnvStep:
    """One control step of B envs on flat ground: PD (or direct) torques,
    clamped to the model's torque limits, and ``decimation`` physics substeps.  ``DecimatedEnvStep.launches`` counts the
    kernel launches of all instances."""

    launches = 0

    def __init__(self, model: RobotModel, sp: SimParams, terrain: TerrainData, decimation: int,
                 p_gains, d_gains, default_dof_pos, action_scale: float,
                 control_type: str = "P"):
        if control_type not in CONTROL_TYPES:
            raise NotImplementedError(f"fused step supports control types P and T, not {control_type}")
        if any(t != "revolute" for t in model.joint_types) or model.fix_base:
            raise NotImplementedError("the kernel takes floating-base, revolute-joint robots")
        fg = foot_geoms(model)
        nb, nj, ng, nf = model.nb, model.nj, model.ng, len(fg)
        if nb > MAX_NB or nj > MAX_NJ or ng > MAX_NG or nf > MAX_NF:
            raise ValueError(f"model sizes nb={nb} nj={nj} ng={ng} nf={nf} exceed the kernel's "
                             f"maxima {MAX_NB}/{MAX_NJ}/{MAX_NG}/{MAX_NF}")
        self.model, self.sp, self.terrain = model, sp, terrain
        self.decimation, self.action_scale, self.control_type = decimation, float(action_scale), control_type
        self.nf = nf
        self.NS = 13 + 2 * nj + 2 * ng
        tl = model.torque_limits
        vl = np.minimum(model.dof_vel_limits, 500.0)
        self._host = dict(p=np.asarray(p_gains, np.float32), d=np.asarray(d_gains, np.float32),
                          ddp=np.asarray(default_dof_pos, np.float32), tl=np.asarray(tl, np.float32))
        self._dev = {}

        ti = np.zeros(TI_SIZE, np.int32)
        ti[[TI_NB, TI_NJ, TI_NG, TI_NF, TI_DECIM, TI_CTRL]] = (
            nb, nj, ng, nf, decimation, CONTROL_TYPES[control_type])
        ti[TI_PARENT:TI_PARENT + nb] = model.parent
        ti[TI_GBODY:TI_GBODY + ng] = model.geom_body
        ti[TI_FGEOM:TI_FGEOM + nf] = fg
        tf = np.zeros(TF_SIZE, np.float64)
        c = sp.contact
        tf[TF_DT] = sp.dt
        tf[TF_G:TF_G + 3] = sp.gravity
        tf[[TF_KP, TF_KD, TF_KT, TF_MU, TF_KTS, TF_JDAMP, TF_H0, TF_ASCALE]] = (
            c.kp, c.kd, c.kt, c.mu * terrain.friction, c.kt_spring, sp.joint_damping,
            terrain.height, action_scale)
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

    def plain(self, phys: PhysState, actions: torch.Tensor, env_params: EnvPhysParams):
        """The plain version: torques then ``aba_physics_step``, per substep."""
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

    def launch(self, phys: PhysState, actions: torch.Tensor, env_params: EnvPhysParams,
               lib: Optional[ctypes.CDLL] = None):
        """Run the CUDA kernel (CUDA tensors only); ``lib`` is a library from
        :func:`load_library`, by default the package's own source."""
        lib = lib or load_library()
        dev = phys.base_pos.device
        t = self._tensors(dev)
        B, nj, ng, nf = phys.base_pos.shape[0], self.model.nj, self.model.ng, self.nf
        state = torch.cat([phys.base_pos.T, phys.base_quat.T, phys.joint_pos.T,
                           phys.base_lin_vel.T, phys.base_ang_vel.T, phys.joint_vel.T,
                           phys.contact_anchor.reshape(B, 2 * ng).T]).contiguous()
        act = actions.T.contiguous()
        fric = env_params.friction_scale.contiguous()
        delta = env_params.base_mass_delta.contiguous()
        out = torch.empty(self.NS, B, device=dev)
        tau = torch.empty(nj, B, device=dev)
        gf = torch.empty(3 * ng, B, device=dev)
        fpos = torch.empty(3 * nf, B, device=dev)
        fvel = torch.empty(3 * nf, B, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.physics_decimated_step(
            state.data_ptr(), act.data_ptr(), fric.data_ptr(), delta.data_ptr(),
            t["tf"].data_ptr(), t["ti"].data_ptr(), out.data_ptr(), tau.data_ptr(),
            gf.data_ptr(), fpos.data_ptr(), fvel.data_ptr(), B, stream)
        if rc != 0:
            raise RuntimeError(f"physics kernel launch failed: cudaError {rc}")
        DecimatedEnvStep.launches += 1
        o = out.T
        new_phys = PhysState(
            base_pos=o[:, 0:3], base_quat=o[:, 3:7], joint_pos=o[:, 7:7 + nj],
            base_lin_vel=o[:, 7 + nj:10 + nj], base_ang_vel=o[:, 10 + nj:13 + nj],
            joint_vel=o[:, 13 + nj:13 + 2 * nj],
            contact_anchor=o[:, 13 + 2 * nj:].reshape(B, ng, 2))
        report = StepReport(geom_forces=gf.T.reshape(B, ng, 3),
                            foot_pos=fpos.T.reshape(B, nf, 3), foot_vel=fvel.T.reshape(B, nf, 3))
        return new_phys, tau.T, report


def make_decimated_env_step(model: RobotModel, sp: SimParams, terrain: TerrainData,
                            decimation: int, p_gains, d_gains, default_dof_pos,
                            action_scale: float, control_type: str = "P") -> DecimatedEnvStep:
    """Fused decimated control step on flat ground (JAX counterpart of the
    same name, without the rough-terrain plane carry)."""
    return DecimatedEnvStep(model, sp, terrain, decimation, p_gains, d_gains,
                            default_dof_pos, action_scale, control_type)
