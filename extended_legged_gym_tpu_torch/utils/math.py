"""Quaternion, rotation and spline math (port of ``utils/math.py``).

Only the subset the ported slices use.  Quaternions are **xyzw**
(scalar last), as in the JAX package.  Every function broadcasts over leading
batch dimensions.  The spline matrices are host numpy, as there.
"""
from __future__ import annotations

import numpy as np
import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting the leading ones."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, xyzw layout."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by quaternion q (body -> world when q is a body pose)."""
    xyz, w = q[..., :3], q[..., 3:4]
    t = 2.0 * cross(xyz, v)
    return v + w * t + cross(xyz, t)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of q (world -> body)."""
    xyz, w = q[..., :3], q[..., 3:4]
    t = 2.0 * cross(xyz, v)
    return v - w * t + cross(xyz, t)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    half = 0.5 * angle[..., None]
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix R such that R @ v_body = v_world."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-9)


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (xyzw), branch-free: of the four
    candidate solutions (trace-, x-, y-, z-major) the one with the largest
    radicand."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    t = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                     1 - m00 + m11 - m22, 1 - m00 - m11 + m22], dim=-1)
    s = torch.sqrt(t.clamp(min=1e-12)) / 2.0       # (qw, qx, qy, qz) of each candidate
    inv4 = 1.0 / (4.0 * s)
    cand = torch.stack([                           # each row (x, y, z, w)
        torch.stack([(m21 - m12) * inv4[..., 0], (m02 - m20) * inv4[..., 0],
                     (m10 - m01) * inv4[..., 0], s[..., 0]], dim=-1),
        torch.stack([s[..., 1], (m01 + m10) * inv4[..., 1],
                     (m02 + m20) * inv4[..., 1], (m21 - m12) * inv4[..., 1]], dim=-1),
        torch.stack([(m01 + m10) * inv4[..., 2], s[..., 2],
                     (m12 + m21) * inv4[..., 2], (m02 - m20) * inv4[..., 2]], dim=-1),
        torch.stack([(m02 + m20) * inv4[..., 3], (m12 + m21) * inv4[..., 3],
                     s[..., 3], (m10 - m01) * inv4[..., 3]], dim=-1),
    ], dim=-2)                                     # [..., 4, 4]
    idx = torch.argmax(t, dim=-1)
    q = torch.take_along_dim(cand, idx[..., None, None].expand(idx.shape + (1, 4)), dim=-2)
    return quat_normalize(q[..., 0, :])


def wrap_to_pi(angles: torch.Tensor) -> torch.Tensor:
    """Wrap angles to [-pi, pi)."""
    return torch.remainder(angles + np.pi, 2 * np.pi) - np.pi


def yaw_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion with only the yaw component of q."""
    qz, qw = q[..., 2], q[..., 3]
    norm = torch.sqrt(qz * qz + qw * qw).clamp(min=1e-9)
    zeros = torch.zeros_like(qz)
    return torch.stack([zeros, zeros, qz / norm, qw / norm], dim=-1)


def ypr_to_quat(yaw: torch.Tensor, pitch: torch.Tensor, roll: torch.Tensor) -> torch.Tensor:
    """Yaw-pitch-roll (ZYX intrinsic) to quaternion."""
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    return torch.stack([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ], dim=-1)


def quat_apply_yaw(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by only the yaw component of q."""
    return quat_rotate(yaw_quat(q), v)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix: skew(v) @ u == cross(v, u)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _spline_interp_matrix_np(n_nodes: int, n_dense: int, method: str = "spline") -> np.ndarray:
    """Dense interpolation matrix A [n_dense, n_nodes] with ``dense = A @ nodes``.

    Nodes are uniformly spaced over the horizon, endpoints included.
    ``method`` is "linear" or "spline" (Catmull-Rom, interpolating, with
    clamped ends by endpoint knot duplication)."""
    A = np.zeros((n_dense, n_nodes), dtype=np.float32)
    if n_nodes == 1:
        A[:, 0] = 1.0
        return A
    s = np.linspace(0.0, n_nodes - 1.0, n_dense)
    seg = np.clip(np.floor(s).astype(int), 0, n_nodes - 2)
    t = s - seg
    if method == "linear":
        for i in range(n_dense):
            A[i, seg[i]] += 1.0 - t[i]
            A[i, seg[i] + 1] += t[i]
    elif method == "spline":
        M = np.array([[0.0, 2.0, 0.0, 0.0], [-1.0, 0.0, 1.0, 0.0],
                      [2.0, -5.0, 4.0, -1.0], [-1.0, 3.0, -3.0, 1.0]]) / 2.0
        for i in range(n_dense):
            w = np.array([1.0, t[i], t[i] ** 2, t[i] ** 3]) @ M  # over knots k-1..k+2
            for j, dk in enumerate((-1, 0, 1, 2)):
                k = int(np.clip(seg[i] + dk, 0, n_nodes - 1))
                A[i, k] += w[j]
    else:
        raise ValueError(f"unknown interp method {method}")
    return A


def spline_fit_matrix(n_nodes: int, n_dense: int, method: str = "spline") -> np.ndarray:
    """Least-squares inverse of the interpolation matrix (dense -> nodes)."""
    A = _spline_interp_matrix_np(n_nodes, n_dense, method)
    return np.linalg.pinv(A).astype(np.float32)
