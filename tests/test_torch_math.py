"""The port's quaternion, random and spline helpers (utils/math.py) held to
the JAX package's on seeded numpy inputs at atol 1e-6 (float32).  The random
helpers get the JAX draws injected through ``_draw_uniform``.  The cases of
tests/test_math.py that apply run on the port too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.utils import math as jm
from extended_legged_gym_tpu_torch.trajopt import spline as port_spline
from extended_legged_gym_tpu_torch.utils import math as m

ATOL = 1e-6
MATS = ("LINEAR_MAT", "UNIFORM_BSPLINE_MAT", "BEZIER_MAT", "HERMITE_MAT", "CATMULL_ROM_MAT")


def quats(n, seed):
    q = np.random.default_rng(seed).standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def vecs(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("shape", [(), (3,), (2, 5)])
def test_quat_identity(shape):
    got = m.quat_identity(shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape + (4,)
    close(got, jm.quat_identity(shape))


@pytest.mark.parametrize("name", ["quat_apply", "quat_apply_yaw_inverse"])
def test_rotations_match_jax(name):
    q, v = quats(64, 0), vecs(64, 1)
    close(getattr(m, name)(torch.as_tensor(q), torch.as_tensor(v)), getattr(jm, name)(q, v))
    assert m.quat_apply is m.quat_rotate


def test_quat_to_ypr_matches_jax():
    q = quats(64, 2)
    for got, want in zip(m.quat_to_ypr(torch.as_tensor(q)), jm.quat_to_ypr(q)):
        close(got, want)
    # the inverse of ypr_to_quat away from gimbal lock
    y, p, r = (torch.as_tensor(np.random.default_rng(3).uniform(lo, hi, 32).astype(np.float32))
               for lo, hi in ((-3.0, 3.0), (-1.4, 1.4), (-3.0, 3.0)))
    for got, want in zip(m.quat_to_ypr(m.ypr_to_quat(y, p, r)), (y, p, r)):
        close(got, want, atol=1e-5)


def test_quat_box_minus_matches_jax():
    q1, q2 = quats(64, 4), quats(64, 5)
    close(m.quat_box_minus(torch.as_tensor(q1), torch.as_tensor(q2)), jm.quat_box_minus(q1, q2))
    # it undoes the exponential map: q2 turned by the result is q1 (up to sign)
    rv = m.quat_box_minus(torch.as_tensor(q1), torch.as_tensor(q2))
    ang = torch.linalg.norm(rv, dim=-1)
    back = m.quat_mul(m.quat_from_axis_angle(rv / ang[:, None], ang), torch.as_tensor(q2))
    close((back * torch.as_tensor(q1)).sum(-1).abs(), np.ones(64), atol=1e-5)


def test_yaw_quat_and_quat_to_ypr():
    """tests/test_math.py::test_yaw_quat on the port."""
    q = m.ypr_to_quat(torch.tensor(0.7), torch.tensor(0.2), torch.tensor(-0.1))
    yaw, pitch, roll = m.quat_to_ypr(m.yaw_quat(q))
    assert abs(float(pitch)) < 1e-6 and abs(float(roll)) < 1e-6
    qn = q.double().numpy().copy()
    qn[:2] = 0.0
    qn /= np.linalg.norm(qn)
    assert abs(float(yaw) - 2 * np.arctan2(qn[2], qn[3])) < 1e-5


def test_quat_apply_yaw_roundtrip():
    """tests/test_math.py::test_quat_apply_yaw on the port."""
    q = m.ypr_to_quat(torch.tensor(1.2), torch.tensor(0.4), torch.tensor(0.3))[None]
    v = torch.tensor([[0.3, -0.7, 0.2]])
    close(m.quat_apply_yaw_inverse(q, m.quat_apply_yaw(q, v)), v, atol=1e-5)


def test_quat_integrate_constant_rate():
    """tests/test_math.py::test_quat_integrate_constant_rate on the port."""
    q, omega = m.quat_identity(), torch.tensor([0.0, 0.0, 1.0])
    for _ in range(100):
        q = m.quat_integrate(q, omega, 0.01)
    assert abs(float(m.quat_to_ypr(q)[0]) - 1.0) < 1e-4


@pytest.mark.parametrize("bounds", [(-1.0, 1.0), (0.5, 3.0)])
def test_random_helpers_match_jax_with_its_draws(monkeypatch, bounds):
    lo, hi = bounds
    key = jax.random.PRNGKey(7)
    u = np.array(jax.random.uniform(key, (256,)))
    monkeypatch.setattr(m, "_draw_uniform", lambda g, shape, device: torch.as_tensor(u))
    g = torch.Generator().manual_seed(0)
    close(m.torch_rand_sqrt_float(g, lo, hi, (256,)), jm.torch_rand_sqrt_float(key, lo, hi, (256,)))
    close(m.uniform(g, lo, hi, (256,)), jm.uniform(key, lo, hi, (256,)))


def test_random_helpers_draw_from_the_generator():
    a = m.torch_rand_sqrt_float(torch.Generator().manual_seed(3), -2.0, 2.0, (4096,))
    b = m.torch_rand_sqrt_float(torch.Generator().manual_seed(3), -2.0, 2.0, (4096,))
    assert torch.equal(a, b) and float(a.min()) >= -2.0 and float(a.max()) <= 2.0
    # denser near the bounds than in the middle
    assert int((a.abs() > 1.5).sum()) > int((a.abs() < 0.5).sum())
    u = m.uniform(torch.Generator().manual_seed(4), 1.0, 3.0, (4096,))
    assert float(u.min()) >= 1.0 and float(u.max()) < 3.0


@pytest.mark.parametrize("name", MATS)
def test_basis_matrices_equal_jax(name):
    got = getattr(m, name)
    assert got.dtype == torch.float32
    close(got, getattr(jm, name), atol=0.0)


@pytest.mark.parametrize("name", ["UNIFORM_BSPLINE_MAT", "BEZIER_MAT", "HERMITE_MAT",
                                  "CATMULL_ROM_MAT"])
@pytest.mark.parametrize("mode", ["pos", "vel"])
@pytest.mark.parametrize("knot_shape", [(4,), (4, 3)])
def test_cubic_evaluate_matches_jax(name, mode, knot_shape):
    knots = np.random.default_rng(5).standard_normal(knot_shape).astype(np.float32)
    t = np.linspace(0.0, 1.0, 9, dtype=np.float32)
    got = m.cubic_evaluate(torch.as_tensor(knots), torch.as_tensor(t), getattr(m, name), mode)
    close(got, jm.cubic_evaluate(jnp.asarray(knots), t, getattr(jm, name), mode))


@pytest.mark.parametrize("knot_shape", [(2,), (2, 3)])
def test_linear_evaluate_matches_jax(knot_shape):
    knots = np.random.default_rng(6).standard_normal(knot_shape).astype(np.float32)
    t = np.linspace(0.0, 1.0, 5, dtype=np.float32)
    close(m.linear_evaluate(torch.as_tensor(knots), t), jm.linear_evaluate(jnp.asarray(knots), t))


@pytest.mark.parametrize("name", ["cubic_bezier_evaluate", "cubic_hermite_evaluate"])
def test_named_cubics_match_jax(name):
    knots = np.random.default_rng(2).standard_normal((4, 3)).astype(np.float32)
    t = np.array([0.0, 0.25, 0.5, 1.0], np.float32)
    got = getattr(m, name)(torch.as_tensor(knots), t)
    close(got, getattr(jm, name)(jnp.asarray(knots), t))
    if name == "cubic_bezier_evaluate":   # tests/test_math.py::test_cubic_evaluate_shapes
        assert tuple(got.shape) == (4, 3)
        close(got[0], knots[0])
        close(got[-1], knots[-1])


@pytest.mark.parametrize("method", ["linear", "spline"])
@pytest.mark.parametrize("sizes", [(5, 17), (4, 16), (1, 8)])
def test_spline_interp_matrix_matches_jax(method, sizes):
    A = m.spline_interp_matrix(*sizes, method, device="cpu")
    assert isinstance(A, torch.Tensor) and A.dtype == torch.float32
    close(A, jm.spline_interp_matrix(*sizes, method), atol=0.0)
    assert port_spline.spline_interp_matrix is m.spline_interp_matrix
    assert port_spline.spline_fit_matrix is m.spline_fit_matrix


def test_spline_matrices_interpolate_and_fit():
    """tests/test_math.py's endpoint and fit round-trip cases on the port."""
    nodes = torch.as_tensor(np.random.RandomState(0).randn(5, 3).astype(np.float32))
    for method in ("linear", "spline"):
        dense = m.spline_interp_matrix(5, 17, method) @ nodes
        close(dense[::4], nodes, atol=1e-5)
    P = torch.as_tensor(m.spline_fit_matrix(5, 17, "spline"))
    close(P @ (m.spline_interp_matrix(5, 17, "spline") @ nodes), nodes, atol=1e-4)
