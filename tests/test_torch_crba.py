"""The port's small SPD solves, kinematics, dynamics and CRBA engine step
against the JAX package, on the CPU, and the port's ABA step held to the
port's CRBA step as tests/test_aba.py holds the JAX ABA step to the JAX
engine.

Robots: ANYmal-C, the ElSpider Air hexapod, the fixed-base Franka arm and
CyberDog2.  The states are the ones tests/test_aba.py builds (base 2 cm below
its initial height, a tilted base, perturbed joints, random velocities),
drawn with numpy from a seed, one per env.  Tolerances: the unrolled
factorization 1e-4 against JAX's (float32, the same column order) and 1e-3
against LAPACK's (tests/test_linalg.py); kinematics 1e-5 absolute
(positions of order 1 m, velocities of order 1); Jacobians 1e-5; the mass
matrix and bias forces 1e-4 relative plus 1e-3 absolute (sums of up to 39
products of float32 terms); the CRBA step's accelerations 1e-3 relative plus
2e-3 of the largest, its states 1e-4 (positions) and 1e-3 (velocities), its
forces 1e-2 relative plus 1e-2 N; the ABA-vs-CRBA comparison tests/test_aba.py's
tolerances."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.ops import linalg as jlinalg
from extended_legged_gym_tpu.physics import dynamics as jdyn
from extended_legged_gym_tpu.physics import default_env_params as jdefault_env_params
from extended_legged_gym_tpu.physics import default_sim_params as jdefault_sim_params
from extended_legged_gym_tpu.physics import physics_step as jphysics_step
from extended_legged_gym_tpu.physics.engine import PhysState as JPhysState
from extended_legged_gym_tpu.physics.serialize import load_model as jload_model
from extended_legged_gym_tpu.terrain import flat_terrain as jflat_terrain
from extended_legged_gym_tpu_torch.ops import linalg
from extended_legged_gym_tpu_torch.physics import dynamics
from extended_legged_gym_tpu_torch.physics import (default_env_params, default_sim_params,
                                                   initial_state, load_model, physics_step)
from extended_legged_gym_tpu_torch.terrain import flat_terrain
from torch_parity import PHYS

ROBOTS = ["anymal_c", "elspider_air", "franka", "cyberdog2"]
B = 4


def _spd(seed, shape):
    A = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.einsum("bij,bkj->bik", A, A) + shape[-1] * np.eye(shape[-1], dtype=np.float32)


def test_unrolled_cholesky_matches_jax_and_lapack():
    A = _spd(0, (32, 18, 18))
    L = linalg.cholesky_unrolled(torch.as_tensor(A))
    np.testing.assert_allclose(L.numpy(), np.asarray(jax.vmap(jlinalg.cholesky_unrolled)(A)),
                               atol=1e-4)
    np.testing.assert_allclose(L.numpy(), torch.linalg.cholesky(torch.as_tensor(A)).numpy(),
                               atol=1e-3)
    assert float(torch.triu(L, 1).abs().max()) == 0.0


def test_unrolled_solves_match_jax():
    A = _spd(1, (16, 18, 18))
    b = np.random.default_rng(2).standard_normal((16, 18)).astype(np.float32)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    L = linalg.cholesky_unrolled(At)
    jL = jax.vmap(jlinalg.cholesky_unrolled)(A)
    y = linalg.solve_tri_lower(L, bt)
    np.testing.assert_allclose(y.numpy(), np.asarray(jax.vmap(jlinalg.solve_tri_lower)(jL, b)),
                               atol=1e-4)
    np.testing.assert_allclose(linalg.solve_tri_upper_T(L, y).numpy(),
                               np.asarray(jax.vmap(jlinalg.solve_tri_upper_T)(jL, y.numpy())),
                               atol=1e-4)
    x = linalg.cho_solve_unrolled(At, bt)
    np.testing.assert_allclose(x.numpy(), np.asarray(jax.vmap(jlinalg.cho_solve_unrolled)(A, b)),
                               atol=1e-4)
    assert float((At @ x[..., None])[..., 0].sub(bt).abs().max()) < 1e-2
    np.testing.assert_allclose(linalg.spd_solve(At, bt, method="torch").numpy(), x.numpy(),
                               atol=1e-4)
    assert torch.equal(linalg.spd_solve(At, bt), x)


def _states(robot, seed=0):
    """tests/test_aba.py's state, per env from numpy draws: (port state, JAX
    state, torques, model, JAX model)."""
    m, jm = load_model(f"extended_legged_gym_tpu/robots/data/{robot}.json"), jload_model(
        f"extended_legged_gym_tpu/robots/data/{robot}.json")
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q = np.array([0.05, -0.02, 0.1, 0.99], np.float32)
    st = initial_state(m, B, pos=(0.1, -0.2, float(m.base_init_height) - 0.02), device="cpu")
    st = st.replace(base_quat=torch.as_tensor(q / np.linalg.norm(q)).expand(B, 4).clone(),
                    joint_pos=st.joint_pos + torch.as_tensor(0.1 * f(B, m.nj)),
                    joint_vel=torch.as_tensor(0.5 * f(B, m.nj)),
                    base_lin_vel=torch.as_tensor(0.3 * f(B, 3)),
                    base_ang_vel=torch.as_tensor(0.4 * f(B, 3)))
    jst = JPhysState(*[jnp.asarray(getattr(st, k).numpy()) for k in PHYS])
    return st, jst, torch.as_tensor(2.0 * f(B, m.nj)), m, jm


def _fk_args(st):
    return (st.base_pos, st.base_quat, st.joint_pos, st.base_lin_vel, st.base_ang_vel,
            st.joint_vel)


@pytest.mark.parametrize("robot", ROBOTS)
def test_kinematics_and_dynamics_match_jax(robot):
    st, jst, tau, m, jm = _states(robot)
    kin = dynamics.forward_kinematics(m, *_fk_args(st))
    jkin = jax.vmap(lambda *a: jdyn.forward_kinematics(jm, *a))(*_fk_args(jst))
    for name in jdyn.Kinematics._fields:
        np.testing.assert_allclose(getattr(kin, name).numpy(), np.asarray(getattr(jkin, name)),
                                   atol=1e-5, err_msg=name)
    gb = np.asarray(m.geom_body)
    pts = kin.body_pos[:, gb] + (kin.body_rot[:, gb] @ torch.as_tensor(m.geom_offset)[..., None])[..., 0]
    Jg = dynamics.point_jacobian(m, kin, gb, pts)
    jJg = jax.vmap(lambda k, p: jdyn.point_jacobian(jm, k, gb, p))(jkin, pts.numpy())
    np.testing.assert_allclose(Jg.numpy(), np.asarray(jJg), atol=1e-5)
    Jv, Jw = dynamics.body_jacobians(m, kin)
    jJv, jJw = jax.vmap(lambda k: jdyn.body_jacobians(jm, k))(jkin)
    np.testing.assert_allclose(Jv.numpy(), np.asarray(jJv), atol=1e-5)
    np.testing.assert_allclose(Jw.numpy(), np.asarray(jJw), atol=1e-5)
    g = np.array([0.0, 0.0, -9.81], np.float32)
    M = dynamics.mass_matrix(m, kin, Jv, Jw)
    C = dynamics.bias_forces(m, kin, Jv, Jw, torch.as_tensor(g))
    jM = jax.vmap(lambda k, a, b: jdyn.mass_matrix(jm, k, a, b))(jkin, jJv, jJw)
    jC = jax.vmap(lambda k, a, b: jdyn.bias_forces(jm, k, a, b, g))(jkin, jJv, jJw)
    np.testing.assert_allclose(M.numpy(), np.asarray(jM), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(C.numpy(), np.asarray(jC), rtol=1e-4, atol=1e-3)
    ext = torch.as_tensor(np.random.default_rng(5).standard_normal((B, m.nv)).astype(np.float32))
    ud = dynamics.forward_dynamics(m, M, C, tau, ext)
    jud = jax.vmap(lambda a, b, c, d: jdyn.forward_dynamics(jm, a, b, c, d))(
        M.numpy(), C.numpy(), tau.numpy(), ext.numpy())
    scale = float(np.abs(np.asarray(jud)).max())
    np.testing.assert_allclose(ud.numpy(), np.asarray(jud), rtol=1e-3, atol=2e-3 * scale)
    if m.fix_base:
        assert float(ud[:, :6].abs().max()) == 0.0


def test_integrate_without_a_velocity_limit_matches_jax():
    st, jst, _, m, jm = _states("anymal_c")
    ud = np.random.default_rng(3).standard_normal((B, m.nv)).astype(np.float32) * 3e5
    out = dynamics.integrate(*_fk_args(st), torch.as_tensor(ud), 0.005, joint_vel_limit=None)
    jout = jax.vmap(lambda p, q, th, v, w, thd, u: jdyn.integrate(p, q, th, v, w, thd, u, 0.005))(
        *_fk_args(jst), ud)
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    assert float(out[5].abs().max()) == 500.0          # the generic containment clamp


@pytest.mark.parametrize("robot", ROBOTS)
def test_crba_step_matches_jax(robot):
    st, jst, tau, m, jm = _states(robot, seed=1)
    ep = default_env_params(B, device="cpu")
    new, rep = physics_step(m, flat_terrain(), default_sim_params(solver="crba"), st, tau, ep)
    jsp = jdefault_sim_params(solver="crba")
    jnew, jrep = jax.vmap(lambda s, t: jphysics_step(jm, jflat_terrain(size=10.0), jsp, s, t,
                                                     jdefault_env_params()))(jst, tau.numpy())
    scale = float(np.abs(np.asarray(jrep.qdd)).max())
    np.testing.assert_allclose(rep.qdd.numpy(), np.asarray(jrep.qdd), rtol=1e-3,
                               atol=2e-3 * scale)
    for name in ("base_pos", "base_quat", "joint_pos", "contact_anchor"):
        np.testing.assert_allclose(getattr(new, name).numpy(), np.asarray(getattr(jnew, name)),
                                   atol=1e-4, err_msg=name)
    for name in ("base_lin_vel", "base_ang_vel", "joint_vel"):
        np.testing.assert_allclose(getattr(new, name).numpy(), np.asarray(getattr(jnew, name)),
                                   atol=1e-3, err_msg=name)
    np.testing.assert_allclose(rep.geom_forces.numpy(), np.asarray(jrep.geom_forces), rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(rep.foot_pos.numpy(), np.asarray(jrep.foot_pos), atol=1e-5)
    np.testing.assert_allclose(rep.foot_vel.numpy(), np.asarray(jrep.foot_vel), atol=1e-4)


@pytest.mark.parametrize("robot", ROBOTS)
def test_aba_matches_crba(robot):
    """tests/test_aba.py::test_aba_matches_engine in the port: ABA and the
    dense engine solve the same implicit system."""
    st, _, tau, m, _ = _states(robot, seed=2)
    ep = default_env_params(B, device="cpu")
    s1, r1 = physics_step(m, flat_terrain(), default_sim_params(solver="crba"), st, tau, ep)
    s2, r2 = physics_step(m, flat_terrain(), default_sim_params(solver="aba"), st, tau, ep)
    scale = float(r1.qdd.abs().max())
    np.testing.assert_allclose(r2.qdd.numpy(), r1.qdd.numpy(), rtol=0.02, atol=0.01 * scale + 0.05)
    np.testing.assert_allclose(s2.base_pos.numpy(), s1.base_pos.numpy(), atol=1e-4)
    np.testing.assert_allclose(s2.joint_vel.numpy(), s1.joint_vel.numpy(),
                               atol=0.01 * scale * 0.005 + 0.01)
    np.testing.assert_allclose(r2.foot_pos.numpy(), r1.foot_pos.numpy(), atol=1e-4)
    np.testing.assert_allclose(r2.geom_forces.numpy(), r1.geom_forces.numpy(), rtol=0.05, atol=2.0)
    if m.fix_base:
        assert float(r2.qdd[:, :6].abs().max()) == float(r1.qdd[:, :6].abs().max()) == 0.0


def test_fused_step_refuses_another_solver():
    """The fused kernel is the ABA step: its wrappers refuse a SimParams that
    names another solver instead of running ABA under its name."""
    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
    m = load_model("extended_legged_gym_tpu/robots/data/franka.json")
    z = np.zeros(m.nj, np.float32)
    with pytest.raises(ValueError, match="solver must be 'aba', not 'crba'"):
        pk.make_decimated_env_step(m, default_sim_params(solver="crba"), flat_terrain(), 4,
                                   z, z, z, 0.5)
    with pytest.raises(ValueError, match="solver must be 'aba', not 'crba'"):
        pk.make_env_step(m, default_sim_params(solver="crba"))
