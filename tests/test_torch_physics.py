"""The port's plain physics step (physics/aba.py) and its decimated wrapper
(ops/physics_kernel.py) against the JAX ABA engine (the CUDA kernel against
the plain version is tests/test_torch_kernel_cuda.py).

Tolerances are those of tests/test_physics_kernel.py:66-84 (kernel vs ABA):
positions integrate from matching velocities and are tight; velocities carry
float32 accumulation-order noise through the contact solve."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.physics import default_sim_params as jdefault_sim_params
from extended_legged_gym_tpu.physics import initial_state as jinitial_state
from extended_legged_gym_tpu.physics.aba import aba_physics_step as jaba_physics_step
from extended_legged_gym_tpu.physics.engine import EnvPhysParams as JEnvPhysParams
from extended_legged_gym_tpu.physics.serialize import load_model as jload_model
from extended_legged_gym_tpu.terrain import flat_terrain as jflat_terrain
from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
from extended_legged_gym_tpu_torch.physics import (EnvPhysParams, PhysState, default_sim_params,
                                                   load_model)
from extended_legged_gym_tpu_torch.physics.aba import aba_physics_step
from extended_legged_gym_tpu_torch.terrain import flat_terrain

MODEL = "extended_legged_gym_tpu/robots/data/anymal_c.json"
FIELDS = ("base_pos", "base_quat", "joint_pos", "base_lin_vel", "base_ang_vel", "joint_vel",
          "contact_anchor")
TOLS = dict(base_pos=1e-4, base_quat=1e-4, joint_pos=5e-4, base_lin_vel=2e-2,
            base_ang_vel=2e-2, joint_vel=5e-2)


@pytest.fixture(scope="module")
def setup():
    jmodel, model = jload_model(MODEL), load_model(MODEL)
    jstep = jax.jit(jax.vmap(
        lambda s, t, ep: jaba_physics_step(jmodel, jflat_terrain(size=10.0),
                                           jdefault_sim_params(), s, t, ep)))
    return jmodel, model, jstep


def _states(jmodel, B, seed):
    """Seeded near-standing states as numpy (the JAX kernel test's recipe)."""
    rng = np.random.default_rng(seed)
    st = jax.tree.map(lambda x: np.broadcast_to(np.asarray(x), (B,) + x.shape).copy(),
                      jinitial_state(jmodel, pos=(0.0, 0.0, 0.54)))
    f = lambda a: a.astype(np.float32)
    return st.replace(base_pos=st.base_pos + f(0.05 * rng.standard_normal((B, 3))),
                      joint_pos=st.joint_pos + f(0.1 * rng.standard_normal((B, 12))),
                      joint_vel=f(0.5 * rng.standard_normal((B, 12))),
                      base_lin_vel=f(0.3 * rng.standard_normal((B, 3))),
                      base_ang_vel=f(0.3 * rng.standard_normal((B, 3))))


def _to_torch(jst):
    return PhysState(*[torch.as_tensor(np.asarray(getattr(jst, k))) for k in FIELDS])


def _env_params(B, seed):
    rng = np.random.default_rng(seed)
    fric = rng.uniform(0.5, 1.25, B).astype(np.float32)
    delta = rng.uniform(-1.0, 1.0, B).astype(np.float32)
    return (JEnvPhysParams(friction_scale=jnp.asarray(fric), base_mass_delta=jnp.asarray(delta)),
            EnvPhysParams(torch.as_tensor(fric), torch.as_tensor(delta)))


def test_plain_step_matches_jax_aba(setup):
    jmodel, model, jstep = setup
    B = 8
    jst = _states(jmodel, B, seed=0)
    tau = (5.0 * np.random.default_rng(1).standard_normal((B, 12))).astype(np.float32)
    jep, ep = _env_params(B, seed=2)
    jnew, jrep = jstep(jst, jnp.asarray(tau), jep)
    new, rep = aba_physics_step(model, flat_terrain(), default_sim_params(),
                                _to_torch(jst), torch.as_tensor(tau), ep)
    for name, atol in TOLS.items():
        np.testing.assert_allclose(getattr(new, name).numpy(), np.asarray(getattr(jnew, name)),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(new.contact_anchor.numpy(), np.asarray(jnew.contact_anchor), atol=1e-4)
    np.testing.assert_allclose(rep.foot_pos.numpy(), np.asarray(jrep.foot_pos), atol=1e-4)
    np.testing.assert_allclose(rep.foot_vel.numpy(), np.asarray(jrep.foot_vel), atol=2e-2)
    np.testing.assert_allclose(rep.geom_forces[..., 2].sum(1).numpy(),
                               np.asarray(jrep.geom_forces[..., 2].sum(1)), rtol=0.2, atol=30.0)
    np.testing.assert_allclose(rep.geom_forces.numpy(), np.asarray(jrep.geom_forces), atol=1.0)


def test_plain_step_tracks_jax_over_10_substeps(setup):
    """Drift bound of tests/test_physics_kernel.py (multistep): 5e-3 m on the
    base, 2e-2 rad on the joints, zero torque."""
    jmodel, model, jstep = setup
    B = 8
    jst = _states(jmodel, B, seed=5)
    st = _to_torch(jst)
    jep, ep = _env_params(B, seed=6)
    zero = np.zeros((B, 12), np.float32)
    terrain, sp = flat_terrain(), default_sim_params()
    for _ in range(10):
        jst, _ = jstep(jst, jnp.asarray(zero), jep)
        st, _ = aba_physics_step(model, terrain, sp, st, torch.as_tensor(zero), ep)
    np.testing.assert_allclose(st.base_pos.numpy(), np.asarray(jst.base_pos), atol=5e-3)
    np.testing.assert_allclose(st.joint_pos.numpy(), np.asarray(jst.joint_pos), atol=2e-2)
    assert torch.isfinite(st.joint_vel).all()


def _jax_env(E):
    from extended_legged_gym_tpu.envs.batch_rollout import RobotTrajGradSampling
    from extended_legged_gym_tpu.robots.anymal_c_traj import anymal_c_traj_sampling_cfg

    cfg = anymal_c_traj_sampling_cfg(E)
    cfg.sim.solver = "aba"
    return RobotTrajGradSampling(cfg)


def test_decimated_plain_matches_jax_physics_substeps(setup):
    """PD torques + 4 substeps against the JAX env's ABA decimation loop."""
    from extended_legged_gym_tpu_torch.robots.anymal_c_traj import anymal_c_traj_sampling_cfg
    from extended_legged_gym_tpu_torch.envs.batch_rollout import RobotTrajGradSampling

    jmodel, model, _ = setup
    B = 8
    jenv = _jax_env(B)
    env = RobotTrajGradSampling(anymal_c_traj_sampling_cfg(B), device="cpu")
    jst = _states(jmodel, B, seed=9)
    actions = np.random.default_rng(10).standard_normal((B, 12)).astype(np.float32)
    jep, ep = _env_params(B, seed=11)
    jfn = jax.jit(lambda p, a, e: jenv._physics_substeps(p, a, e, jnp.zeros((B, 12)))[:3])
    jnew, jtau, jrep = jfn(jst, jnp.asarray(actions), jep)
    before = pk.DecimatedEnvStep.launches
    new, tau, rep = env.decimated_step(_to_torch(jst), torch.as_tensor(actions), ep)
    assert pk.DecimatedEnvStep.launches == before          # CPU tensors: plain version
    for name, atol in TOLS.items():
        np.testing.assert_allclose(getattr(new, name).numpy(), np.asarray(getattr(jnew, name)),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(tau.numpy(), np.asarray(jtau), atol=0.5)
    np.testing.assert_allclose(rep.foot_pos.numpy(), np.asarray(jrep.foot_pos), atol=1e-4)
    np.testing.assert_allclose(rep.geom_forces[..., 2].sum(1).numpy(),
                               np.asarray(jrep.geom_forces[..., 2].sum(1)), rtol=0.2, atol=30.0)


def _wrapper(model):
    return pk.make_decimated_env_step(model, default_sim_params(), flat_terrain(), 4,
                                      np.full(12, 80.0, np.float32), np.full(12, 2.0, np.float32),
                                      model.default_dof_pos, 0.5)


def test_wrapper_rejects_bad_inputs(setup):
    jmodel, model, _ = setup
    step = _wrapper(model)
    st = _to_torch(_states(jmodel, 4, seed=3))
    ep = EnvPhysParams(torch.ones(4), torch.zeros(4))
    with pytest.raises(ValueError, match="actions"):
        step(st, torch.zeros(4, 11), ep)
    with pytest.raises(ValueError, match="base_pos"):
        step(st.replace(base_pos=st.base_pos.double()), torch.zeros(4, 12), ep)
    with pytest.raises(NotImplementedError):
        pk.make_decimated_env_step(model, default_sim_params(), flat_terrain(), 4,
                                   np.zeros(12), np.zeros(12), model.default_dof_pos, 0.5,
                                   control_type="V")


def test_table_layout_fits_model(setup):
    _, model, _ = setup
    step = _wrapper(model)
    assert step.tf_host.shape == (pk.TF_SIZE,) and step.ti_host.shape == (pk.TI_FULL,)
    assert list(step.ti_host[:6]) == [13, 12, 36, 4, 4, 0]
    # the tree schedule: base, hips, thighs, shanks; geoms body by body; children
    ti = step.ti_host
    assert list(ti[pk.TI_DEPTH:pk.TI_DEPTH + 13]) == [0] + [1, 2, 3] * 4 and ti[pk.TI_MAXD] == 3
    assert list(ti[pk.TI_LVL:pk.TI_LVL + 13]) == [0, 1, 4, 7, 10, 2, 5, 8, 11, 3, 6, 9, 12]
    assert list(ti[pk.TI_LOFF:pk.TI_LOFF + 5]) == [0, 1, 5, 9, 13]
    goff, gslot = ti[pk.TI_GOFF:pk.TI_GOFF + 14], ti[pk.TI_GSLOT:pk.TI_GSLOT + 36]
    assert sorted(gslot) == list(range(36))
    for g, b in enumerate(model.geom_body):
        assert goff[b] <= gslot[g] < goff[b + 1]
    assert list(ti[pk.TI_COFF:pk.TI_COFF + 14]) == [0, 4, 5, 6, 6, 7, 8, 8, 9, 10, 10, 11, 12, 12]
    assert list(ti[pk.TI_CLIST:pk.TI_CLIST + 12]) == [1, 4, 7, 10, 2, 3, 5, 6, 8, 9, 11, 12]
    assert list(step.ti_host[pk.TI_FGEOM:pk.TI_FGEOM + 4]) == [35, 19, 27, 11]
    np.testing.assert_allclose(step.tf_host[pk.TF_MASS:pk.TF_MASS + 13], model.mass)
    # the itemized, blockwise count behind chip_smoke.py's bound for ANYmal-C
    assert pk.control_step_flops(13, 12, 36, 4, 4) == 88916


def test_env_step_route_matches_jax_aba(setup):
    """The V-control route (make_env_step: one substep, torques passed in) on
    CPU tensors against the JAX ABA step with the same torques; the rough
    route refuses flat ground."""
    jmodel, model, jstep = setup
    B = 8
    jst = _states(jmodel, B, seed=5)
    tau = (20.0 * np.random.default_rng(6).standard_normal((B, 12))).astype(np.float32)
    jep, ep = _env_params(B, seed=7)
    jnew, jrep = jstep(jst, jnp.asarray(tau), jep)
    step = pk.make_env_step(model, default_sim_params())
    assert (step.decimation, step.control_type, step.action_scale, step.rough) == (1, "T", 1.0, False)
    new, rep = step(_to_torch(jst), torch.as_tensor(tau), ep)
    for k in FIELDS:
        np.testing.assert_allclose(getattr(new, k).numpy(), np.asarray(getattr(jnew, k)),
                                   atol=TOLS.get(k, 1e-4), err_msg=k)
    np.testing.assert_allclose(rep.foot_pos.numpy(), np.asarray(jrep.foot_pos), atol=1e-4)
    assert pk.EnvStep.launches == pk.EnvStep.rough_launches == 0
    with pytest.raises(ValueError, match="heightfield"):
        pk.make_env_step_rough(model, default_sim_params(), flat_terrain())
