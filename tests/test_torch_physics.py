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
    assert step.tf_host.shape == (pk.TF_SIZE,) and step.ti_host.shape == (pk.TI_SIZE,)
    assert list(step.ti_host[:6]) == [13, 12, 36, 4, 4, 0]
    assert list(step.ti_host[pk.TI_FGEOM:pk.TI_FGEOM + 4]) == [35, 19, 27, 11]
    np.testing.assert_allclose(step.tf_host[pk.TF_MASS:pk.TF_MASS + 13], model.mass)
    # the itemized, blockwise count behind chip_smoke.py's bound for ANYmal-C
    assert pk.control_step_flops(13, 12, 36, 4, 4) == 88916
