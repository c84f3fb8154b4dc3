"""The ElSpider Air hexapod against the JAX package, on the CPU: the model
(19 bodies, 18 joints, 46 spheres, 6 feet) and one ABA step; the
``elspider_air_flat`` env's observation and each reward term on the same
states (the tripod ``gait_2_step`` among them), and a whole step at reward
stage 1; the committed checkpoint's actions.

The states come from the JAX env (ABA solver) after a few steps of random
actions, so feet have air and contact times.  Tolerances: the model exactly;
the ABA step tests/test_torch_physics.py's; each reward term and the
observation 1e-5 relative plus 1e-6 absolute (the same float32 formulas);
the whole step tests/test_torch_env.py's (states 5e-3, observations 1e-2,
rewards 1e-3 absolute); actions 1e-5."""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.models.networks import ActorCritic as JActorCritic
from extended_legged_gym_tpu.physics import default_sim_params as jdefault_sim_params
from extended_legged_gym_tpu.physics.aba import aba_physics_step as jaba_physics_step
from extended_legged_gym_tpu.envs.legged_robot import LeggedRobot as JLeggedRobot
from extended_legged_gym_tpu.physics.engine import EnvPhysParams as JEnvPhysParams
from extended_legged_gym_tpu.physics.engine import PhysState as JPhysState
from extended_legged_gym_tpu.physics.serialize import load_model as jload_model
from extended_legged_gym_tpu.robots.elspider_air import ElSpider as JElSpider
from extended_legged_gym_tpu.robots.anymal_c import anymal_c_flat_cfg as janymal_c_flat_cfg
from extended_legged_gym_tpu.robots.elspider_air import elspider_air_flat_cfg as jflat_cfg
from extended_legged_gym_tpu.terrain import flat_terrain as jflat_terrain
from extended_legged_gym_tpu_torch import robots  # noqa: F401
from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_flat_cfg
from extended_legged_gym_tpu_torch.physics import default_sim_params, load_model
from extended_legged_gym_tpu_torch.physics.aba import aba_physics_step
from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner
from extended_legged_gym_tpu_torch.robots.elspider_air import (ElSpider, elspider_air_flat_cfg,
                                                               elspider_air_ppo_cfg)
from extended_legged_gym_tpu_torch.scripts.bench_kernel import STAND_HEIGHT, near_standing
from extended_legged_gym_tpu_torch.terrain import flat_terrain
from extended_legged_gym_tpu_torch.utils.task_registry import task_registry
from torch_parity import PHYS, to_torch_state

MODEL = "extended_legged_gym_tpu/robots/data/elspider_air.json"
CKPT = "logs/flat_elspider_air/Aug21_04-21-51_r4b/model_final.pkl"
TOLS = dict(base_pos=1e-4, base_quat=1e-4, joint_pos=5e-4, base_lin_vel=2e-2,
            base_ang_vel=2e-2, joint_vel=5e-2)
E = 4


def test_model_loads_as_in_jax():
    jm, m = jload_model(MODEL), load_model(MODEL)
    assert (m.nb, m.nj, m.ng, m.num_feet) == (jm.nb, jm.nj, 46, 6) == (19, 18, 46, 6)
    assert m.parent == tuple(jm.parent) and m.joint_names == tuple(jm.joint_names)
    assert [m.parent[i] for i in range(1, 19, 3)] == [0] * 6          # six legs on the base
    for k in ("joint_origin_rot", "joint_origin_pos", "joint_axis", "mass", "inertia",
              "geom_body", "geom_offset", "geom_radius", "foot_geom", "default_dof_pos",
              "torque_limits", "dof_pos_limits"):
        np.testing.assert_array_equal(getattr(m, k), np.asarray(getattr(jm, k)), err_msg=k)


def test_one_aba_step_matches_jax():
    jm, m = jload_model(MODEL), load_model(MODEL)
    B = 8
    st, ep, _ = near_standing(m, B, 0, "cpu", height=STAND_HEIGHT["elspider_air"])
    tau = torch.as_tensor((5.0 * np.random.default_rng(1).standard_normal((B, 18)))
                          .astype(np.float32))
    jstep = jax.vmap(lambda s, t, e: jaba_physics_step(jm, jflat_terrain(size=10.0),
                                                       jdefault_sim_params(), s, t, e))
    jst = JPhysState(*[jnp.asarray(getattr(st, k).numpy()) for k in PHYS])
    jnew, jrep = jstep(jst, jnp.asarray(tau.numpy()),
                       JEnvPhysParams(jnp.asarray(ep.friction_scale.numpy()),
                                      jnp.asarray(ep.base_mass_delta.numpy())))
    new, rep = aba_physics_step(m, flat_terrain(), default_sim_params(), st, tau, ep)
    assert float(rep.geom_forces[..., 2].sum()) > 50.0 * B
    for name, atol in TOLS.items():
        np.testing.assert_allclose(getattr(new, name).numpy(), np.asarray(getattr(jnew, name)),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(rep.foot_pos.numpy(), np.asarray(jrep.foot_pos), atol=1e-4)


def quiet(cfg):
    cfg.env.num_envs = E
    cfg.noise.add_noise = False
    cfg.domain_rand.randomize_friction = cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.push_robots = False
    return cfg


@pytest.fixture(scope="module")
def envs():
    jc = quiet(jflat_cfg())
    jc.sim.solver = "aba"
    jenv = JElSpider(jc)
    jstep = jax.jit(jenv.step)
    js = jenv.reset_all(jax.random.PRNGKey(4))
    rng = np.random.default_rng(0)
    for _ in range(12):
        js = jstep(js, jnp.asarray((0.5 * rng.standard_normal((E, 18))).astype(np.float32)))
    assert not bool(np.asarray(js.reset_buf).any())
    return jenv, ElSpider(quiet(elspider_air_flat_cfg()), device="cpu"), jstep, js


def jax_ctx(jenv, s):
    """The contact context of the JAX env's ``_compute_reward``."""
    contact = s.geom_forces[:, jenv.feet_geoms, 2] > 1.0
    contact_filt = contact | s.last_contacts
    return dict(contact=contact, contact_filt=contact_filt,
                first_contact=(s.feet_air_time > 0.0) & contact_filt,
                feet_air_time=s.feet_air_time + jenv.dt,
                feet_contact_time=s.feet_contact_time + jenv.dt)


def test_config_matches_jax(envs):
    jenv, env, _, _ = envs
    assert env.reward_names == jenv.reward_names
    assert {"feet_slip", "dof_pos_limits", "gait_2_step"} <= set(env.reward_names)
    np.testing.assert_allclose(env.reward_scale_table.numpy(), jenv.reward_scale_table, rtol=1e-7)
    np.testing.assert_allclose(env.dof_pos_soft_limits.numpy(), jenv.dof_pos_soft_limits,
                               rtol=1e-6)
    assert env.num_obs == 66 and env.num_actions == 18 and env.num_feet == 6
    assert env.decimated_step is not None and not env.decimated_step.rough


def test_observation_and_each_reward_term_match_jax(envs):
    jenv, env, _, js = envs
    s = to_torch_state(js)
    jctx, ctx = jax_ctx(jenv, js), env._contact_context(s)
    for k, v in jctx.items():
        np.testing.assert_array_equal(ctx[k].numpy(), np.asarray(v), err_msg=k)
    assert float(np.asarray(jctx["feet_air_time"]).max()) > 0.05       # some foot in the air
    for name in env.reward_names:
        got = getattr(env, f"_reward_{name}")(s, ctx).numpy()
        want = np.asarray(getattr(jenv, f"_reward_{name}")(js, jctx))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
    gait = env._reward_gait_2_step(s, ctx).numpy()
    assert np.abs(gait).max() > 0.0
    # joints pushed past their soft limits, both ways
    shift = np.where(np.arange(18) % 2 == 0, 1.5, -1.5).astype(np.float32)
    jpast = js.replace(phys=js.phys.replace(joint_pos=js.phys.joint_pos + shift))
    past = s.replace(phys=s.phys.replace(joint_pos=s.phys.joint_pos + torch.as_tensor(shift)))
    want = np.asarray(jenv._reward_dof_pos_limits(jpast, jctx))
    np.testing.assert_allclose(env._reward_dof_pos_limits(past, ctx).numpy(), want, rtol=1e-5)
    assert want.min() > 0.5
    np.testing.assert_allclose(env._compute_observations(s).numpy(),
                               np.asarray(jenv._compute_observations(js)), rtol=1e-5, atol=1e-6)


def test_step_at_stage_1_matches_jax(envs):
    """One step with every staged term at its reference scale."""
    jenv, env, jstep, js = envs
    js = js.replace(reward_stage=jnp.asarray(1, jnp.int32))
    s = to_torch_state(js)
    a = (0.5 * np.random.default_rng(5).standard_normal((E, 18))).astype(np.float32)
    js2, s2 = jstep(js, jnp.asarray(a)), env.step(s, torch.as_tensor(a))
    for k in PHYS:
        np.testing.assert_allclose(getattr(s2.phys, k).numpy(), np.asarray(getattr(js2.phys, k)),
                                   atol=5e-3, err_msg=k)
    np.testing.assert_allclose(s2.obs.numpy(), np.asarray(js2.obs), atol=1e-2)
    np.testing.assert_allclose(s2.rew.numpy(), np.asarray(js2.rew), atol=1e-3)
    for k, v in js2.episode_sums.items():
        np.testing.assert_allclose(s2.episode_sums[k].numpy(), np.asarray(v), atol=1e-3,
                                   err_msg=k)


def test_base_terms_match_jax_on_the_quadruped():
    """The base env's trot ``gait_2_step`` (feet 0-3 and 1-2 in phase) and
    ``feet_slip`` on ANYmal-C states, as the JAX env computes them."""
    jc, c = quiet(janymal_c_flat_cfg()), quiet(anymal_c_flat_cfg())
    jc.sim.solver = "aba"
    jenv, env = JLeggedRobot(jc), LeggedRobot(c, device="cpu")
    jstep = jax.jit(jenv.step)
    js = jenv.reset_all(jax.random.PRNGKey(2))
    rng = np.random.default_rng(3)
    for _ in range(10):
        js = jstep(js, jnp.asarray((0.8 * rng.standard_normal((E, 12))).astype(np.float32)))
    s = to_torch_state(js)
    jctx, ctx = jax_ctx(jenv, js), env._contact_context(s)
    for name in ("gait_2_step", "feet_slip"):
        got = getattr(env, f"_reward_{name}")(s, ctx).numpy()
        want = np.asarray(getattr(jenv, f"_reward_{name}")(js, jctx))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
        assert np.abs(want).max() > 0.0, name


def test_registry_builds_the_task():
    env_cfg, train_cfg = task_registry.get_cfgs("elspider_air_flat")
    assert task_registry.task_classes["elspider_air_flat"] is ElSpider
    assert train_cfg.runner.experiment_name == "flat_elspider_air"
    assert env_cfg.rewards.reward_stage_threshold == 8.0 and env_cfg.rewards.reward_max_stage == 1


def test_committed_checkpoint_acts_as_in_jax(envs):
    _, env, _, _ = envs
    runner = OnPolicyRunner(env, elspider_air_ppo_cfg())
    assert runner.load(CKPT)["iteration"] == runner.iteration
    with open(CKPT, "rb") as f:
        params = pickle.load(f)["params"]
    jnet = JActorCritic(num_actions=18)
    obs = np.random.default_rng(2).standard_normal((32, 66)).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(obs), method=jnet.act_inference))
    got = runner.get_inference_policy()(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
