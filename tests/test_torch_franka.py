"""The fixed-base Franka arm against the JAX package, on the CPU: the model
(8 bodies, 7 joints, one sphere on the fixed base, no feet); one fixed-base
ABA step; the env's end-effector state, observation and each reward term on
the same states, and whole steps through a reset; ``rollout_batch``; the
registry's two tasks; a JAX-initialised actor for the 35-wide observation;
and ``asset.fix_base_link`` on ANYmal-C, whose reset base velocities are
zero and whose base stays where it was reset, as in the JAX env.  The
port's step is not held to the JAX Pallas kernel on the arm: the JAX
package's ``make_decimated_env_step`` and ``make_env_step`` cannot reshape
the empty foot rows of a model without feet, and the kernel body, jitted in
interpret mode, did not finish one Franka substep in 20 minutes on a CPU.
The Pallas body's fixed-base branch is held to the port instead on ANYmal-C
with its base fixed and its legs in contact, where the Pallas bias ordering
and the ABA step's (which the port follows) could part
(tests/test_torch_kernel_host.py, marked slow).  On the arm the only geom
sits on the fixed base, so the two orderings cannot part.

The env states come from the JAX env (ABA solver) after a few steps of
random actions.  Tolerances: the model exactly; the ABA step
tests/test_torch_physics.py's (positions 1e-4 to 5e-4, velocities 2e-2 to
5e-2) and a fixed base's pose exactly; the end-effector state 1e-5, each
reward term and the observation 1e-5 relative plus 1e-6 absolute (the same
float32 formulas); whole steps tests/test_torch_env.py's (states 5e-3,
observations 1e-2, rewards 1e-3); rollout rewards 1e-3 relative plus 1e-4;
actions 1e-5."""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.envs.legged_robot import LeggedRobot as JLeggedRobot
from extended_legged_gym_tpu.models.networks import ActorCritic as JActorCritic
from extended_legged_gym_tpu.physics import default_sim_params as jdefault_sim_params
from extended_legged_gym_tpu.physics.aba import aba_physics_step as jaba_physics_step
from extended_legged_gym_tpu.physics.engine import EnvPhysParams as JEnvPhysParams
from extended_legged_gym_tpu.physics.engine import PhysState as JPhysState
from extended_legged_gym_tpu.physics.serialize import load_model as jload_model
from extended_legged_gym_tpu.robots.anymal_c import anymal_c_flat_cfg as janymal_c_flat_cfg
from extended_legged_gym_tpu.robots.franka import Franka as JFranka
from extended_legged_gym_tpu.robots.franka import franka_cfg as jfranka_cfg
from extended_legged_gym_tpu.robots.task_variants import \
    franka_batch_rollout_cfg as jfranka_batch_rollout_cfg
from extended_legged_gym_tpu.terrain import flat_terrain as jflat_terrain
from extended_legged_gym_tpu_torch import robots  # noqa: F401
from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
from extended_legged_gym_tpu_torch.models.networks import (ActorCritic, load_jax_checkpoint,
                                                           params_to_jax)
from extended_legged_gym_tpu_torch.physics import default_sim_params, load_model
from extended_legged_gym_tpu_torch.physics.aba import aba_physics_step
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_flat_cfg
from extended_legged_gym_tpu_torch.robots.franka import Franka, franka_cfg
from extended_legged_gym_tpu_torch.robots.task_variants import franka_batch_rollout_cfg
from extended_legged_gym_tpu_torch.scripts.bench_kernel import near_standing
from extended_legged_gym_tpu_torch.terrain import flat_terrain
from extended_legged_gym_tpu_torch.utils.task_registry import task_registry
from torch_parity import PHYS, to_torch_state

MODEL = "extended_legged_gym_tpu/robots/data/franka.json"
TOLS = dict(base_pos=1e-4, base_quat=1e-4, joint_pos=5e-4, base_lin_vel=2e-2,
            base_ang_vel=2e-2, joint_vel=5e-2)
E = 4


def test_model_loads_as_in_jax():
    jm, m = jload_model(MODEL), load_model(MODEL)
    assert (m.nb, m.nj, m.ng, m.num_feet, m.fix_base) == (8, 7, 1, 0, True)
    assert jm.fix_base and m.parent == tuple(jm.parent) == (-1, 0, 1, 2, 3, 4, 5, 6)
    assert m.joint_names == tuple(jm.joint_names) and int(m.geom_body[0]) == 0
    for k in ("joint_origin_rot", "joint_origin_pos", "joint_axis", "mass", "com", "inertia",
              "armature", "geom_body", "geom_offset", "geom_radius", "default_dof_pos",
              "torque_limits", "dof_pos_limits", "dof_vel_limits", "ancestor_mask"):
        np.testing.assert_array_equal(getattr(m, k), np.asarray(getattr(jm, k)), err_msg=k)


def _jax_phys(st):
    return JPhysState(*[jnp.asarray(getattr(st, k).numpy()) for k in PHYS])


def test_fixed_base_aba_step_matches_jax():
    """One ABA step on a fixed base: zero base acceleration, the base pose
    unchanged, joints as JAX's ABA."""
    jm, m = jload_model(MODEL), load_model(MODEL)
    B = 8
    st, ep, _ = near_standing(m, B, 0, "cpu", height=0.0)
    st = st.replace(base_lin_vel=torch.zeros(B, 3), base_ang_vel=torch.zeros(B, 3),
                    base_pos=torch.zeros(B, 3))
    tau = torch.as_tensor((20.0 * np.random.default_rng(1).standard_normal((B, 7)))
                          .astype(np.float32))
    jstep = jax.vmap(lambda s, t, e: jaba_physics_step(jm, jflat_terrain(size=10.0),
                                                       jdefault_sim_params(), s, t, e))
    jnew, jrep = jstep(_jax_phys(st), jnp.asarray(tau.numpy()),
                       JEnvPhysParams(jnp.asarray(ep.friction_scale.numpy()),
                                      jnp.asarray(ep.base_mass_delta.numpy())))
    new, rep = aba_physics_step(m, flat_terrain(), default_sim_params(), st, tau, ep)
    for name, atol in TOLS.items():
        np.testing.assert_allclose(getattr(new, name).numpy(), np.asarray(getattr(jnew, name)),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(rep.qdd.numpy(), np.asarray(jrep.qdd), rtol=1e-3,
                               atol=1e-3 * float(np.abs(np.asarray(jrep.qdd)).max()))
    assert float(rep.qdd[:, :6].abs().max()) == 0.0
    assert torch.equal(new.base_pos, st.base_pos) and torch.equal(new.base_quat, st.base_quat)
    assert rep.foot_pos.shape == (B, 0, 3) and tuple(jrep.foot_pos.shape) == (B, 0, 3)
    np.testing.assert_allclose(rep.geom_forces.numpy(), np.asarray(jrep.geom_forces), atol=0.5)


def quiet(cfg, n=E):
    cfg.env.num_envs = n
    cfg.noise.add_noise = False
    cfg.domain_rand.randomize_friction = cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.push_robots = False
    cfg.sim.solver = "aba"
    return cfg


@pytest.fixture(scope="module")
def envs():
    jenv = JFranka(quiet(jfranka_cfg()))
    jstep = jax.jit(jenv.step)
    js = jenv.reset_all(jax.random.PRNGKey(4))
    rng = np.random.default_rng(0)
    for _ in range(6):
        js = jstep(js, jnp.asarray((0.5 * rng.standard_normal((E, 7))).astype(np.float32)))
    assert not bool(np.asarray(js.reset_buf).any())
    return jenv, Franka(quiet(franka_cfg()), device="cpu"), jstep, js


def test_config_matches_jax(envs):
    jenv, env, _, _ = envs
    assert env.model.fix_base and jenv.model.fix_base
    assert env.reward_names == jenv.reward_names
    assert {"ee_position_tracking", "ee_orientation_tracking", "ee_velocity"} <= set(env.reward_names)
    np.testing.assert_allclose(env.reward_scale_table.numpy(), jenv.reward_scale_table, rtol=1e-7)
    assert (env.num_obs, env.num_actions, env.num_feet) == (35, 7, 0)
    np.testing.assert_array_equal(env.p_gains, jenv.p_gains)
    np.testing.assert_array_equal(env.d_gains, jenv.d_gains)
    assert env.decimated_step is not None and env.decimated_step.model.fix_base


def test_ee_state_observation_and_each_reward_term_match_jax(envs):
    jenv, env, _, js = envs
    s = to_torch_state(js)
    for got, want in zip(env._ee_state(s.phys), jenv._ee_state(js.phys)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    jctx = dict(contact=js.geom_forces[:, jenv.feet_geoms, 2] > 1.0)
    ctx = env._contact_context(s)
    for name in env.reward_names:
        got = getattr(env, f"_reward_{name}")(s, ctx).numpy()
        want = np.asarray(getattr(jenv, f"_reward_{name}")(js, jctx))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
        if name.startswith("ee_"):
            assert np.abs(want).min() > 0.0, name
    np.testing.assert_allclose(env._compute_observations(s).numpy(),
                               np.asarray(jenv._compute_observations(js)), rtol=1e-5, atol=1e-6)


def test_steps_through_a_reset_match_jax(envs):
    """Three steps with the same actions; in the last env 0 times out.  The
    other envs keep matching; env 0's base velocities are zero after its
    reset in both, its base back at its origin, its target re-drawn in the
    box pointing down."""
    jenv, env, jstep, js = envs
    s = to_torch_state(js)
    rng = np.random.default_rng(1)
    for k in range(3):
        if k == 2:
            el = js.episode_length.at[0].set(jenv.max_episode_length)
            js = js.replace(episode_length=el)
            s = s.replace(episode_length=torch.as_tensor(np.array(el)).to(torch.int64))
        a = (0.5 * rng.standard_normal((E, 7))).astype(np.float32)
        js, s = jstep(js, jnp.asarray(a)), env.step(s, torch.as_tensor(a))
        keep = slice(1, E) if k == 2 else slice(0, E)
        for name in PHYS:
            np.testing.assert_allclose(getattr(s.phys, name)[keep].numpy(),
                                       np.asarray(getattr(js.phys, name))[keep], atol=5e-3,
                                       err_msg=f"step {k} {name}")
        np.testing.assert_allclose(s.obs[keep].numpy(), np.asarray(js.obs)[keep], atol=1e-2)
        np.testing.assert_allclose(s.rew.numpy(), np.asarray(js.rew), atol=1e-3)
        np.testing.assert_allclose(s.commands[keep].numpy(), np.asarray(js.commands)[keep])
    assert bool(s.reset_buf[0]) and bool(np.asarray(js.reset_buf)[0])
    for p in (s.phys, js.phys):
        assert float(np.abs(np.asarray(p.base_lin_vel)).max()) == 0.0
        assert float(np.abs(np.asarray(p.base_ang_vel)).max()) == 0.0
    np.testing.assert_array_equal(s.phys.base_pos.numpy(), np.asarray(js.phys.base_pos))
    np.testing.assert_array_equal(s.phys.base_pos.numpy(), s.env_origins.numpy())
    c0 = s.commands[0].numpy()
    assert (c0[:3] >= [0.3, -0.4, 0.2]).all() and (c0[:3] <= [0.7, 0.4, 0.8]).all()
    np.testing.assert_array_equal(c0[3:], [0.0, 1.0, 0.0, 0.0])


def test_rollout_batch_matches_jax():
    """2 main envs x 4 samples x 3 steps of rewards from the same state."""
    jc, c = quiet(jfranka_batch_rollout_cfg(2), 2), quiet(franka_batch_rollout_cfg(2), 2)
    jenv, env = JFranka(jc), Franka(c, device="cpu")
    js = jenv.reset_all(jax.random.PRNGKey(2))
    us = (0.5 * np.random.default_rng(3).standard_normal((2, 4, 3, 7))).astype(np.float32)
    want = np.asarray(jax.jit(jenv.rollout_batch)(js, jnp.asarray(us)))
    got = env.rollout_batch(to_torch_state(js), torch.as_tensor(us)).numpy()
    assert got.shape == (2, 4, 3)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_registry_builds_both_tasks():
    for name, n in (("franka", 1024), ("franka_batch_rollout", 8)):
        env_cfg, train_cfg = task_registry.get_cfgs(name)
        assert task_registry.task_classes[name] is Franka
        assert env_cfg.env.num_envs == n and env_cfg.asset.fix_base_link
        assert train_cfg.runner.experiment_name == "franka"
        env_cfg.env.num_envs = 2
        env, _ = task_registry.make_env(name, env_cfg=env_cfg, device="cpu")
        assert env.model.fix_base and env.decimated_step.nf == 0
        s = env.step(env.reset_all(seed=0), torch.zeros(2, 7))
        assert s.obs.shape == (2, 35) and bool(torch.isfinite(s.obs).all())


def test_jax_initialised_actor_loads(tmp_path):
    """A JAX-initialised PPO actor-critic for the 35-wide observation and 7
    actions, written as the JAX runner writes it, gives the port's network
    the same actions; the port's tree goes back to the same parameters."""
    jnet = JActorCritic(num_actions=7)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 35)))
    with open(tmp_path / "model_0.pkl", "wb") as f:
        pickle.dump({"params": jax.tree.map(np.asarray, params), "obs_norm": None,
                     "iteration": 0}, f)
    state_dict, norm = load_jax_checkpoint(str(tmp_path / "model_0.pkl"))
    net = ActorCritic(35, 7)
    net.load_state_dict(state_dict)
    assert norm is None
    obs = np.random.default_rng(2).standard_normal((16, 35)).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(obs), method=jnet.act_inference))
    np.testing.assert_allclose(net.act_inference(torch.as_tensor(obs)).detach().numpy(), want,
                               atol=1e-5)
    back = jax.tree.map(np.asarray, params_to_jax(net))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_fix_base_link_keeps_anymal_c_still_as_in_jax():
    """ANYmal-C with ``asset.fix_base_link``: zero base velocities at reset
    (the reset's ±0.5 draws would otherwise move a fixed base for ever), the
    base where it was reset after steps, the joints as the JAX env's."""
    jc, c = quiet(janymal_c_flat_cfg()), quiet(anymal_c_flat_cfg())
    jc.asset.fix_base_link = c.asset.fix_base_link = True
    jenv, env = JLeggedRobot(jc), LeggedRobot(c, device="cpu")
    assert env.model.fix_base and jenv.model.fix_base
    js = jenv.reset_all(jax.random.PRNGKey(1))
    s = to_torch_state(js)
    assert float(s.phys.base_lin_vel.abs().max()) == float(s.phys.base_ang_vel.abs().max()) == 0.0
    assert float(env.reset_all(seed=0).phys.base_lin_vel.abs().max()) == 0.0
    jstep, rng = jax.jit(jenv.step), np.random.default_rng(2)
    pos0 = s.phys.base_pos.clone()
    for _ in range(3):
        a = (0.5 * rng.standard_normal((E, 12))).astype(np.float32)
        js, s = jstep(js, jnp.asarray(a)), env.step(s, torch.as_tensor(a))
        for name in PHYS:
            np.testing.assert_allclose(getattr(s.phys, name).numpy(),
                                       np.asarray(getattr(js.phys, name)), atol=5e-3, err_msg=name)
    assert not bool(s.reset_buf.any())
    assert torch.equal(s.phys.base_pos, pos0)
    np.testing.assert_array_equal(np.asarray(js.phys.base_pos), pos0.numpy())
