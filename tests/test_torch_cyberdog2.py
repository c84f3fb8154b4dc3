"""CyberDog2 against the JAX package, on the CPU: the model and the leg
kinematics; the walk family's gait clock, stacked observations, random
resets, absent contact termination and the stand-dance reward curriculum
(tests/test_cyberdog2.py in the port); the ``cyber2_stand`` and
``cyber2_walk`` envs' observation and each reward term on the same states,
and whole steps through a reset, at 4 envs; the registry's five tasks.

The env states come from the JAX env (ABA solver, no noise or friction
draws) after a few steps of random actions.  Tolerances: the model exactly;
leg kinematics and the clock 1e-5 (float32 trigonometry and erf); each
reward term and the observation 1e-5 relative plus 1e-5 absolute (the same
float32 formulas); whole steps tests/test_torch_env.py's (states 5e-3,
observations 1e-2, rewards 1e-3), joint velocities also 1e-3 relative
(CyberDog2's light legs swing at 20-36 rad/s under random actions)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.physics.serialize import load_model as jload_model
from extended_legged_gym_tpu.robots import cyberdog2 as jc2
from extended_legged_gym_tpu.robots.cyberdog2_standdance import \
    CyberStandDanceEnv as JStandDance
from extended_legged_gym_tpu.robots.cyberdog2_standdance import \
    cyberdog2_standdance_cfg as jstand_cfg
from extended_legged_gym_tpu.robots.cyberdog2_walk import CyberWalkEnv as JWalk
from extended_legged_gym_tpu.robots.cyberdog2_walk import contact_clock as jcontact_clock
from extended_legged_gym_tpu.robots.cyberdog2_walk import cyberdog2_c2walk_cfg as jwalk_cfg
from extended_legged_gym_tpu_torch import robots  # noqa: F401
from extended_legged_gym_tpu_torch.physics import load_model
from extended_legged_gym_tpu_torch.robots import cyberdog2 as c2
from extended_legged_gym_tpu_torch.robots.cyberdog2_standdance import (
    CyberStandDanceEnv, cyberdog2_standdance_cfg)
from extended_legged_gym_tpu_torch.robots.cyberdog2_walk import (
    CyberBounceEnv, CyberHopEnv, CyberWalkEnv, contact_clock, cyberdog2_c2walk_cfg)
from extended_legged_gym_tpu_torch.utils.task_registry import task_registry
from torch_parity import PHYS, to_torch_state

MODEL = "extended_legged_gym_tpu/robots/data/cyberdog2.json"
E = 4


def test_model_and_leg_kinematics_match_jax():
    jm, m = jload_model(MODEL), load_model(MODEL)
    assert (m.nb, m.nj, m.ng, m.num_feet, m.fix_base) == (13, 12, 37, 4, False)
    for k in ("joint_origin_rot", "joint_origin_pos", "joint_axis", "mass", "inertia",
              "geom_body", "geom_offset", "geom_radius", "foot_geom", "default_dof_pos"):
        np.testing.assert_array_equal(getattr(m, k), np.asarray(getattr(jm, k)), err_msg=k)
    a = np.random.default_rng(0).uniform(-1.0, 1.0, (64, 3)).astype(np.float32)
    a[:, 2] = -np.abs(a[:, 2]) - 0.3
    for sign in (1.0, -1.0):
        f = c2.foot_position_in_hip_frame(torch.as_tensor(a), sign)
        np.testing.assert_allclose(
            f.numpy(), np.asarray(jc2.foot_position_in_hip_frame(jnp.asarray(a), sign)), atol=1e-5)
        ik = c2.foot_ik_in_hip_frame(f, sign).numpy()
        np.testing.assert_allclose(
            ik, np.asarray(jc2.foot_ik_in_hip_frame(jnp.asarray(f.numpy()), sign)), atol=1e-5)


@pytest.mark.parametrize("gait", [(0.5, 0.0, 0.0, 0.5), (0.0, 0.0, 0.5, 0.5), (0.0, 0.0, 0.0, 0.25)])
def test_contact_clock_matches_jax(gait):
    phases, offsets, bounds, duration = gait
    t = np.linspace(0.0, 2.0, 57).astype(np.float32)
    got = contact_clock(torch.as_tensor(t), 1.3, phases, offsets, bounds, duration)
    want = jcontact_clock(jnp.asarray(t), 1.3, phases, offsets, bounds, duration)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_contact_clock_trot_bound_and_warp():
    """tests/test_cyberdog2.py's clock checks: the trot's diagonal pairs in
    phase with the pairs anti-phased, the bound's front pair against the
    rear, the stance quarter warped onto [0, 0.5]."""
    idx, _, desired = contact_clock(torch.tensor([0.25]), 1.0, 0.5, 0.0, 0.0)
    np.testing.assert_allclose(idx[0].numpy(), [0.75, 0.25, 0.25, 0.75], atol=1e-6)
    d = desired[0].numpy()
    assert d[1] > 0.95 and d[2] > 0.95 and d[0] < 0.05 and d[3] < 0.05
    i = contact_clock(torch.tensor([0.2]), 1.0, 0.0, 0.0, 0.5)[0][0].numpy()
    np.testing.assert_allclose(i[0], i[3] + 0.5, atol=1e-6)
    np.testing.assert_allclose(i[1], i[2] - 0.5, atol=1e-6)
    clock = contact_clock(torch.tensor([0.125]), 1.0, 0.0, 0.0, 0.0, duration=0.25)[1]
    np.testing.assert_allclose(clock[0, 1].item(), 1.0, atol=1e-5)


def _walk(cls=CyberWalkEnv, n=E):
    cfg = cyberdog2_c2walk_cfg()
    cfg.env.num_envs = n
    return cls(cfg, device="cpu")


def test_walk_env_stacked_obs_shift_random_resets_and_no_contact_termination():
    env = _walk()
    assert env.num_obs == env.single_obs_dim * env.num_state_history == 141
    s = env.reset_all(seed=3)
    dq = (s.phys.joint_pos - env.default_dof_pos).abs()
    assert float(dq.max()) <= 0.1 + 1e-6 and float(dq.std()) > 1e-3
    assert float(s.phys.base_lin_vel.abs().max()) <= 0.1 + 1e-6
    assert float(s.phys.joint_vel.abs().max()) <= 0.1 + 1e-6
    d = env.single_obs_dim
    s1 = env.step(s, torch.zeros(E, 12))
    s2 = env.step(s1, torch.zeros(E, 12))
    torch.testing.assert_close(s2.obs[:, :d], s1.obs[:, d:2 * d], atol=1e-6, rtol=0)
    gen = torch.Generator().manual_seed(1)
    for _ in range(8):
        s2 = env.step(s2, 0.3 * torch.randn(E, 12, generator=gen))
    assert bool(torch.isfinite(s2.obs).all()) and bool(torch.isfinite(s2.rew).all())
    assert not bool(s2.reset_buf.any())


def test_standdance_reward_curriculum_stages():
    cfg = cyberdog2_standdance_cfg()
    cfg.env.num_envs = 2
    env = CyberStandDanceEnv(cfg, device="cpu")
    assert env.reward_scale_table.shape[0] == 3
    col = env.reward_scale_table[:, env.reward_names.index("feet_slip")]
    np.testing.assert_allclose((col[1] / col[0]).item(), 0.8 / 0.6, rtol=1e-5)
    np.testing.assert_allclose((col[2] / col[0]).item(), 1.0 / 0.6, rtol=1e-5)


def quiet(cfg):
    cfg.env.num_envs = E
    cfg.noise.add_noise = False
    cfg.domain_rand.randomize_friction = cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.push_robots = False
    # the JAX env on its ABA engine; the port's keeps sim.solver "pallas",
    # its kernel route (the plain version on the CPU)
    if type(cfg).__module__.startswith("extended_legged_gym_tpu."):
        cfg.sim.solver = "aba"
    return cfg


TASKS = {"cyber2_stand": (JStandDance, jstand_cfg, CyberStandDanceEnv, cyberdog2_standdance_cfg),
         "cyber2_walk": (JWalk, jwalk_cfg, CyberWalkEnv, cyberdog2_c2walk_cfg)}


@pytest.fixture(scope="module", params=list(TASKS))
def envs(request):
    jcls, jcfg, cls, cfg = TASKS[request.param]
    jenv = jcls(quiet(jcfg()))
    jstep = jax.jit(jenv.step)
    js = jenv.reset_all(jax.random.PRNGKey(4))
    rng = np.random.default_rng(0)
    for _ in range(6):
        js = jstep(js, jnp.asarray((0.3 * rng.standard_normal((E, 12))).astype(np.float32)))
    # episode lengths on both sides of the mercy windows (30 and 50 steps)
    js = js.replace(episode_length=jnp.asarray([60, 10, 200, 35], js.episode_length.dtype))
    return jenv, cls(quiet(cfg()), device="cpu"), jstep, js


def jax_ctx(jenv, s):
    contact = s.geom_forces[:, jenv.feet_geoms, 2] > 1.0
    contact_filt = contact | s.last_contacts
    return dict(contact=contact, contact_filt=contact_filt,
                first_contact=(s.feet_air_time > 0.0) & contact_filt,
                feet_air_time=s.feet_air_time + jenv.dt,
                feet_contact_time=s.feet_contact_time + jenv.dt)


def test_config_observation_and_each_reward_term_match_jax(envs):
    jenv, env, _, js = envs
    assert env.reward_names == jenv.reward_names
    np.testing.assert_allclose(env.reward_scale_table.numpy(), jenv.reward_scale_table, rtol=1e-6)
    np.testing.assert_allclose(env.default_foot_offsets.numpy(),
                               np.asarray(jenv.default_foot_offsets), atol=1e-6)
    s = to_torch_state(js)
    jctx, ctx = jax_ctx(jenv, js), env._contact_context(s)
    names = set(env.reward_names) | {"lift_up", "stand_air", "foot_twist", "front_contact_force",
                                     "hip_still", "action_q_diff"}
    for name in sorted(names):
        got = getattr(env, f"_reward_{name}")(s, ctx).numpy()
        want = np.asarray(getattr(jenv, f"_reward_{name}")(js, jctx))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=name)
    for name in ("upright", "feet_clearance_cmd_linear", "foot_shift", "dof_vel"):
        assert np.abs(np.asarray(getattr(jenv, f"_reward_{name}")(js, jctx))).max() > 0.0, name
    np.testing.assert_allclose(env._compute_observations(s).numpy(),
                               np.asarray(jenv._compute_observations(js)), rtol=1e-5, atol=1e-5)
    for got, want in zip(env._check_termination(s), jenv._check_termination(js)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_steps_through_a_reset_match_jax(envs):
    """Two steps with the same actions from fresh episodes, env 0 timing
    out in the first: both envs reset the same envs in every step, the envs
    not reset keep matching.  (The stand env's joint-limit protection resets
    its sitting robots once an episode is 4 steps old.)"""
    jenv, env, jstep, js = envs
    el = np.zeros(E, np.int64)
    el[0] = jenv.max_episode_length
    js = js.replace(episode_length=jnp.asarray(el, js.episode_length.dtype))
    s = to_torch_state(js)
    rng = np.random.default_rng(1)
    fresh = np.zeros(E, bool)                 # reset in this or an earlier step
    for k in range(2):
        a = (0.3 * rng.standard_normal((E, 12))).astype(np.float32)
        js, s = jstep(js, jnp.asarray(a)), env.step(s, torch.as_tensor(a))
        np.testing.assert_array_equal(s.reset_buf.numpy(), np.asarray(js.reset_buf))
        fresh |= s.reset_buf.numpy()
        keep = ~fresh
        assert fresh[0] and keep.any()
        for name in PHYS:
            np.testing.assert_allclose(getattr(s.phys, name)[keep].numpy(),
                                       np.asarray(getattr(js.phys, name))[keep], atol=5e-3,
                                       rtol=1e-3 if name == "joint_vel" else 0.0,
                                       err_msg=f"step {k} {name}")
        np.testing.assert_allclose(s.obs[keep].numpy(), np.asarray(js.obs)[keep], atol=1e-2)
        np.testing.assert_allclose(s.rew[keep].numpy(), np.asarray(js.rew)[keep], atol=1e-3)
        np.testing.assert_array_equal(s.episode_length[fresh].numpy(),
                                      np.asarray(js.episode_length)[fresh])


def test_registry_builds_the_five_tasks():
    want = {"cyberdog2_walk": (None, "cyberdog2_walk", 48),
            "cyber2_stand": (CyberStandDanceEnv, "stand_dance_cyber", 48),
            "cyber2_walk": (CyberWalkEnv, "walk_cyber", 141),
            "cyber2_hop": (CyberHopEnv, "walk_cyber", 141),
            "cyber2_bounce": (CyberBounceEnv, "walk_cyber", 141)}
    for name, (cls, exp, obs) in want.items():
        env_cfg, train_cfg = task_registry.get_cfgs(name)
        if cls is not None:
            assert task_registry.task_classes[name] is cls
        assert train_cfg.runner.experiment_name == exp and env_cfg.env.num_observations == obs
        assert env_cfg.env.num_envs == 4096 and env_cfg.terrain.mesh_type == "plane"
