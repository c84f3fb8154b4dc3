"""The plain LeggedRobot family (A1, Go2, ANYmal-B, Cassie, rough ElSpider)
and the ANYmal-C, Go2 and ElSpider pose, load, stand, student and
foot-tracking variants against the JAX package, on the CPU: each of the
eighteen tasks' configs and ``go2_dialmpc_flat_cfg`` field by field, the new
models, the registry (59 tasks, 31 up to this family); each task's observation, privileged
observation and every active reward term on the same drawn states (4 envs);
each base term the port adds (termination and no_fly among them) and each
variant term, one case per term.

The states are the JAX env's reset state with every field a term reads
drawn from a numpy seed (tests/torch_family.py: feet in and out of contact,
joint velocities and torques past their limits, terminations and
time-outs), carried into the port.  Tolerances: configs and models exactly;
each reward term, the observation and the privileged observation 1e-5
relative plus 1e-5 absolute (the same float32 formulas; the contact and
limit thresholds hold exactly on these states)."""
import jax.numpy as jnp
import numpy as np
import pytest

from extended_legged_gym_tpu.physics.serialize import load_model as jload_model
from extended_legged_gym_tpu.robots import go2 as jgo2
from extended_legged_gym_tpu.robots import task_registry as jtask_registry
from extended_legged_gym_tpu_torch.physics import load_model
from extended_legged_gym_tpu_torch.robots import go2
from extended_legged_gym_tpu_torch.utils.task_registry import task_registry
from torch_family import TASKS, assert_cfg_equal, drawn_state, jax_ctx, make_pair, to_port

DATA = "extended_legged_gym_tpu/robots/data/"
@pytest.mark.parametrize("task", TASKS + ("go2_dialmpc_flat",))
def test_config_matches_jax(task):
    if task == "go2_dialmpc_flat":
        cfg, jcfg, tc, jtc = go2.go2_dialmpc_flat_cfg(), jgo2.go2_dialmpc_flat_cfg(), None, None
        assert task_registry.task_classes["go2_dialmpc_flat"].__name__ == \
            jtask_registry.task_classes["go2_dialmpc_flat"].__name__
    else:
        (cfg, tc), (jcfg, jtc) = task_registry.get_cfgs(task), jtask_registry.get_cfgs(task)
        assert task_registry.task_classes[task].__name__ == \
            jtask_registry.task_classes[task].__name__
    assert_cfg_equal(cfg, jcfg)
    if tc is not None:
        assert_cfg_equal(tc, jtc)
    # the default joint angles the JAX config names are the model's
    angles = jcfg.init_state.default_joint_angles
    if angles:
        m = load_model(cfg.asset.file)
        np.testing.assert_array_equal(m.default_dof_pos,
                                      np.float32([angles[n] for n in m.joint_names]))


@pytest.mark.parametrize("robot, sizes", [("a1", (13, 12, 4)), ("go2", (13, 12, 4)),
                                          ("anymal_b", (13, 12, 4)), ("cassie", (13, 12, 2)),
                                          ("elspider_air", (19, 18, 6))])
def test_model_loads_as_in_jax(robot, sizes):
    jm, m = jload_model(DATA + robot + ".json"), load_model(DATA + robot + ".json")
    assert (m.nb, m.nj, m.num_feet) == sizes and not m.fix_base
    for k in ("body_names", "joint_names", "foot_names"):
        assert list(getattr(m, k)) == list(getattr(jm, k)), k
    for k in ("parent", "joint_origin_rot", "joint_origin_pos", "joint_axis", "mass", "inertia",
              "com", "geom_body", "geom_offset", "geom_radius", "foot_body", "foot_geom",
              "foot_offset", "foot_radius", "default_dof_pos", "dof_pos_limits", "dof_vel_limits",
              "torque_limits", "armature", "ancestor_mask", "base_init_height"):
        np.testing.assert_array_equal(getattr(m, k), np.asarray(getattr(jm, k)), err_msg=k)


def test_registry_holds_the_ported_tasks():
    assert len(task_registry.task_classes) == 59
    assert set(TASKS) <= set(task_registry.task_classes) <= set(jtask_registry.task_classes)
    for task in TASKS:
        env_cfg, train_cfg = task_registry.get_cfgs(task)
        assert env_cfg.env.num_envs == 4096 and train_cfg is not None, task


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(task):
        if task not in cache:
            cache[task] = make_pair(task)
        return cache[task]

    return get


def _terms(env, jenv, s, js, names):
    ctx, jctx = env._contact_context(s), jax_ctx(jenv, js)
    for name in names:
        got = getattr(env, f"_reward_{name}")(s, ctx).numpy()
        want = np.asarray(getattr(jenv, f"_reward_{name}")(js, jctx))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=name)
    return ctx


@pytest.mark.parametrize("task", TASKS)
def test_observation_and_each_reward_term_match_jax(pairs, task):
    jenv, env = pairs(task)
    assert env.reward_names == jenv.reward_names, task
    np.testing.assert_allclose(env.reward_scale_table.numpy(), jenv.reward_scale_table,
                               rtol=1e-7)
    assert env.termination_scale == pytest.approx(jenv.termination_scale, rel=1e-7)
    assert (env.num_obs, env.num_privileged_obs, env.model.fix_base) == \
        (jenv.num_obs, jenv.num_privileged_obs, bool(jenv.model.fix_base))
    js = drawn_state(jenv, 7)
    s = to_port(js)
    _terms(env, jenv, s, js, env.reward_names)
    np.testing.assert_allclose(env._compute_observations(s).numpy(),
                               np.asarray(jenv._compute_observations(js)), rtol=1e-5, atol=1e-5)
    if env.num_privileged_obs:
        np.testing.assert_allclose(env._compute_privileged_observations(s).numpy(),
                                   np.asarray(jenv._compute_privileged_observations(js)),
                                   rtol=1e-5, atol=1e-5)
    for got, want in zip(env._check_termination(s), jenv._check_termination(js)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


BASE_TERMS = ("base_foot_height", "dof_vel", "dof_vel_limits", "feet_contact_forces",
              "feet_stumble", "feet_stumble_liftup", "four_footup", "jump_air", "stand_still",
              "torque_limits", "termination", "no_fly")


@pytest.mark.parametrize("term", BASE_TERMS)
def test_base_term_matches_jax(pairs, term):
    """Each term the port's base env adds, on the biped's and the
    quadruped's drawn states; each is non-zero on some env."""
    for task in ("cassie", "a1"):
        jenv, env = pairs(task)
        js = drawn_state(jenv, 11)
        _terms(env, jenv, to_port(js), js, [term])
        want = np.asarray(getattr(jenv, f"_reward_{term}")(js, jax_ctx(jenv, js)))
        assert np.abs(want).max() > 0.0, (task, term)


VARIANT_TERMS = (("load_adapt_anymal_c", "orientation"), ("pose_anymal_c", "pose_orientation"),
                 ("pose_anymal_c", "pose_height"), ("stand_anymal_c", "stand_pitch"),
                 ("stand_go2_flat", "hind_contact"), ("stand_go2_flat", "front_up"),
                 ("foot_track_elspider_air_flat", "raibert_base_pos_track"),
                 ("foot_track_elspider_air_flat", "raibert_foot_pos_track"),
                 ("foot_track_elspider_air_flat", "raibert_foot_pos_track_z"),
                 ("foot_track_elspider_air_hang", "raibert_foot_swing_contact"))


@pytest.mark.parametrize("task, term", VARIANT_TERMS)
def test_variant_term_matches_jax(pairs, task, term):
    jenv, env = pairs(task)
    for seed in (3, 5):
        js = drawn_state(jenv, seed)
        _terms(env, jenv, to_port(js), js, [term])
        assert np.abs(np.asarray(getattr(jenv, f"_reward_{term}")(js, jax_ctx(jenv, js)))).max() > 0


def test_termination_reward_enters_after_the_clip_with_its_own_sum(pairs):
    """Cassie (-200 x dt, not clipped): the step's reward and episode sums
    of the JAX ``_compute_reward`` on a drawn state, and the termination
    sum folds into the episode metrics at the reset."""
    jenv, env = pairs("cassie")
    js = drawn_state(jenv, 13)
    js = js.replace(episode_sums={k: jnp.zeros_like(v) for k, v in js.episode_sums.items()})
    s = to_port(js)
    js2, jrew = jenv._compute_reward(js)
    s2, rew = env._compute_reward(s)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), rtol=1e-5, atol=1e-5)
    assert set(s2.episode_sums) == set(js2.episode_sums) and "termination" in s2.episode_sums
    for k, v in js2.episode_sums.items():
        np.testing.assert_allclose(s2.episode_sums[k].numpy(), np.asarray(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    term = s2.episode_sums["termination"].numpy()
    fell = (s.reset_buf & ~s.time_out_buf).numpy()
    np.testing.assert_allclose(term, np.where(fell, -200.0 * env.dt, 0.0), rtol=1e-6)
    assert fell.any() and "rew_termination" in env.zero_episode_metrics()
    s3 = env._reset_envs(s2, s2.reset_buf)
    want = term[s2.reset_buf.numpy()].sum() / env.max_episode_length_s
    np.testing.assert_allclose(float(s3.episode_metrics["rew_termination"]), want, rtol=1e-6)
