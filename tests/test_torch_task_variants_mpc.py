"""The gait schedulers (utils/gait_scheduler.py), the ElSpider sampling-MPC
env's rewards and termination, and the new sampling-MPC tasks' rollout
batches against the JAX package.

The schedulers' targets and rewards on drawn times, foot heights, contacts
and joint angles to 1e-6 (the same float32 formulas).  The ElSpider MPC
env's two scheduler terms and its upside-down termination on drawn states
(tests/torch_family.drawn_state; mirrors tests/test_task_variants.py:82-89)
to 1e-5.  One ``rollout_batch`` (E=1, S=3, 4 steps) of
``go2_traj_grad_sampling``, ``cassie_traj_grad_sampling`` (Cassie's tables
on a plane) and ``elspider_air_dialmpc`` (the hexapod on a 2 x 2 grid of
the rough terrain) on the plain route against the JAX env on its ABA
solver: rewards to 1e-3 (tests/test_torch_mpc.py's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.utils import gait_scheduler as J
from extended_legged_gym_tpu_torch.utils import gait_scheduler as G
from torch_family import drawn_state, jax_ctx, make_pair, to_port
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


def _cfgs(mod, async_=False):
    c = (mod.AsyncGaitSchedulerCfg if async_ else mod.GaitSchedulerCfg)()
    c.period, c.duty, c.swing_height = 1.4, 0.45, 0.07
    c.foot_phases = [0.0, 0.0, 0.5, 0.5, 0.5, 0.0]
    return c


def test_gait_schedulers_match_jax():
    rng = np.random.default_rng(0)
    t = rng.uniform(0.0, 5.0, (7,)).astype(np.float32)
    z = rng.uniform(-0.02, 0.1, (7, 6)).astype(np.float32)
    ground = rng.uniform(-0.05, 0.05, (7, 6)).astype(np.float32)
    contacts = rng.uniform(size=(7, 6)) < 0.5
    q = rng.standard_normal((7, 18)).astype(np.float32)
    nominal = rng.standard_normal(18).astype(np.float32)
    g, jg = G.GaitScheduler(_cfgs(G), device="cpu"), J.GaitScheduler(_cfgs(J))
    a = G.AsyncGaitScheduler(_cfgs(G, True), [(0, 1, 5), (2, 3, 4)], device="cpu")
    ja = J.AsyncGaitScheduler(_cfgs(J, True), [(0, 1, 5), (2, 3, 4)])
    T = torch.as_tensor
    pairs = [
        (g.phase(T(t)), jg.phase(jnp.asarray(t))),
        (g.in_stance(T(t)), jg.in_stance(jnp.asarray(t))),
        (g.foot_z_target(T(t)), jg.foot_z_target(jnp.asarray(t))),
        (g.reward_foot_z_track(T(z), T(t)), jg.reward_foot_z_track(jnp.asarray(z), jnp.asarray(t))),
        (g.reward_foot_z_track(T(z), T(t), T(ground)),
         jg.reward_foot_z_track(jnp.asarray(z), jnp.asarray(t), jnp.asarray(ground))),
        (g.reward_contact_align(T(contacts), T(t)),
         jg.reward_contact_align(jnp.asarray(contacts), jnp.asarray(t))),
        (a.reward_dof_align(T(q)), ja.reward_dof_align(jnp.asarray(q))),
        (a.reward_dof_nominal_pos(T(q), T(nominal)),
         ja.reward_dof_nominal_pos(jnp.asarray(q), jnp.asarray(nominal))),
    ]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6,
                                   err_msg=str(i))
    assert a.cfg.dof_align == ja.cfg.dof_align and a.cfg.dof_nominal_pos == ja.cfg.dof_nominal_pos


def test_elspider_mpc_rewards_and_termination_match_jax():
    jenv, env = make_pair("elspider_air_traj_grad_sampling")
    assert env.reward_names == jenv.reward_names
    assert {"gait_scheduler", "async_gait_scheduler"} <= set(env.reward_names)
    js = drawn_state(jenv, 5)
    qz = np.asarray(js.projected_gravity).copy()
    qz[::2, 2] = 0.5                                     # envs 0 and 2 upside down
    js = js.replace(projected_gravity=jnp.asarray(qz))
    s, jctx = to_port(js), jax_ctx(jenv, js)
    ctx = env._contact_context(s)
    for name in ("gait_scheduler", "async_gait_scheduler"):
        got = getattr(env, f"_reward_{name}")(s, ctx).numpy()
        want = np.asarray(getattr(jenv, f"_reward_{name}")(js, jctx))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=name)
    (reset, timeout), (jreset, jtimeout) = env._check_termination(s), jenv._check_termination(js)
    np.testing.assert_array_equal(reset.numpy(), np.asarray(jreset))
    np.testing.assert_array_equal(timeout.numpy(), np.asarray(jtimeout))
    assert bool(reset[0]) and bool(reset[2])


@pytest.mark.parametrize("task", ["go2_traj_grad_sampling", "cassie_traj_grad_sampling",
                                  "elspider_air_dialmpc"])
def test_rollout_batch_matches_jax(task):
    jenv, env = make_pair(task, n=1)
    assert type(env).__name__ == type(jenv).__name__
    js = jenv.reset_all(jax.random.PRNGKey(0))
    us = (0.5 * np.random.default_rng(1).standard_normal((1, 3, 4, env.num_actions))
          ).astype(np.float32)
    want = np.asarray(jax.jit(jenv.rollout_batch)(js, jnp.asarray(us)))
    got = env.rollout_batch(to_port(js), torch.as_tensor(us)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-3)
