"""Steps on true triangle-mesh contacts against the JAX package's XLA
engine: ``elair_barrier_nav``, ``anymal_c_timberpile_nav`` and
``elair_timberpile_nav`` (confined arenas cut to a 2 x 2 grid of 4 m
subterrains, the wall-corrected mesh attached, ``trimesh_contacts`` on), 2
envs.

Two steps through a reset (env 0 times out) from the JAX state 10 steps of
random actions after its reset (the robots stand on the mesh; the
timber-pile tasks' starts, 0.4-0.5 m, lie below their arenas' 0.6 m pile
tops, as in the JAX package, where the bases touch the piles at once and
the episode ends, so this test lifts them by 0.6 m; the unlifted start has
its own test below): the
envs not reset match to tests/test_torch_env.py's tolerances (states 5e-3,
observations 1e-2, rewards 1e-3), the first step's contact forces on every
env to rtol 1e-3 and 0.5 N.  Then one whole MPC cycle of
``elair_barrier_nav`` (2 mains x 4 samples x H=3, one diffusion step) with
the JAX cycle's sampling noise injected: the executed step to 2e-3 and the
shifted plan to 2e-3 (tests/test_torch_mpc_step.py's), and the engine's
substeps counted exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu_torch.physics.engine import EngineEnvStep
from test_torch_nav_plan_percept import task_pair
from torch_family import to_port
from torch_parity import PHYS, one_torch_thread  # noqa: F401 (autouse)

E = 2


@pytest.mark.parametrize("task, lift", [("elair_barrier_nav", 0.0),
                                        ("anymal_c_timberpile_nav", 0.6),
                                        ("elair_timberpile_nav", 0.6)])
def test_mesh_contact_steps_through_a_reset(task, lift):
    jenv, env = task_pair(task)
    assert env.terrain.contact_trimesh and jenv.terrain.contact_trimesh and env.engine_step
    jstep = jax.jit(jenv.step)
    js = jenv.reset_all(jax.random.PRNGKey(6))
    js = js.replace(phys=js.phys.replace(base_pos=js.phys.base_pos.at[:, 2].add(lift)))
    rng = np.random.default_rng(6)
    for _ in range(10):                                   # fall onto the mesh
        js = jstep(js, jnp.asarray((0.3 * rng.standard_normal((E, env.num_actions)))
                                   .astype(np.float32)))
    el = np.asarray(js.episode_length).copy()
    el[0] = jenv.max_episode_length
    js = js.replace(episode_length=jnp.asarray(el, js.episode_length.dtype))
    s = to_port(js)
    fresh = np.zeros(E, bool)
    for k in range(2):
        a = (0.3 * rng.standard_normal((E, env.num_actions))).astype(np.float32)
        js, s = jstep(js, jnp.asarray(a)), env.step(s, torch.as_tensor(a))
        np.testing.assert_array_equal(s.reset_buf.numpy(), np.asarray(js.reset_buf))
        if k == 0:
            np.testing.assert_allclose(s.geom_forces.numpy(), np.asarray(js.geom_forces),
                                       rtol=1e-3, atol=0.5)
            assert float(s.geom_forces[..., 2].sum()) > 1.0, "nothing touched the mesh"
        fresh |= s.reset_buf.numpy()
        keep = ~fresh
        assert fresh[0] and keep.any()
        for name in PHYS:
            np.testing.assert_allclose(getattr(s.phys, name)[keep].numpy(),
                                       np.asarray(getattr(js.phys, name))[keep], atol=5e-3,
                                       err_msg=f"{task} step {k} {name}")
        np.testing.assert_allclose(s.obs[keep].numpy(), np.asarray(js.obs)[keep], atol=1e-2)
        np.testing.assert_allclose(s.rew[keep].numpy(), np.asarray(js.rew)[keep], atol=1e-3)


def test_engine_mpc_step_matches_jax():
    jenv, env = task_pair("elair_barrier_nav")
    to = env.cfg.trajectory_opt
    NS, HN, A = to.num_samples, to.horizon_nodes, env.num_actions
    js = jenv.reset_all(jax.random.PRNGKey(7))
    s = to_port(js)
    nodes = (0.2 * np.random.default_rng(7).standard_normal((E, HN + 1, A))).astype(np.float32)
    key = jax.random.PRNGKey(8)
    js2, jnodes, _ = jax.jit(lambda st, nd, k: jenv.mpc_step(st, nd, k, n_diffuse=1))(
        js, jnp.asarray(nodes), key)
    k_opt, _ = jax.random.split(key)
    noise = np.stack([np.asarray(jax.random.normal(k, (E, NS, HN + 1, A)))
                      for k in jax.random.split(k_opt, 1)])
    optimize = env.optimize_all_trajectories
    env.optimize_all_trajectories = lambda state, nd, generator=None, n_diffuse=None: optimize(
        state, nd, generator, n_diffuse=n_diffuse, noise=torch.as_tensor(noise))
    EngineEnvStep.engine_substeps = 0
    s2, tnodes, _ = env.mpc_step(s, torch.as_tensor(nodes), n_diffuse=1)
    assert EngineEnvStep.engine_substeps == (to.horizon_samples + 2) * env.cfg.control.decimation
    for k in PHYS:
        np.testing.assert_allclose(getattr(s2.phys, k).numpy(), np.asarray(getattr(js2.phys, k)),
                                   atol=2e-3, err_msg=k)
    np.testing.assert_allclose(s2.actions.numpy(), np.asarray(js2.actions), atol=2e-3)
    np.testing.assert_allclose(s2.rew.numpy(), np.asarray(js2.rew), atol=1e-3)
    np.testing.assert_allclose(tnodes.numpy(), np.asarray(jnodes), atol=2e-3)


@pytest.mark.parametrize("task", ["anymal_c_timberpile_nav", "elair_timberpile_nav"])
def test_timber_pile_start_matches_jax(task):
    """The registered start itself, unlifted: three control steps of physics
    (no resets, as in an MPC rollout) from the JAX reset state against JAX's
    XLA engine, every state finite in both and within the tolerances above,
    the first step's contact forces to rtol 1e-3 and 0.5 N.  Then one env
    step: the base touches the pile tops at once, so both packages end the
    episode there (reset_buf set in every env)."""
    jenv, env = task_pair(task)
    js = jenv.reset_all(jax.random.PRNGKey(6))
    s = to_port(js)
    jsub = jax.jit(lambda ph, a: jenv._physics_substeps(ph, a, js.env_params,
                                                        jnp.zeros((E, env.num_dof))))
    rng = np.random.default_rng(6)
    jp, p = js.phys, s.phys
    for k in range(3):
        a = (0.3 * rng.standard_normal((E, env.num_actions))).astype(np.float32)
        jout = jsub(jp, jnp.asarray(a))
        out = env._physics_substeps(p, torch.as_tensor(a), s.env_params,
                                    torch.zeros(E, env.num_dof))
        jp, p = jout[0], out[0]
        if k == 0:
            np.testing.assert_allclose(out[2].geom_forces.numpy(),
                                       np.asarray(jout[2].geom_forces), rtol=1e-3, atol=0.5)
        for name in PHYS:
            j, t = np.asarray(getattr(jp, name)), getattr(p, name).numpy()
            assert np.isfinite(j).all() and np.isfinite(t).all(), f"{task} step {k} {name}"
            np.testing.assert_allclose(t, j, atol=5e-3, err_msg=f"{task} step {k} {name}")
    a = np.zeros((E, env.num_actions), np.float32)
    js2, s2 = jax.jit(jenv.step)(js, jnp.asarray(a)), env.step(s, torch.as_tensor(a))
    np.testing.assert_array_equal(s2.reset_buf.numpy(), np.asarray(js2.reset_buf))
    assert s2.reset_buf.all()
