"""The engine route: which step each new task runs, and the plain ABA engine
on a ceiling scene against the JAX package's XLA engine.

The JAX env leaves its fused kernel for the XLA engine when the actuator
network is on, the terrain has a ceiling or its contacts run on the
triangle mesh; the port takes ``EngineEnvStep`` on the last two (the
actuator network keeps its torques-in kernel route).  For each of the 11
tasks this slice registers, the JAX predicate is evaluated on the JAX env
and must name the route the port's env takes (kernel, engine, or none for
the kinematic planners), and one step plus one rollout batch must advance
that route's counter only: ``EngineEnvStep.engine_substeps`` by exactly
``(1 + H + 1) x decimation``, or the fused step's calls.  An engine-route
scene never touches ``DecimatedEnvStep`` (its constructor and call raise
here).  Under a ceiling (a tunnel arena, heightfield contacts, 4 envs:
env 0 times out, env 1's base is pressed into the ceiling, which
terminates it), two steps through the resets match JAX on the envs not
reset: states to 5e-3, observations 1e-2, rewards 1e-3
(tests/test_torch_env.py's); the first step's contact forces, the
ceiling's push on env 1 included, match on every env (rtol 1e-3, 0.5 N)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.robots import task_registry as jtask_registry
from extended_legged_gym_tpu.terrain.heightfield import sample_ceiling
from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
from extended_legged_gym_tpu_torch.physics.engine import EngineEnvStep
from extended_legged_gym_tpu_torch.utils.task_registry import task_registry
from test_torch_nav_plan_percept import NEW_TASKS, shrink
from torch_family import to_port
from torch_parity import PHYS, one_torch_thread  # noqa: F401 (autouse)

E = 2
ENGINE = {"anymal_c_timberpile_nav", "elair_barrier_nav", "elair_timberpile_nav"}
NO_PHYSICS = {"anymal_c_plan_grad_sampling", "elspider_air_plan_grad_sampling"}


def jax_route(jenv) -> str:
    """The JAX env's physics route by its own predicate
    (envs/legged_robot.py: the fused step unless the actuator network, a
    ceiling or mesh contacts)."""
    if type(jenv).__name__ == "RobotPlanGradSampling":
        return "none"
    c, t = jenv.cfg, jenv.terrain
    fused = (c.sim.solver in ("pallas", "pallas_interpret") and not c.control.use_actuator_network
             and not t.has_ceiling and not t.contact_trimesh)
    return "kernel" if fused else "engine"


class _Counting:
    """Counts calls of ``DecimatedEnvStep.__call__``."""

    def __init__(self, monkeypatch):
        self.calls = 0
        call = pk.DecimatedEnvStep.__call__

        def counted(step, *a, **kw):
            self.calls += 1
            return call(step, *a, **kw)
        monkeypatch.setattr(pk.DecimatedEnvStep, "__call__", counted)


@pytest.mark.parametrize("task", NEW_TASKS)
def test_route_predicate_matches_jax(task, monkeypatch):
    jcfg = shrink(jtask_registry.get_cfgs(task)[0])
    jenv = jtask_registry.task_classes[task](jcfg)
    cfg = shrink(task_registry.get_cfgs(task)[0])
    env, _ = task_registry.make_env(task, env_cfg=cfg, device="cpu")
    want = jax_route(jenv)
    assert want == ("engine" if task in ENGINE else "none" if task in NO_PHYSICS else "kernel")
    assert (env.engine_step is not None) == (want == "engine")
    assert (env.decimated_step is not None) == (want != "engine")
    assert env.terrain.has_ceiling == jenv.terrain.has_ceiling
    assert env.terrain.contact_trimesh == jenv.terrain.contact_trimesh

    counting = _Counting(monkeypatch)
    EngineEnvStep.engine_substeps = 0
    s = env.step(env.reset_all(seed=0), torch.zeros(E, env.num_actions))
    H1 = 1
    if hasattr(env, "rollout_batch"):
        H1 = cfg.trajectory_opt.horizon_samples + 1
        env.rollout_batch(s, torch.zeros(E, 3, H1, env.num_actions))
    steps = 1 + (H1 if hasattr(env, "rollout_batch") else 0)
    decim = cfg.control.decimation
    got = dict(engine=EngineEnvStep.engine_substeps, kernel=counting.calls)
    expect = {"engine": dict(engine=steps * decim, kernel=0),
              "kernel": dict(engine=0, kernel=steps),
              "none": dict(engine=0, kernel=0)}[want]
    assert got == expect, (task, got)


def test_engine_scene_never_touches_the_fused_step(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("DecimatedEnvStep used on an engine-route scene")
    for name in ("__init__", "__call__", "launch", "plain"):
        monkeypatch.setattr(pk.DecimatedEnvStep, name, refuse)
    cfg = shrink(task_registry.get_cfgs("elair_barrier_nav")[0])
    env, _ = task_registry.make_env("elair_barrier_nav", env_cfg=cfg, device="cpu")
    assert env.decimated_step is None and env.substep is None
    EngineEnvStep.engine_substeps = 0
    s = env.step(env.reset_all(seed=0), torch.zeros(E, env.num_actions))
    nodes = torch.zeros(E, cfg.trajectory_opt.horizon_nodes + 1, env.num_actions)
    s, nodes, _ = env.mpc_step(s, nodes, torch.Generator().manual_seed(0))
    H1 = cfg.trajectory_opt.horizon_samples + 1
    want = (2 + cfg.trajectory_opt.num_diffuse_steps * H1) * cfg.control.decimation
    assert EngineEnvStep.engine_substeps == want
    assert bool(torch.isfinite(s.obs).all()) and bool(torch.isfinite(nodes).all())


def test_mesh_contacts_need_a_mesh():
    cfg = shrink(task_registry.get_cfgs("anymal_c_nav")[0])
    cfg.terrain.trimesh_contacts = True                     # a plane carries no mesh
    with pytest.raises(ValueError, match="trimesh_contacts"):
        task_registry.make_env("anymal_c_nav", env_cfg=cfg, device="cpu")


def ceiling_pair(n):
    """``anymal_c_timberpile_nav`` at ``n`` envs turned into a tunnel arena
    with heightfield contacts (the ceiling branch)."""
    cfgs = []
    for reg in (jtask_registry, task_registry):
        cfg = shrink(reg.get_cfgs("anymal_c_timberpile_nav")[0], n)
        cfg.terrain.mesh_type = "confined_heightfield"
        cfg.terrain.confined_terrain_proportions = [1.0, 1.0, 1.0, 1.0]
        cfg.terrain.trimesh_contacts = False
        cfgs.append(cfg)
    jcfg, cfg = cfgs
    jcfg.sim.solver = "aba"
    jenv = jtask_registry.task_classes["anymal_c_timberpile_nav"](jcfg)
    env, _ = task_registry.make_env("anymal_c_timberpile_nav", env_cfg=cfg, device="cpu")
    return jenv, env


def test_steps_under_a_ceiling_through_a_reset():
    n = 4
    jenv, env = ceiling_pair(n)
    assert env.terrain.has_ceiling and not env.terrain.contact_trimesh and env.engine_step
    js = jenv.reset_all(jax.random.PRNGKey(5))
    base_r = float(np.asarray(jenv.model.geom_radius)[np.asarray(jenv.model.geom_body) == 0].max())
    pos = np.asarray(js.phys.base_pos).copy()
    ceil = np.asarray(sample_ceiling(jenv.terrain, jnp.asarray(pos[:, :2])))
    assert (ceil < 1e5).all()
    pos[1, 2] = ceil[1] - base_r + 0.05                    # the base's top 5 cm in the ceiling
    js = js.replace(phys=js.phys.replace(base_pos=jnp.asarray(pos)))
    el = np.asarray(js.episode_length).copy()
    el[0] = jenv.max_episode_length
    js = js.replace(episode_length=jnp.asarray(el, js.episode_length.dtype))
    jstep = jax.jit(jenv.step)
    s = to_port(js)
    rng = np.random.default_rng(5)
    fresh = np.zeros(n, bool)
    for k in range(2):
        a = (0.3 * rng.standard_normal((n, 12))).astype(np.float32)
        js, s = jstep(js, jnp.asarray(a)), env.step(s, torch.as_tensor(a))
        np.testing.assert_array_equal(s.reset_buf.numpy(), np.asarray(js.reset_buf))
        if k == 0:
            np.testing.assert_allclose(s.geom_forces.numpy(), np.asarray(js.geom_forces),
                                       rtol=1e-3, atol=0.5)
            assert float(s.geom_forces[1, :, 2].min()) < -1.0, "the ceiling pushed nothing down"
            assert bool(s.reset_buf[0]) and bool(s.reset_buf[1])
        fresh |= s.reset_buf.numpy()
        keep = ~fresh
        assert keep.any()
        for name in PHYS:
            np.testing.assert_allclose(getattr(s.phys, name)[keep].numpy(),
                                       np.asarray(getattr(js.phys, name))[keep], atol=5e-3,
                                       err_msg=f"step {k} {name}")
        np.testing.assert_allclose(s.obs[keep].numpy(), np.asarray(js.obs)[keep], atol=1e-2)
        np.testing.assert_allclose(s.rew[keep].numpy(), np.asarray(js.rew)[keep], atol=1e-3)
        np.testing.assert_allclose(s.geom_forces[keep].numpy(), np.asarray(js.geom_forces)[keep],
                                   rtol=1e-3, atol=0.5)
