"""The config knobs that choose and shape the physics, against the JAX env:
``sim.enforce_dof_vel_limits``, ``asset.armature``, ``sim.solver`` and an
injected model and terrain.

Each case runs ``anymal_c_flat`` (no noise, randomization or pushes, so a
step draws nothing) at 4 envs from the JAX env's reset state for 3 control
steps with the same seeded actions, and holds the positions, orientations
and contact anchors to the JAX env's at atol 1e-5 and the velocities at
5e-5 (float32 rounding of contact-stiff joint accelerations, ~1e4 rad/s^2,
times dt: the gaps measured here reach 2.1e-5 rad/s, the positions' 5e-7);
torch runs float32 on one thread.  The JAX env runs its ABA engine on the
CPU (its ``"pallas"`` solver there steps ABA too), or its CRBA engine where
the port's does.  The JAX env cannot trace its CRBA step with the model it
loads (its ``ancestor_mask`` is a host array indexed inside the step's
scan), so that case injects the same model with the mask as a device
array.

The kernel's side of the two table-borne knobs: the wrapper writes them into
the rows the kernel reads (``TF_VLIM``, ``TF_ARM``), and the CUDA source's
per-env body, compiled for the host (tests/test_torch_kernel_host.py), run on
those tables matches the plain step with the same options."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.envs.legged_robot import LeggedRobot as JLeggedRobot
from extended_legged_gym_tpu.physics.serialize import load_model as jload_model
from extended_legged_gym_tpu.robots.anymal_c import anymal_c_flat_cfg as janymal_c_flat_cfg
from extended_legged_gym_tpu.terrain.heightfield import from_numpy as jfrom_numpy
from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
from extended_legged_gym_tpu_torch.envs.legged_robot_config import (
    UNREAD_ENV_FIELDS, UNREAD_TRAIN_FIELDS, LeggedRobotCfgPPO)
from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
from extended_legged_gym_tpu_torch.physics import EngineEnvStep, EnvPhysParams, load_model
from extended_legged_gym_tpu_torch.physics.engine import default_sim_params, physics_step
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_flat_cfg
from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner
from extended_legged_gym_tpu_torch.terrain import flat_terrain, from_numpy
from test_torch_kernel_host import TOLS, _run_host, host_lib  # noqa: F401 (fixture)
from torch_parity import PHYS, one_torch_thread, to_torch_state  # noqa: F401 (autouse)

E, STEPS = 4, 3
ATOL = dict(base_pos=1e-5, base_quat=1e-5, joint_pos=1e-5, contact_anchor=1e-5,
            base_lin_vel=5e-5, base_ang_vel=5e-5, joint_vel=5e-5)
FAST = 30.0        # rad/s, past ANYmal-C's 20 rad/s joint velocity limit


def quiet(cfg, solver, **options):
    """``cfg`` at E envs with nothing drawn in a step, ``solver`` and the
    ``group__field`` options set."""
    cfg.env.num_envs = E
    cfg.noise.add_noise = False
    cfg.domain_rand.randomize_friction = cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.push_robots = False
    cfg.sim.solver = solver
    for key, value in options.items():
        group, field = key.split("__")
        setattr(getattr(cfg, group), field, value)
    return cfg


def slope():
    """A 10 m square heightfield at 0.25 m: a 5% slope in x with bumps."""
    x, y = np.meshgrid(np.arange(41) * 0.25, np.arange(41) * 0.25, indexing="ij")
    return (0.05 * x + 0.02 * np.sin(2.0 * x) * np.cos(1.5 * y) - 0.25).astype(np.float32)


def heavy(model, replace):
    """``model`` with a 20% heavier base."""
    mass = np.array(model.mass, np.float32)
    mass[0] *= 1.2
    return replace(model, mass=mass)


def run_pair(jsolver, solver, fast=False, inject=False, **options):
    """(port states, JAX states) after each of STEPS control steps, and the
    port env."""
    jkw, kw = {}, {}
    if jsolver == "crba" or inject:
        jm = jload_model(janymal_c_flat_cfg().asset.file)
        jm = jm.replace(ancestor_mask=jnp.asarray(jm.ancestor_mask))
        jkw["model"] = heavy(jm, lambda m, **c: m.replace(**c)) if inject else jm
    if inject:
        kw["model"] = heavy(load_model(anymal_c_flat_cfg().asset.file),
                            lambda m, **c: dataclasses.replace(m, _tensors={}, **c))
        jkw["terrain"] = jfrom_numpy(slope(), 0.25, origin=(-5.0, -5.0), friction=0.8)
        kw["terrain"] = from_numpy(slope(), 0.25, origin=(-5.0, -5.0), friction=0.8)
    jenv = JLeggedRobot(quiet(janymal_c_flat_cfg(), jsolver, **options), **jkw)
    env = LeggedRobot(quiet(anymal_c_flat_cfg(), solver, **options), device="cpu", **kw)
    js = jenv.reset_all(jax.random.PRNGKey(3))
    if fast:
        sign = np.sign(np.random.default_rng(0).standard_normal((E, 12))).astype(np.float32)
        js = js.replace(phys=js.phys.replace(joint_vel=jnp.asarray(FAST * sign)))
    s = to_torch_state(js)
    a = (0.5 * np.random.default_rng(1).standard_normal((E, 12))).astype(np.float32)
    jstep, got, want = jax.jit(jenv.step), [], []
    for _ in range(STEPS):
        js = jstep(js, jnp.asarray(a))
        s = env.step(s, torch.as_tensor(a))
        got.append(s)
        want.append(js)
    return got, want, env


def assert_states_match(got, want):
    for i, (s, js) in enumerate(zip(got, want)):
        assert not bool(np.asarray(js.reset_buf).any())
        for k in PHYS:
            np.testing.assert_allclose(getattr(s.phys, k).numpy(), np.asarray(getattr(js.phys, k)),
                                       atol=ATOL[k], rtol=0, err_msg=f"step {i} {k}")


def test_vel_limits_off_matches_jax():
    """From joint velocities of 30 rad/s the joints keep spinning past their
    20 rad/s limit, as in the JAX env; with the limits on they are clamped."""
    got, want, env = run_pair("aba", "pallas", fast=True, sim__enforce_dof_vel_limits=False)
    assert env.decimated_step is not None and not env.sim_params.enforce_dof_vel_limits
    assert float(got[0].phys.joint_vel.abs().max()) > 25.0
    assert_states_match(got, want)
    clamped, _, _ = run_pair("aba", "pallas", fast=True)
    assert float(clamped[0].phys.joint_vel.abs().max()) <= 20.0


def test_armature_matches_jax():
    got, want, env = run_pair("aba", "pallas", asset__armature=0.05)
    np.testing.assert_array_equal(env.model.armature, np.full(12, 0.05, np.float32))
    assert_states_match(got, want)
    plain, _, _ = run_pair("aba", "pallas")
    assert float((plain[-1].phys.joint_vel - got[-1].phys.joint_vel).abs().max()) > 1e-2


@pytest.mark.parametrize("solver", ["aba", "crba"])
def test_engine_solver_matches_jax(solver):
    """``sim.solver`` "aba" / "crba": the plain engine with that solver, no
    kernel route, one engine substep per physics substep."""
    n0 = EngineEnvStep.engine_substeps
    got, want, env = run_pair(solver, solver)
    assert env.decimated_step is None and env.substep is None
    assert env.engine_step.sp.solver == solver
    assert EngineEnvStep.engine_substeps - n0 == STEPS * env.cfg.control.decimation
    assert_states_match(got, want)


def test_injected_model_and_terrain_match_jax():
    """A heavier base and a bumpy slope, injected into both envs: the port
    env takes them in place of the config's model file and plane (B2's route,
    whose plain version runs on the CPU) and spawns on the plane's grid."""
    got, want, env = run_pair("pallas", "pallas", inject=True)
    assert env.decimated_step is not None and env.decimated_step.rough
    assert env.terrain.friction == np.float32(0.8) and not env.custom_origins
    assert float(env.model.mass[0]) == pytest.approx(1.2 * float(load_model(
        anymal_c_flat_cfg().asset.file).mass[0]), rel=1e-6)
    assert_states_match(got, want)


def test_pallas_interpret_and_unknown_solvers_raise():
    for solver, match in (("pallas_interpret", "always runs the kernel's plain version"),
                          ("featherstone", "unknown sim.solver")):
        with pytest.raises(ValueError, match=match):
            LeggedRobot(quiet(anymal_c_flat_cfg(), solver), device="cpu")


def _other_value(v):
    if isinstance(v, bool):
        return not v
    if isinstance(v, (int, float)):
        return v + 1
    if isinstance(v, list):
        return [x + 1 for x in v]
    return "set" if v is None else v + "_set"


@pytest.mark.parametrize("path", UNREAD_ENV_FIELDS + UNREAD_TRAIN_FIELDS)
def test_unread_fields_refuse_other_values(path):
    """A field that neither package reads takes no other value than its
    default: the env (or the runner) raises, naming it."""
    train = path in UNREAD_TRAIN_FIELDS
    cfg = LeggedRobotCfgPPO() if train else quiet(anymal_c_flat_cfg(), "pallas")
    *groups, name = path.split(".")
    owner = cfg
    for g in groups:
        owner = getattr(owner, g)
    setattr(owner, name, _other_value(getattr(owner, name)))
    with pytest.raises(ValueError, match=f"{path}="):
        if train:
            OnPolicyRunner(None, cfg)
        else:
            LeggedRobot(cfg, device="cpu")


def test_physics_step_takes_pallas_as_aba():
    m = load_model(anymal_c_flat_cfg().asset.file)
    env = LeggedRobot(quiet(anymal_c_flat_cfg(), "pallas"), device="cpu")
    assert env.sim_params.solver == "pallas" and env.decimated_step is not None
    s = env.reset_all(seed=2)
    tau = torch.as_tensor(np.random.default_rng(2).standard_normal((E, 12)).astype(np.float32))
    ep = EnvPhysParams(torch.ones(E), torch.zeros(E))
    a, _ = physics_step(m, flat_terrain(), default_sim_params(solver="pallas"), s.phys, tau, ep)
    b, _ = physics_step(m, flat_terrain(), default_sim_params(solver="aba"), s.phys, tau, ep)
    for k in PHYS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("rough", [False, True])
def test_kernel_tables_carry_the_options(host_lib, rough):  # noqa: F811
    """The wrapper writes 500 rad/s into every velocity-limit row with the
    limits off and the armature into the armature rows; the kernel body fed
    those tables matches the plain step with the same options from joint
    velocities past the limit (flat B1 and the slope's B2)."""
    options = dict(sim__enforce_dof_vel_limits=False, asset__armature=0.05)
    kw = dict(terrain=from_numpy(slope(), 0.25, origin=(-5.0, -5.0))) if rough else {}
    env = LeggedRobot(quiet(anymal_c_flat_cfg(), "pallas", **options), device="cpu", **kw)
    step = env.decimated_step
    assert step.rough == rough
    np.testing.assert_array_equal(step.tf_host[pk.TF_VLIM:pk.TF_VLIM + 12], np.full(12, 500.0))
    np.testing.assert_array_equal(step.tf_host[pk.TF_ARM:pk.TF_ARM + 12],
                                  np.full(12, 0.05, np.float32))
    s = env.reset_all(seed=1)
    sign = torch.as_tensor(np.sign(np.random.default_rng(3).standard_normal((E, 12))),
                           dtype=torch.float32)
    st = s.phys.replace(joint_vel=FAST * sign)
    act = torch.as_tensor(np.random.default_rng(4).standard_normal((E, 12)).astype(np.float32))
    new, tau, gf, fp, fv = _run_host(host_lib, step, st, act, s.env_params)
    ref, tau_r, rep = step.plain(st, act, s.env_params)
    assert float(ref.joint_vel.abs().max()) > 25.0
    for name, atol in TOLS.items():
        np.testing.assert_allclose(getattr(new, name).numpy(), getattr(ref, name).numpy(),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(tau.numpy(), tau_r.numpy(), atol=1e-2)
