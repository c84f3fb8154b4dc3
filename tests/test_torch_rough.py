"""The rough-terrain slice against the JAX package: the anymal_c_rough env
(JAX env with the ABA solver) at 4 envs on a 2 x 2 grid with levels frozen,
the rough policy, the evaluation script's terrain names, and the checkpoint
loader's return of an observation normalizer.

The JAX reset state is carried into the port (JAX PRNG draws cannot be
reproduced in torch; the spawn levels, origins and terrain can and are
compared exactly); actions come from a numpy seed.  Tolerances are those of
tests/test_torch_env.py: states 5e-3, observations 1e-2 (the 187 height
entries are scaled by 5), rewards 1e-3 absolute."""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.envs.legged_robot import LeggedRobot as JLeggedRobot
from extended_legged_gym_tpu.models.networks import ActorCritic as JActorCritic
from extended_legged_gym_tpu.robots.anymal_c import anymal_c_rough_cfg as janymal_c_rough_cfg
from extended_legged_gym_tpu.scripts.eval_rough import col_type_names as jcol_type_names
from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
from extended_legged_gym_tpu_torch.models.networks import load_jax_checkpoint
from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_rough_cfg
from extended_legged_gym_tpu_torch.scripts.eval_rough import col_type_names, load_policy
from torch_parity import PHYS, to_torch_state

ROUGH_CKPT = "logs/rough_anymal_c/Aug21_13-00-24_r5_rough3/model_final.pkl"
E = 4


def small_rough(cfg):
    """The setup of tests/test_physics_kernel.py::test_env_rough_pallas_matches_aba
    with levels frozen (and spawn levels 0..1, so the draw matters)."""
    cfg.env.num_envs = E
    cfg.terrain.num_rows = 2
    cfg.terrain.num_cols = 2
    cfg.terrain.terrain_length = 4.0
    cfg.terrain.terrain_width = 4.0
    cfg.terrain.border_size = 2.0
    cfg.terrain.max_init_terrain_level = 1
    cfg.terrain.curriculum = False
    cfg.terrain.freeze_terrain_levels = True
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.randomize_friction = False
    cfg.domain_rand.randomize_base_mass = False
    return cfg


@pytest.fixture(scope="module")
def envs():
    jc = small_rough(janymal_c_rough_cfg())
    jc.sim.solver = "aba"
    jenv = JLeggedRobot(jc)
    env = LeggedRobot(small_rough(anymal_c_rough_cfg()), device="cpu")
    return jenv, env, jax.jit(jenv.step)


def test_terrain_and_spawn_match_jax(envs):
    jenv, env, _ = envs
    np.testing.assert_array_equal(env.terrain.height, np.asarray(jenv.terrain.height))
    assert not env.terrain.is_flat and env.decimated_step.rough
    np.testing.assert_array_equal(env.init_terrain_levels.numpy(), jenv.init_terrain_levels)
    np.testing.assert_array_equal(env.init_terrain_types.numpy(), jenv.init_terrain_types)
    np.testing.assert_array_equal(env.terrain_origins.numpy(), jenv.terrain_origins)
    np.testing.assert_array_equal(env.height_points.numpy(), jenv.height_points)
    assert env.num_height_points == 187
    assert env.reward_names == jenv.reward_names
    np.testing.assert_allclose(env.reward_scale_table.numpy(), jenv.reward_scale_table)


def test_reset_all_matches_jax(envs):
    jenv, env, _ = envs
    s = env.reset_all(seed=3)
    js = jenv.reset_all(jax.random.PRNGKey(0))
    for k in ("obs", "commands", "measured_heights", "geom_forces", "env_origins"):
        assert tuple(getattr(s, k).shape) == tuple(getattr(js, k).shape), k
    assert s.obs.shape[1] == 235
    np.testing.assert_array_equal(s.env_origins.numpy(), np.asarray(js.env_origins))
    np.testing.assert_array_equal(s.terrain_levels.numpy(), np.asarray(js.terrain_levels))
    np.testing.assert_array_equal(s.terrain_types.numpy(), np.asarray(js.terrain_types))
    # the spawn draw: ±0.5 m in xy about the origin, init height above it
    off = (s.phys.base_pos - s.env_origins).numpy()
    assert (np.abs(off[:, :2]) <= 0.5).all() and np.allclose(off[:, 2], 0.6)
    assert set(s.episode_sums) == set(js.episode_sums) and int(s.reward_stage) == 0
    # heights, observations and heights-in-obs from the same (JAX) state agree
    jst = to_torch_state(js)
    np.testing.assert_allclose(env._get_heights(jst.phys).numpy(), np.asarray(js.measured_heights),
                               atol=1e-6)
    np.testing.assert_allclose(env._compute_observations(jst).numpy(), np.asarray(js.obs), atol=1e-6)
    assert float(np.ptp(env.terrain.height)) > 0.05                  # the grid has relief


def test_step_matches_jax(envs):
    jenv, env, jstep = envs
    js = jenv.reset_all(jax.random.PRNGKey(1))
    s = to_torch_state(js)
    rng = np.random.default_rng(0)
    before = pk.DecimatedEnvStep.launches, pk.DecimatedEnvStep.rough_launches
    for i in range(2):
        a = (0.2 * rng.standard_normal((E, 12))).astype(np.float32)
        js = jstep(js, jnp.asarray(a))
        s = env.step(s, torch.as_tensor(a))
        assert not bool(np.asarray(js.reset_buf).any())
        for k in PHYS:
            np.testing.assert_allclose(getattr(s.phys, k).numpy(), np.asarray(getattr(js.phys, k)),
                                       atol=5e-3, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(s.measured_heights.numpy(), np.asarray(js.measured_heights),
                                   atol=5e-3, err_msg=f"heights {i}")
        np.testing.assert_allclose(s.obs.numpy(), np.asarray(js.obs), atol=1e-2, err_msg=f"obs {i}")
        np.testing.assert_allclose(s.rew.numpy(), np.asarray(js.rew), atol=1e-3, err_msg=f"rew {i}")
        np.testing.assert_allclose(s.torques.numpy(), np.asarray(js.torques), atol=0.5)
        np.testing.assert_allclose(s.foot_positions.numpy(), np.asarray(js.foot_positions), atol=5e-3)
        np.testing.assert_array_equal(s.last_contacts.numpy(), np.asarray(js.last_contacts))
        for k in s.episode_sums:
            np.testing.assert_allclose(s.episode_sums[k].numpy(), np.asarray(js.episode_sums[k]),
                                       atol=1e-3, err_msg=k)
    # the CPU path runs the plain version: no kernel launch counted
    assert (pk.DecimatedEnvStep.launches, pk.DecimatedEnvStep.rough_launches) == before


def test_fall_resets_on_spawn_origins(envs):
    """An env whose base touches the ground terminates and is re-drawn about
    its own (frozen) spawn origin, as in the JAX env."""
    jenv, env, jstep = envs
    js = jenv.reset_all(jax.random.PRNGKey(2))
    low = js.phys.base_pos.at[1, 2].set(js.env_origins[1, 2] + 0.05)
    js = js.replace(phys=js.phys.replace(base_pos=low))
    s = to_torch_state(js)
    a = np.zeros((E, 12), np.float32)
    js = jstep(js, jnp.asarray(a))
    s = env.step(s, torch.as_tensor(a))
    np.testing.assert_array_equal(s.reset_buf.numpy(), np.asarray(js.reset_buf))
    assert bool(s.reset_buf[1]) and not bool(s.time_out_buf[1])
    np.testing.assert_array_equal(s.terrain_levels.numpy(), np.asarray(js.terrain_levels))
    off = (s.phys.base_pos[1] - s.env_origins[1]).numpy()
    assert np.abs(off[:2]).max() <= 0.5 and abs(off[2] - 0.6) < 1e-5
    np.testing.assert_allclose(s.obs[0].numpy(), np.asarray(js.obs[0]), atol=1e-2)


@pytest.mark.parametrize("change, match", [
    (lambda c: setattr(c.terrain, "mesh_type", "confined"), "terrain.mesh_type"),
    (lambda c: setattr(c.commands, "curriculum", True), "commands.curriculum"),
    (lambda c: setattr(c.commands, "heading_command", True), "heading_command"),
    (lambda c: setattr(c.terrain, "trimesh_contacts", True), "triangle-mesh contacts"),
])
def test_env_refuses_what_is_not_ported(change, match):
    """An unknown mesh type raises NotImplementedError; triangle-mesh
    contacts are ported and, as in the JAX package, raise ValueError on a
    terrain without a mesh (this generated grid carries none).  The command
    options, refused until they were ported, build their env
    (tests/test_torch_commands.py holds them to the JAX env)."""
    cfg = small_rough(anymal_c_rough_cfg())
    cfg.terrain.curriculum = True
    change(cfg)
    if match in ("commands.curriculum", "heading_command"):
        env = LeggedRobot(cfg, device="cpu")
        assert env.cfg.commands.curriculum or env.cfg.commands.heading_command
        return
    error = ValueError if match == "triangle-mesh contacts" else NotImplementedError
    with pytest.raises(error, match=match):
        LeggedRobot(cfg, device="cpu")


@pytest.mark.parametrize("change", [
    lambda c: setattr(c.rewards.scales, "termination", -1.0),
    lambda c: setattr(c.env, "num_privileged_obs", 48),
], ids=["rewards.scales.termination", "env.num_privileged_obs"])
def test_env_takes_termination_and_privileged_obs(change):
    """The termination term and privileged observations are ported: the
    env builds with either."""
    cfg = small_rough(anymal_c_rough_cfg())
    change(cfg)
    env = LeggedRobot(cfg, device="cpu")
    s = env.reset_all(seed=0)
    assert (env.termination_scale != 0.0) == ("termination" in s.episode_sums)
    assert (s.privileged_obs is None) == (env.num_privileged_obs is None)


def v_control(cfg):
    """V control with gains the explicit substep keeps stable (as in
    tests/test_torch_env.py)."""
    cfg.control.control_type = "V"
    cfg.control.stiffness = {"HAA": 10.0, "HFE": 10.0, "KFE": 10.0}
    cfg.control.damping = {"HAA": 0.01, "HFE": 0.01, "KFE": 0.01}
    return cfg


def test_v_control_step_matches_jax():
    """V control on the 2 x 2 grid, 4 envs, two control steps: the port env
    (per-substep torques, one B2-route launch per substep on the card) against
    the JAX env with the ABA solver."""
    jc = v_control(small_rough(janymal_c_rough_cfg()))
    jc.sim.solver = "aba"
    jenv = JLeggedRobot(jc)
    env = LeggedRobot(v_control(small_rough(anymal_c_rough_cfg())), device="cpu")
    assert env.decimated_step is None and env.substep.rough
    jstep = jax.jit(jenv.step)
    js = jenv.reset_all(jax.random.PRNGKey(5))
    s = to_torch_state(js)
    rng = np.random.default_rng(3)
    before = pk.EnvStep.rough_launches, pk.DecimatedEnvStep.rough_launches
    for i in range(2):
        a = rng.standard_normal((E, 12)).astype(np.float32)
        js = jstep(js, jnp.asarray(a))
        s = env.step(s, torch.as_tensor(a))
        assert not bool(np.asarray(js.reset_buf).any())
        for k in PHYS:
            np.testing.assert_allclose(getattr(s.phys, k).numpy(), np.asarray(getattr(js.phys, k)),
                                       atol=5e-3, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(s.torques.numpy(), np.asarray(js.torques), atol=0.5)
        np.testing.assert_allclose(s.obs.numpy(), np.asarray(js.obs), atol=1e-2, err_msg=f"obs {i}")
        np.testing.assert_allclose(s.rew.numpy(), np.asarray(js.rew), atol=1e-3, err_msg=f"rew {i}")
    assert float(s.torques.abs().max()) > 1.0
    assert (pk.EnvStep.rough_launches, pk.DecimatedEnvStep.rough_launches) == before


def test_rough_policy_matches_jax():
    jnet = JActorCritic(num_actions=12)
    with open(ROUGH_CKPT, "rb") as f:
        params = pickle.load(f)["params"]
    policy = load_policy(ROUGH_CKPT, 235, 12, "cpu")
    obs = np.random.default_rng(0).standard_normal((64, 235)).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(obs), method=jnet.act_inference))
    got = policy(torch.as_tensor(obs)).numpy()
    assert got.shape == (64, 12)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num_cols, props", [
    (8, [0.1, 0.1, 0.35, 0.25, 0.2]),
    (8, [0.1, 0.1, 0.2, 0.1, 0.2, 0.1, 0.1, 0.1]),
    (5, [0.2, 0.2, 0.2, 0.2, 0.2]),
])
def test_col_type_names_match_jax(num_cols, props):
    assert col_type_names(num_cols, props) == jcol_type_names(num_cols, props)


def test_checkpoint_with_obs_norm_is_refused(tmp_path):
    """A checkpoint trained with empirical normalization carries ``obs_norm``.
    The loader no longer refuses it: it returns the normalizer beside the
    parameters (``None`` for a checkpoint without one), and the policy built
    from it applies the normalizer."""
    rng = np.random.default_rng(0)
    dense = lambda i, o: {"kernel": rng.standard_normal((i, o)).astype(np.float32),
                          "bias": np.zeros(o, np.float32)}
    params = {"params": {"actor": {"Dense_0": dense(4, 2)}, "critic": {"Dense_0": dense(4, 1)},
                         "log_std": np.zeros(2, np.float32)}}
    plain = tmp_path / "plain.pkl"
    with open(plain, "wb") as f:
        pickle.dump({"params": params, "obs_norm": None}, f)
    sd, norm = load_jax_checkpoint(str(plain))
    assert tuple(sd["actor.0.weight"].shape) == (2, 4) and norm is None
    normed = tmp_path / "normed.pkl"
    mean, var = np.arange(4, dtype=np.float32), np.full(4, 4.0, np.float32)
    with open(normed, "wb") as f:
        pickle.dump({"params": params, "obs_norm": {"mean": mean, "var": var}}, f)
    sd, norm = load_jax_checkpoint(str(normed))
    np.testing.assert_allclose(norm.mean.numpy(), mean)
    np.testing.assert_allclose(norm.normalize(torch.ones(4)).numpy(), (1 - mean) / np.sqrt(4 + 1e-8),
                               rtol=1e-6)
