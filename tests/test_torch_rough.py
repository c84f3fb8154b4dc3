"""The rough-terrain slice against the JAX package: the anymal_c_rough env
(JAX env with the ABA solver) at 4 envs on a 2 x 2 grid with levels frozen,
the rough policy, the evaluation script's terrain names, and the checkpoint
loader's refusal of an observation normalizer.

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
from extended_legged_gym_tpu_torch.envs.legged_robot import EnvState, LeggedRobot
from extended_legged_gym_tpu_torch.models.networks import ActorCritic, load_jax_checkpoint
from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
from extended_legged_gym_tpu_torch.physics import EnvPhysParams, PhysState
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_rough_cfg
from extended_legged_gym_tpu_torch.scripts.eval_rough import col_type_names, load_policy

PHYS = ("base_pos", "base_quat", "joint_pos", "base_lin_vel", "base_ang_vel", "joint_vel",
        "contact_anchor")
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


def to_torch_state(js) -> EnvState:
    """A JAX EnvState's values as the port's EnvState."""
    t = lambda x: torch.as_tensor(np.array(x))
    return EnvState(
        phys=PhysState(*[t(getattr(js.phys, k)) for k in PHYS]),
        env_params=EnvPhysParams(t(js.env_params.friction_scale), t(js.env_params.base_mass_delta)),
        episode_length=t(js.episode_length).to(torch.int64), commands=t(js.commands),
        actions=t(js.actions), last_actions=t(js.last_actions), last_dof_vel=t(js.last_dof_vel),
        torques=t(js.torques), feet_air_time=t(js.feet_air_time),
        feet_contact_time=t(js.feet_contact_time), last_contacts=t(js.last_contacts),
        base_lin_vel=t(js.base_lin_vel), base_ang_vel=t(js.base_ang_vel),
        projected_gravity=t(js.projected_gravity), foot_positions=t(js.foot_positions),
        foot_velocities=t(js.foot_velocities), geom_forces=t(js.geom_forces), obs=t(js.obs),
        rew=t(js.rew), reset_buf=t(js.reset_buf), time_out_buf=t(js.time_out_buf),
        episode_sums={k: t(v) for k, v in js.episode_sums.items()},
        episode_return=t(js.episode_return), env_origins=t(js.env_origins),
        measured_heights=t(js.measured_heights), terrain_levels=t(js.terrain_levels).to(torch.int64),
        terrain_types=t(js.terrain_types).to(torch.int64),
        reward_stage=t(js.reward_stage).to(torch.int64))


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
    (lambda c: setattr(c.terrain, "freeze_terrain_levels", False), "terrain-curriculum promotion"),
    (lambda c: setattr(c.domain_rand, "randomize_base_mass", True), "randomize_base_mass"),
    (lambda c: setattr(c.domain_rand, "push_robots", True), "push_robots"),
    (lambda c: setattr(c.noise, "add_noise", True), "add_noise"),
    (lambda c: setattr(c.commands, "heading_command", True), "heading_command"),
    (lambda c: setattr(c.terrain, "trimesh_contacts", True), "triangle-mesh contacts"),
])
def test_env_refuses_what_is_not_ported(change, match):
    cfg = small_rough(anymal_c_rough_cfg())
    cfg.terrain.curriculum = True
    change(cfg)
    with pytest.raises(NotImplementedError, match=match):
        LeggedRobot(cfg, device="cpu")


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
    net = load_policy(ROUGH_CKPT, 235, 12, "cpu")
    assert tuple(net.actor[0].weight.shape) == (512, 235)
    obs = np.random.default_rng(0).standard_normal((64, 235)).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(obs), method=jnet.act_inference))
    with torch.no_grad():
        got = net.act_inference(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num_cols, props", [
    (8, [0.1, 0.1, 0.35, 0.25, 0.2]),
    (8, [0.1, 0.1, 0.2, 0.1, 0.2, 0.1, 0.1, 0.1]),
    (5, [0.2, 0.2, 0.2, 0.2, 0.2]),
])
def test_col_type_names_match_jax(num_cols, props):
    assert col_type_names(num_cols, props) == jcol_type_names(num_cols, props)


def test_checkpoint_with_obs_norm_is_refused(tmp_path):
    """A checkpoint trained with empirical normalization carries ``obs_norm``;
    the port applies no normalizer yet, so loading it raises."""
    rng = np.random.default_rng(0)
    dense = lambda i, o: {"kernel": rng.standard_normal((i, o)).astype(np.float32),
                          "bias": np.zeros(o, np.float32)}
    params = {"params": {"actor": {"Dense_0": dense(4, 2)}, "critic": {"Dense_0": dense(4, 1)},
                         "log_std": np.zeros(2, np.float32)}}
    plain = tmp_path / "plain.pkl"
    with open(plain, "wb") as f:
        pickle.dump({"params": params, "obs_norm": None}, f)
    assert tuple(load_jax_checkpoint(str(plain))["actor.0.weight"].shape) == (2, 4)
    normed = tmp_path / "normed.pkl"
    with open(normed, "wb") as f:
        pickle.dump({"params": params, "obs_norm": {"mean": np.zeros(4), "var": np.ones(4)}}, f)
    with pytest.raises(ValueError, match="observation normalizer"):
        load_jax_checkpoint(str(normed))
