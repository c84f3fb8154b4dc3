"""The ray-observation rough task (anymal_c_rough_raycast) against the JAX
env: 4 envs on a 2 x 2 generated grid, levels frozen.

From one JAX reset with the bases moved, tilted and turned (seeded), the
port's 267-dim observation (235 rough entries, then 32 cone rays as
normalized inverse distances) must equal the JAX env's to 1e-5, and the
noise vector (zero on the ray tail) exactly.  The committed ray checkpoint,
loaded by ``load_jax_checkpoint``, must give the JAX policy's actions on
that observation to 1e-5.  The task registers with the [512, 256, 128]
networks and steps on the CPU without a kernel launch."""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.envs.legged_robot import LeggedRobot as JLeggedRobot
from extended_legged_gym_tpu.models.networks import ActorCritic as JActorCritic
from extended_legged_gym_tpu.robots.anymal_c import (
    anymal_c_rough_raycast_cfg as janymal_c_rough_raycast_cfg)
from extended_legged_gym_tpu_torch import robots  # noqa: F401  (populates the registry)
from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_rough_raycast_cfg
from extended_legged_gym_tpu_torch.scripts.eval_rough import load_policy
from extended_legged_gym_tpu_torch.utils.task_registry import task_registry
from torch_parity import to_torch_state

RAY_CKPT = "logs/rough_raycast_anymal_c/Aug21_13-41-24_r5_rayc/model_final.pkl"
E = 4


def small(cfg):
    cfg.env.num_envs = E
    cfg.terrain.num_rows = cfg.terrain.num_cols = 2
    cfg.terrain.terrain_length = cfg.terrain.terrain_width = 4.0
    cfg.terrain.border_size = 2.0
    cfg.terrain.max_init_terrain_level = 1
    cfg.terrain.freeze_terrain_levels = True
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.randomize_friction = cfg.domain_rand.randomize_base_mass = False
    return cfg


@pytest.fixture(scope="module")
def envs():
    jc = small(janymal_c_rough_raycast_cfg())
    jc.sim.solver = "aba"
    jenv = JLeggedRobot(jc)
    env = LeggedRobot(small(anymal_c_rough_raycast_cfg()), device="cpu")
    return jenv, env


@pytest.fixture(scope="module")
def moved_state(envs):
    """A JAX reset with seeded base moves (+-1 m), heights, tilts and yaws."""
    jenv, _ = envs
    js = jenv.reset_all(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    pos = np.array(js.phys.base_pos)
    pos[:, :2] += rng.uniform(-1.0, 1.0, (E, 2))
    pos[:, 2] += rng.uniform(-0.1, 0.1, E)
    yaw, pitch, roll = rng.uniform(-np.pi, np.pi, E), rng.uniform(-0.3, 0.3, E), rng.uniform(-0.3, 0.3, E)
    cy, sy, cp, sp = np.cos(yaw / 2), np.sin(yaw / 2), np.cos(pitch / 2), np.sin(pitch / 2)
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    quat = np.stack([sr * cp * cy - cr * sp * sy, cr * sp * cy + sr * cp * sy,
                     cr * cp * sy - sr * sp * cy, cr * cp * cy + sr * sp * sy], -1)
    phys = js.phys.replace(base_pos=jnp.asarray(pos, jnp.float32),
                           base_quat=jnp.asarray(quat, jnp.float32))
    js = jenv._refresh_derived(js.replace(phys=phys))
    return js.replace(obs=jenv._compute_observations(js))


def test_observation_matches_jax(envs, moved_state):
    jenv, env = envs
    js = moved_state
    assert env.num_obs == jenv.num_obs == 267 and env.raycaster.num_rays == 32
    s = to_torch_state(js)
    s = env._refresh_derived(s)
    obs = env._compute_observations(s)
    assert obs.shape == (E, 267)
    np.testing.assert_allclose(obs.numpy(), np.asarray(js.obs), atol=1e-5)
    tail = obs[:, 235:]
    assert 0.0 <= float(tail.min()) and float(tail.max()) <= 1.0 and float(tail.max()) > 0.0
    np.testing.assert_array_equal(env.noise_scale_vec.numpy(), np.asarray(jenv.noise_scale_vec))
    assert not env.noise_scale_vec[235:].any() and env.noise_scale_vec[48:235].all()


def test_ray_checkpoint_acts_as_the_jax_policy(envs, moved_state):
    with open(RAY_CKPT, "rb") as f:
        params = pickle.load(f)["params"]
    obs = np.array(moved_state.obs)
    jnet = JActorCritic(num_actions=12)
    want = np.asarray(jnet.apply(params, jnp.asarray(obs), method=jnet.act_inference))
    got = load_policy(RAY_CKPT, 267, 12, "cpu")(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_task_registers_and_steps(envs):
    env_cfg, train_cfg = task_registry.get_cfgs("anymal_c_rough_raycast")
    assert env_cfg.env.num_observations == 267 and env_cfg.raycaster.attach_to_obs
    assert train_cfg.runner.experiment_name == "rough_raycast_anymal_c"
    assert train_cfg.policy.actor_hidden_dims == [512, 256, 128]
    _, env = envs
    s = env.reset_all(seed=0)
    before = pk.DecimatedEnvStep.launches, pk.DecimatedEnvStep.rough_launches
    policy = load_policy(RAY_CKPT, 267, 12, "cpu")
    for _ in range(3):
        s = env.step(s, policy(s.obs))
    assert torch.isfinite(s.obs).all() and s.obs.shape == (E, 267)
    assert (pk.DecimatedEnvStep.launches, pk.DecimatedEnvStep.rough_launches) == before
