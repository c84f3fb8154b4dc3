"""Pin the port's training evidence.

TRAIN_torch_r01.json: the TRAIN_r5 recipe (anymal_c_flat, 4096 envs, seed
2, 2000 iterations from scratch) trained on an H100 with scripts/train.py and
recorded with scripts/record_training.py.  The fast checks hold the committed
artifact to the acceptance profile of tests/test_training_artifact.py
(walking height, tracking, upright, zero falls) and to its recipe; the
committed checkpoint must load in the port and act as the JAX network does
with its parameters (1e-5).

TRAIN_ROUGH_torch_r03.json: the TRAIN_ROUGH_r5 recipe (anymal_c_rough, 4096
envs, seed 1, 2450 iterations in one segment, terrain curriculum) and its two
rough evaluation blocks; RAYCAST_torch_r01.json: the committed ray policy
under ESTIMATOR_CL_r5's true-ray protocol.  Both must carry their recipe or
protocol, the card line, finite values and the JAX artifact's numbers beside
their own; the rough checkpoint must act as the JAX network (1e-5)."""
import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.models.networks import ActorCritic as JActorCritic
from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_flat_cfg, anymal_c_ppo_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ART = os.path.join(ROOT, "TRAIN_torch_r01.json")


@pytest.fixture(scope="module")
def art():
    with open(_ART) as f:
        return json.load(f)


def test_artifact_meets_acceptance(art):
    assert art["achieved_over_command"] >= 0.85, art
    assert 0.48 <= art["base_height_mean"] <= 0.53, art
    assert art["upright_mean"] < -0.95, art
    assert art["falls"] == 0.0, art
    # within 0.05 of the JAX package's run of the same recipe
    ref = art["reference_TRAIN_r5"]
    assert abs(art["achieved_over_command"] - ref["achieved_over_command"]) <= 0.05, art
    assert art["training"]["final_tracking_lin_vel_rew"] >= 0.9 * ref["final_tracking_lin_vel_rew"]


def test_artifact_records_the_recipe(art):
    tr = art["training"]
    assert art["task"] == "anymal_c_flat" and art["command_mps"] == 0.7
    assert (art["n_envs"], art["n_steps"], art["iteration"]) == (16, 500, 2000)
    assert (tr["num_envs"], tr["seed"], tr["iterations"]) == (4096, 2, 2000)
    assert tr["nonfinite_skips"] == 0 and tr["final_reward_stage"] == 1.0
    assert "H100" in art["card"] and art["card"].endswith(" W")
    for k in ("wall_time_s", "s_per_iteration", "collection_s_per_iteration",
              "update_s_per_iteration", "env_steps_per_s"):
        assert tr[k] > 0, k
    with open(os.path.join(ROOT, "TRAIN_r5.json")) as f:
        r5 = json.load(f)
    ref = art["reference_TRAIN_r5"]
    for k in ("achieved_over_command", "upright_mean", "base_height_mean", "falls"):
        assert ref[k] == r5[k], k
    assert ref["final_tracking_lin_vel_rew"] == r5["training"]["final_tracking_lin_vel_rew"]


def test_checkpoint_loads_and_acts_as_the_jax_network(art):
    ckpt = os.path.join(ROOT, art["checkpoint"])
    cfg = anymal_c_flat_cfg()
    cfg.env.num_envs = 2
    runner = OnPolicyRunner(LeggedRobot(cfg, device="cpu"), anymal_c_ppo_cfg())
    assert runner.load(ckpt)["iteration"] == 2000
    with open(ckpt, "rb") as f:
        params = pickle.load(f)["params"]
    jnet = JActorCritic(num_actions=12, actor_hidden_dims=(128, 64, 32),
                        critic_hidden_dims=(128, 64, 32))
    obs = np.random.default_rng(0).standard_normal((16, 48)).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(obs), method=jnet.act_inference))
    got = runner.get_inference_policy()(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _load(name):
    with open(os.path.join(ROOT, name)) as f:
        return json.load(f)


def _numbers(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _numbers(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from _numbers(v)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        yield obj


def test_rough_training_artifact_records_the_recipe():
    art = _load("TRAIN_ROUGH_torch_r03.json")
    tr = art["training"]
    assert art["task"] == "anymal_c_rough" and art["command_mps"] == 0.7
    assert (tr["num_envs"], tr["seed"], tr["iterations"], tr["segments"]) == (4096, 1, 2450, 1)
    assert tr["nonfinite_skips"] == 0 and tr["final_reward_stage"] == 1.0
    for k in ("final_terrain_level_mean", "final_tracking_lin_vel_rew",
              "final_mean_episode_length", "wall_time_s", "s_per_iteration",
              "collection_s_per_iteration", "update_s_per_iteration"):
        assert tr[k] > 0, k
    for block, level in (("eval_full_difficulty", None), ("eval_level_le2", 2)):
        ev = art[block]
        assert (ev["n_envs"], ev["n_steps"], ev.get("max_init_terrain_level")) == (32, 500, level)
        assert ev["upright_mean"] < -0.9 and ev["falls"] >= 0
    # the acceptance floor of the port's rough training
    assert art["eval_level_le2"]["achieved_over_command"] >= 0.8
    assert tr["final_mean_episode_length"] >= 500
    assert "H100" in art["card"] and art["card"].endswith(" W")
    assert all(np.isfinite(x) for x in _numbers(art))
    r5 = _load("TRAIN_ROUGH_r5.json")
    ref = art["reference"]
    for block in ("eval_full_difficulty", "eval_level_le2"):
        for k in ("achieved_over_command", "falls"):
            assert ref[block][k] == r5[block][k], (block, k)
    for k in ("final_terrain_level_mean", "final_tracking_lin_vel_rew", "final_mean_episode_length"):
        assert ref["training"][k] == r5["training"][k], k
    assert "one segment" in art["note"]
    run = os.path.dirname(os.path.join(ROOT, art["checkpoint"]))
    with open(os.path.join(run, "metrics.jsonl")) as f:
        assert sum(1 for _ in f) == 2450


def test_rough_checkpoint_acts_as_the_jax_network():
    from extended_legged_gym_tpu_torch.scripts.eval_rough import load_policy

    ckpt = os.path.join(ROOT, _load("TRAIN_ROUGH_torch_r03.json")["checkpoint"])
    with open(ckpt, "rb") as f:
        payload = pickle.load(f)
    assert payload["iteration"] == 2450 and payload["reward_stage"] == 1
    jnet = JActorCritic(num_actions=12)
    obs = np.random.default_rng(1).standard_normal((16, 235)).astype(np.float32)
    want = np.asarray(jnet.apply(payload["params"], jnp.asarray(obs), method=jnet.act_inference))
    got = load_policy(ckpt, 235, 12, "cpu")(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_ray_artifact_records_the_protocol():
    art = _load("RAYCAST_torch_r01.json")
    assert art["task"] == "anymal_c_rough_raycast"
    assert (art["n_envs"], art["warmup"], art["n_steps"], art["max_init_terrain_level"],
            art["command_mps"]) == (128, 100, 400, 2, 0.5)
    assert 0.0 < art["tracking_true_rays"] and 0 <= art["falls_true_rays"] <= 128
    assert "H100" in art["card"] and art["card"].endswith(" W")
    assert all(np.isfinite(x) for x in _numbers(art))
    cl = _load("ESTIMATOR_CL_r5.json")
    ref = art["reference"]
    assert ref["policy"] == cl["policy"] == art["checkpoint"]
    for k in ("tracking_true_rays", "falls_true_rays", "n_envs", "n_steps",
              "max_init_terrain_level", "command_mps"):
        assert ref[k] == cl[k], k
