"""Pin the port's flat-training evidence, TRAIN_torch_r01.json: the TRAIN_r5
recipe (anymal_c_flat, 4096 envs, seed 2, 2000 iterations from scratch)
trained on an H100 with scripts/train.py and recorded with
scripts/record_training.py.  The fast checks hold the committed artifact to
the acceptance profile of tests/test_training_artifact.py (walking height,
tracking, upright, zero falls) and to its recipe; the committed checkpoint
must load in the port and act as the JAX network does with its parameters
(1e-5)."""
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
