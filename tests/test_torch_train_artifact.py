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
their own; the rough checkpoint must act as the JAX network (1e-5).

ESTIMATOR_CL_torch_r01.json / _r02.json: the terrain estimator's closed loop
(scripts/estimator_closed_loop.py, ESTIMATOR_CL_r5's protocol) with the JAX
package's committed estimator and with the port's own trained 300 iterations
(its committed checkpoint must predict as the JAX network does with its
parameters, 1e-5); ESTIMATOR_torch_r01.json: the ESTIMATOR_r4 recipe;
DISTILL_NATIVE_torch_r01.json: the DISTILL_NATIVE_r5 recipe.  Each carries its
recipe, the card line, finite values and the JAX artifact's numbers, and
meets the fault criteria set before the runs: a closed-loop RMSE of at most
1.5 m with the JAX estimator, a student of at least 0.8 of command with at
most 5 falls.

TRAIN_SEA_torch_r01.json: the committed JAX SEA checkpoint evaluated in the
port at TRAIN_r4.json's sea_variant protocol; TRAIN_ELSPIDER_torch_r01.json:
the committed JAX ElSpider checkpoint evaluated in the port and the port's
own elspider_air_flat training at TRAIN_ELSPIDER_r4's recipe.  Each carries
its protocol, the card line and the JAX numbers, and meets the fault
criteria set before the runs: SEA at least 0.6 of command with at most 2
falls in 16 envs; ElSpider at least 0.85 of command with at most 1.6 falls
per 16 envs (tests/test_training_artifact.py:88-90's bars), for both
checkpoints.  The port's ElSpider checkpoint must act as the JAX network
does with its parameters (1e-5)."""
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


def _closed_loop(name):
    art = _load(name)
    assert art["policy"] == _load("ESTIMATOR_CL_r5.json")["policy"]
    assert (art["n_envs"], art["warmup"], art["n_steps"], art["max_init_terrain_level"],
            art["command_mps"], art["seed"]) == (128, 100, 400, 2, 0.5, 7)
    assert art["camera"] == "48 x 24 -> 32 x 16"
    assert "H100" in art["card"] and art["card"].endswith(" W")
    assert all(np.isfinite(x) for x in _numbers(art))
    for k in ("prediction_rmse_m", "prediction_mae_m", "prediction_rmse_m_near3m"):
        assert 0.0 < art[k], k
    assert 0 <= art["falls_true_rays"] <= 128 and 0 <= art["falls_estimated_rays"] <= 128
    cl = _load("ESTIMATOR_CL_r5.json")
    for k, v in art["reference"].items():
        if k != "source":
            assert v == cl[k], k
    return art


def test_closed_loop_with_the_jax_estimator():
    art = _closed_loop("ESTIMATOR_CL_torch_r01.json")
    assert art["estimator"] == art["reference"]["estimator"]
    assert "training" not in art
    # the fault criterion set before the run
    assert art["prediction_rmse_m"] <= 1.5
    # eval A is RAYCAST_torch_r01's protocol on the same policy and seed
    assert art["tracking_true_rays"] == _load("RAYCAST_torch_r01.json")["tracking_true_rays"]


def test_closed_loop_with_the_port_s_estimator():
    art = _closed_loop("ESTIMATOR_CL_torch_r02.json")
    tr = art["training"]
    assert (tr["iterations"], tr["num_envs"], tr["num_steps_per_env"]) == (300, 128, 24)
    assert tr["curve"][-1][0] == 300 and tr["loss_final"] < tr["loss_first"]
    assert "not record" in art["note"]
    assert art["estimator"] != art["reference"]["estimator"]
    assert os.path.exists(os.path.join(ROOT, art["estimator"]))


def test_port_estimator_checkpoint_acts_as_the_jax_network():
    from extended_legged_gym_tpu.models.terrain_estimator import TerrainEstimator as JEstimator
    from extended_legged_gym_tpu_torch.models.terrain_estimator import (TerrainEstimator,
                                                                        estimator_params_from_jax)

    with open(os.path.join(ROOT, _load("ESTIMATOR_CL_torch_r02.json")["estimator"]), "rb") as f:
        params = pickle.load(f)["params"]
    r = np.random.default_rng(3)
    depth = r.random((8, 16, 32)).astype(np.float32)
    proprio = r.standard_normal((8, 9)).astype(np.float32)
    carry = r.standard_normal((8, 128)).astype(np.float32)
    jnet = JEstimator(num_raycast=32, proprio_dim=9)
    want, jc = jnet.apply(params, jnp.asarray(depth), jnp.asarray(proprio), jnp.asarray(carry))
    net = estimator_params_from_jax(TerrainEstimator(32, 9, (16, 32)), params)
    got, c = net(torch.as_tensor(depth), torch.as_tensor(proprio), torch.as_tensor(carry))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(jc), atol=1e-5)


def test_estimator_evidence_records_the_recipe():
    art = _load("ESTIMATOR_torch_r01.json")
    assert (art["iterations"], art["num_envs"]) == (300, 64)
    assert art["recipe"]["camera"] == "48 x 24 -> 32 x 16"
    assert art["recipe"]["rays"] == "spherical 8 x 4, 5 m"
    assert len(art["curve"]) == 20 and art["curve"][-1][0] == 300
    assert art["loss_final"] < art["loss_first"]
    assert "H100" in art["card"] and art["card"].endswith(" W")
    assert all(np.isfinite(x) for x in _numbers(art))
    r4 = _load("ESTIMATOR_r4.json")
    for k in ("iterations", "num_envs", "loss_first", "loss_final"):
        assert art["reference"][k] == r4[k], k


def test_distillation_evidence_meets_its_fault_criteria():
    art = _load("DISTILL_NATIVE_torch_r01.json")
    r5 = _load("DISTILL_NATIVE_r5.json")
    assert art["teacher"] == r5["teacher"]
    assert (art["iterations"], art["num_envs"]) == (1500, 256)
    assert art["recipe"]["student_hidden_dims"] == [256, 256, 128]
    assert art["recipe"]["optimizer_steps_per_iteration"] == 4
    assert len(art["curve"]) == 20 and art["curve"][-1][0] == 1500
    ev = art["student_eval"]
    assert (ev["command_mps"], ev["n_envs"], ev["n_steps"], ev["warmup"]) == (0.5, 256, 300, 100)
    # the fault criteria set before the run
    assert ev["achieved_over_command"] >= 0.8 and ev["falls"] <= 5
    assert "H100" in art["card"] and art["card"].endswith(" W")
    assert all(np.isfinite(x) for x in _numbers(art))
    for k in ("teacher", "iterations", "num_envs", "behavior_loss_first", "behavior_loss_final",
              "student_eval"):
        assert art["reference"][k] == r5[k], k


def _load(name):
    with open(os.path.join(ROOT, name)) as f:
        return json.load(f)


def _protocol(block, cmd):
    assert (block["n_envs"], block["n_steps"], block["command_mps"]) == (16, 500, cmd), block
    assert block["card"].startswith("NVIDIA H100"), block
    assert all(np.isfinite(block[k]) for k in ("achieved_over_command", "upright_mean",
                                                "base_height_mean", "falls")), block


def test_sea_artifact_meets_its_fault_criteria():
    art = _load("TRAIN_SEA_torch_r01.json")
    _protocol(art, 0.7)
    ref = art["reference"]
    assert ref["source"] == "TRAIN_r4.json:sea_variant" and ref["checkpoint"] == art["checkpoint"]
    assert art["achieved_over_command"] >= 0.6 and art["falls"] <= 2, art
    assert abs(art["achieved_over_command"] - ref["achieved_over_command"]) <= 0.05, art


def test_elspider_artifact_meets_its_fault_criteria():
    art = _load("TRAIN_ELSPIDER_torch_r01.json")
    for block in (art, art["jax_checkpoint_in_port"]):
        _protocol(block, 0.5)
        assert block["achieved_over_command"] >= 0.85 and block["falls"] <= 1.6, block
    ref, tr = art["reference"], art["training"]
    assert ref["source"] == "TRAIN_ELSPIDER_r4.json"
    assert art["jax_checkpoint_in_port"]["checkpoint"] == ref["checkpoint"]
    assert (tr["num_envs"], tr["seed"], tr["iterations"], tr["segments"]) == (4096, 1, 1500, 1)
    assert tr["nonfinite_skips"] == 0 and tr["final_reward_stage"] == 1.0
    assert {"final_tracking_lin_vel_rew", "final_feet_slip_rew"} <= set(ref["training"])
    assert np.isfinite(tr["final_feet_slip_rew"]) and tr["final_tracking_lin_vel_rew"] > 0.8


def test_elspider_checkpoint_acts_as_the_jax_network():
    from extended_legged_gym_tpu_torch.robots.elspider_air import (ElSpider,
                                                                   elspider_air_flat_cfg,
                                                                   elspider_air_ppo_cfg)

    ckpt = os.path.join(ROOT, _load("TRAIN_ELSPIDER_torch_r01.json")["checkpoint"])
    cfg = elspider_air_flat_cfg()
    cfg.env.num_envs = 2
    runner = OnPolicyRunner(ElSpider(cfg, device="cpu"), elspider_air_ppo_cfg())
    assert runner.load(ckpt)["iteration"] == 1500
    with open(ckpt, "rb") as f:
        params = pickle.load(f)["params"]
    jnet = JActorCritic(num_actions=18)
    obs = np.random.default_rng(4).standard_normal((32, 66)).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(obs), method=jnet.act_inference))
    got = runner.get_inference_policy()(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
