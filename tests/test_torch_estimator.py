"""The terrain-estimator slice against the JAX package: the depth encoders,
the recurrent cells, the committed estimator, one TerrainEstimatorRunner
iteration, the checkpoint in both directions and the scripts.

Parameters go across with ``load_flax_tree`` (the JAX network's own
parameters in the port); inputs are numpy-seeded.

Tolerances: forward passes 1e-5 absolute (float32 convolutions and matmuls
summed in other orders); the runner iteration's loss 1e-4 relative and the
parameters after its Adam step 2e-3 of each tensor's largest magnitude, as
``tests/test_torch_runner.py`` holds a PPO iteration (Adam's first step moves
every parameter by about the learning rate whatever its gradient's size);
the env's base positions after the collection 1e-4 m."""
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.envs.legged_robot import LeggedRobot as JLeggedRobot
from extended_legged_gym_tpu.models import depth_backbone as jdb
from extended_legged_gym_tpu.models.networks import Memory as JMemory
from extended_legged_gym_tpu.models.terrain_estimator import TerrainEstimator as JTerrainEstimator
from extended_legged_gym_tpu.rl.terrain_estimator_runner import (
    TerrainEstimatorRunner as JTerrainEstimatorRunner)
from extended_legged_gym_tpu.robots.anymal_c import anymal_c_flat_cfg as janymal_c_flat_cfg
from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
from extended_legged_gym_tpu_torch.models import depth_backbone as db
from extended_legged_gym_tpu_torch.models.networks import (Memory, flax_tree, load_flax_tree,
                                                           read_checkpoint)
from extended_legged_gym_tpu_torch.models.terrain_estimator import (
    TerrainEstimator, estimator_params_from_jax, estimator_params_to_jax)
from extended_legged_gym_tpu_torch.rl.terrain_estimator_runner import TerrainEstimatorRunner
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_flat_cfg
from torch_parity import to_torch_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ESTIMATOR = os.path.join(ROOT,
                             "logs/terrain_estimator/anymal_c_rough_raycast/estimator_final.pkl")
B, T = 4, 4


def rng(seed):
    return np.random.default_rng(seed)


def to_np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{path}/{k}")


def jax_encoder(name, buffer_len=3):
    return jdb.make_depth_encoder(name, output_dim=24, buffer_len=buffer_len)


@pytest.mark.parametrize("hw", [(16, 32), (15, 29)], ids=["16x32", "15x29"])
@pytest.mark.parametrize("name", ["mlp", "hist_mlp", "cnn", "stack"])
def test_depth_encoder_matches_jax(name, hw):
    """Every make_depth_encoder choice, at a size whose "SAME" padding is
    asymmetric (16 x 32: 16 -> 8 at 5/2 pads 1 + 2) and at an odd size."""
    T_ = 3
    shape = (5, T_) + hw if name in ("hist_mlp", "stack") else (5,) + hw
    x = rng(0).standard_normal(shape).astype(np.float32)
    jenc = jax_encoder(name, T_)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jenc.apply(params, jnp.asarray(x)))
    enc = db.make_depth_encoder(name, hw, output_dim=24, buffer_len=T_)
    load_flax_tree(enc, params["params"])
    got = to_np(enc(torch.as_tensor(x)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert_trees_equal(flax_tree(enc), params["params"])


@pytest.mark.parametrize("hw", [(16, 32), (15, 29)], ids=["16x32", "15x29"])
def test_recurrent_depth_backbone_matches_jax(hw):
    r = rng(1)
    depth = r.standard_normal((3, 5) + hw).astype(np.float32)
    proprio = r.standard_normal((3, 5, 9)).astype(np.float32)
    jnet = jdb.RecurrentDepthBackbone()
    jc = jnet.initialize_carry(None, (5,))
    params = jnet.init(jax.random.PRNGKey(2), jnp.asarray(depth[0]), jnp.asarray(proprio[0]), jc)
    net = db.RecurrentDepthBackbone(hw, 9)
    load_flax_tree(net, params["params"])
    c = net.initialize_carry((5,))
    for t in range(3):
        want, jc = jnet.apply(params, jnp.asarray(depth[t]), jnp.asarray(proprio[t]), jc)
        got, c = net(torch.as_tensor(depth[t]), torch.as_tensor(proprio[t]), c)
        np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(to_np(c), np.asarray(jc), atol=1e-5)


def test_same_padding_is_xla_s():
    """16 -> 8 at 5 taps / stride 2 pads one before and two after; odd sizes
    and stride 1 as lax.padtype_to_pads."""
    assert db.same_pads(16, 5, 2) == (1, 2, 8)
    for n, k, s in ((15, 5, 2), (29, 3, 2), (8, 3, 1), (3, 5, 2)):
        lo_hi = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]
        assert db.same_pads(n, k, s)[:2] == tuple(lo_hi)


@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
def test_memory_matches_jax_with_resets(rnn_type):
    """The GRU and the LSTM over 6 steps, the carry zeroed where an env
    reset (as the runners do), outputs and carries at every step."""
    r = rng(3)
    x = r.standard_normal((6, 5, 7)).astype(np.float32)
    done = r.random((6, 5)) < 0.3
    jm = JMemory(hidden_size=11, rnn_type=rnn_type)
    jc = jm.initialize_carry(None, (5,))
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(x[0]), jc)
    m = Memory(7, 11, rnn_type)
    load_flax_tree(m, params["params"])
    assert_trees_equal(flax_tree(m), params["params"])
    c = m.initialize_carry((5,))
    for t in range(6):
        want, jc = jm.apply(params, jnp.asarray(x[t]), jc)
        got, c = m(torch.as_tensor(x[t]), c)
        np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)
        for a, b in zip(jax.tree_util.tree_leaves(jc), c if isinstance(c, tuple) else (c,)):
            np.testing.assert_allclose(to_np(b), np.asarray(a), atol=1e-5)
        keep = ~done[t]
        jc = jax.tree_util.tree_map(lambda h: h * keep[:, None], jc)
        mask = torch.as_tensor(done[t])
        c = (tuple(torch.where(mask[:, None], 0.0, h) for h in c) if isinstance(c, tuple)
             else torch.where(mask[:, None], 0.0, c))


@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
def test_fresh_cells_follow_flax_initialisers(rnn_type):
    """lecun_normal input kernels (std 1 / sqrt(fan_in)), orthogonal
    recurrent kernels, zero biases."""
    m = Memory(64, 64, rnn_type, generator=torch.Generator().manual_seed(0))
    tree = flax_tree(m)[m.cell_name]
    for name, leaf in tree.items():
        k = leaf["kernel"]
        if name.startswith("h"):
            np.testing.assert_allclose(k.T @ k, np.eye(64), atol=1e-5)
        else:
            assert abs(k.std() * np.sqrt(64) - 1.0) < 0.05, name
        if "bias" in leaf:
            assert not leaf["bias"].any()


def test_committed_estimator_matches_jax():
    """The JAX package's committed estimator (16 x 32 frames, 32 rays): the
    port's step-by-step forward and its window form (predict_sequence, with
    resets) against the JAX network's apply."""
    with open(JAX_ESTIMATOR, "rb") as f:
        params = pickle.load(f)["params"]
    jnet = JTerrainEstimator(num_raycast=32, proprio_dim=9)
    net = estimator_params_from_jax(TerrainEstimator(32, 9, (16, 32)), params)
    assert_trees_equal(estimator_params_to_jax(net)["params"], params["params"])
    r = rng(5)
    depth = r.random((5, 6, 16, 32)).astype(np.float32)
    proprio = r.standard_normal((5, 6, 9)).astype(np.float32)
    done = r.random((5, 6)) < 0.3
    jc, c0 = jnet.initialize_carry(None, (6,)), net.initialize_carry((6,))
    c = c0
    wants = []
    for t in range(5):
        want, jc = jnet.apply(params, jnp.asarray(depth[t]), jnp.asarray(proprio[t]), jc)
        got, c = net(torch.as_tensor(depth[t]), torch.as_tensor(proprio[t]), c)
        np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)
        wants.append(np.asarray(want))
        jc = jnp.where(jnp.asarray(done[t])[:, None], 0.0, jc)
        c = torch.where(torch.as_tensor(done[t])[:, None], 0.0, c)
    seq = net.predict_sequence(torch.as_tensor(depth), torch.as_tensor(proprio),
                               torch.as_tensor(done), c0)
    np.testing.assert_allclose(to_np(seq), np.stack(wants), atol=1e-5)


# ------------------------------------------------------------------ the runner
def sensors(cfg):
    cfg.env.num_envs = B
    cfg.noise.add_noise = False
    cfg.domain_rand.randomize_friction = cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.push_robots = False
    cfg.depth.camera_type = "Warp"
    cfg.depth.original = [24, 12]
    cfg.depth.resized = [16, 8]
    cfg.raycaster.enable_raycast = True
    cfg.raycaster.ray_pattern = "spherical"
    cfg.raycaster.spherical_num_azimuth = 4
    cfg.raycaster.spherical_num_elevation = 2
    cfg.raycaster.max_distance = 5.0
    return cfg


@pytest.fixture(scope="module")
def jax_runner():
    jc = sensors(janymal_c_flat_cfg())
    jc.sim.solver = "aba"
    return JTerrainEstimatorRunner(JLeggedRobot(jc), num_steps_per_env=T, seed=0)


@pytest.fixture(scope="module")
def env():
    return LeggedRobot(sensors(anymal_c_flat_cfg()), device="cpu")


def port_runner(env, jax_runner):
    runner = TerrainEstimatorRunner(env, num_steps_per_env=T, seed=0)
    estimator_params_from_jax(runner.network, jax.device_get(jax_runner.params))
    return runner


def test_runner_iteration_matches_jax(jax_runner, env):
    """One collection of 4 steps of 4 envs with random actions (the JAX
    draws injected) and one Adam step, from the JAX runner's env state and
    parameters."""
    key = jax.random.PRNGKey(11)
    es0 = jax_runner.env.reset_all(jax.random.PRNGKey(3))
    p1, _, es1, jloss = jax_runner._collect_and_update(jax_runner.params, jax_runner.opt_state,
                                                       es0, jax_runner.carry0, key)
    noise = np.stack([np.asarray(jax.random.normal(k, (B, 12)))
                      for k in jax.random.split(key, T)])
    runner = port_runner(env, jax_runner)
    es, loss = runner.collect_and_update(to_torch_state(es0), action_noise=torch.as_tensor(noise))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(to_np(es.phys.base_pos), np.asarray(es1.phys.base_pos), atol=1e-4)
    want = jax.tree_util.tree_leaves_with_path(jax.device_get(p1))
    got = jax.tree_util.tree_leaves(estimator_params_to_jax(runner.network))
    assert len(want) == len(got)
    for (path, w), g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=2e-3 * np.abs(w).max(), err_msg=str(path))
    assert float(runner.optimizer.count) == 1


def test_checkpoint_goes_both_ways(jax_runner, env, tmp_path):
    """The port saves, the JAX runner loads and predicts as the port does;
    the JAX runner saves, the port loads and predicts as JAX does."""
    r = rng(7)
    depth = r.random((B, 8, 16)).astype(np.float32)
    proprio = r.standard_normal((B, 9)).astype(np.float32)
    runner = TerrainEstimatorRunner(env, num_steps_per_env=T, seed=5)
    path = str(tmp_path / "port.pkl")
    runner.save(path)
    jr = JTerrainEstimatorRunner(jax_runner.env, num_steps_per_env=T, seed=1)
    jr.load(path)
    want = np.asarray(jr.get_estimator()(jnp.asarray(depth), jnp.asarray(proprio), jr.carry0)[0])
    got = to_np(runner.get_estimator()(torch.as_tensor(depth), torch.as_tensor(proprio),
                                       runner.carry0)[0])
    np.testing.assert_allclose(got, want, atol=1e-5)

    path = str(tmp_path / "jax.pkl")
    jax_runner.save(path)
    fresh = TerrainEstimatorRunner(env, num_steps_per_env=T, seed=9)
    fresh.load(path)
    want = np.asarray(jax_runner.get_estimator()(jnp.asarray(depth), jnp.asarray(proprio),
                                                 jax_runner.carry0)[0])
    got = to_np(fresh.get_estimator()(torch.as_tensor(depth), torch.as_tensor(proprio),
                                      fresh.carry0)[0])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_predictions_to_points_match_jax(jax_runner, env):
    r = rng(8)
    dist = (5.0 * r.random((B, 8))).astype(np.float32)
    pos = r.standard_normal((B, 3)).astype(np.float32)
    quat = r.standard_normal((B, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    want = np.asarray(jax_runner.predictions_to_points(jnp.asarray(dist), jnp.asarray(pos),
                                                       jnp.asarray(quat)))
    runner = TerrainEstimatorRunner(env, num_steps_per_env=T)
    got = to_np(runner.predictions_to_points(torch.as_tensor(dist), torch.as_tensor(pos),
                                             torch.as_tensor(quat)))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("encoder", ["stack", "hist_mlp"])
def test_buffered_encoders_learn_and_play(env, encoder):
    """The frame buffer encoders: the network reads [B, T, H, W]; a learn
    call and the play loop give finite numbers."""
    env.cfg.depth.encoder, env.cfg.depth.buffer_len = encoder, 3
    try:
        runner = TerrainEstimatorRunner(env, num_steps_per_env=2)
    finally:
        env.cfg.depth.encoder, env.cfg.depth.buffer_len = "cnn", 2
    assert runner.buffered and tuple(runner.depth_buf0.shape) == (B, 3, 8, 16)
    assert np.isfinite(runner.learn(2, log_interval=100)["loss"])
    stats = runner.play(num_steps=2, log_interval=100)
    assert set(stats) == {"mse", "mae", "mse_last", "mae_last"}
    assert np.isfinite(stats["mse"]) and stats["mse"] >= 0


def test_runner_refuses_an_env_without_rays():
    cfg = anymal_c_flat_cfg()
    cfg.env.num_envs = 2
    with pytest.raises(ValueError):
        TerrainEstimatorRunner(LeggedRobot(cfg, device="cpu"))


def test_estimator_scripts_on_cpu(tmp_path, monkeypatch):
    """terrain_est_train and terrain_est_play through the registry (4 envs,
    2 iterations, written under ./logs), then the closed loop with the
    committed JAX estimator and with --train 2: one JSON with the JAX
    artifact's numbers beside the port's."""
    from extended_legged_gym_tpu_torch.scripts import (estimator_closed_loop, terrain_est_play,
                                                       terrain_est_train)
    from extended_legged_gym_tpu_torch.utils.task_registry import get_args

    monkeypatch.chdir(tmp_path)
    argv = ["--task", "anymal_c_flat", "--num_envs", "4", "--max_iterations", "2",
            "--device", "cpu"]
    last = terrain_est_train.train(get_args(argv=argv))
    ckpt = tmp_path / "logs/terrain_estimator/anymal_c_flat/estimator_final.pkl"
    assert np.isfinite(last["loss"]) and ckpt.exists()
    assert sorted(read_checkpoint(str(ckpt))["params"]["params"]) == ["DepthOnlyFCBackbone_0",
                                                                      "GRUCell_0", "MLP_0"]
    stats = terrain_est_play.play(get_args(argv=argv))
    assert np.isfinite(stats["mse"])

    common = ["--envs", "4", "--steps", "3", "--warmup", "2", "--device", "cpu",
              "--policy", os.path.join(ROOT, estimator_closed_loop.RAY_CKPT),
              "--reference", os.path.join(ROOT, "ESTIMATOR_CL_r5.json")]
    out = estimator_closed_loop.main(common + ["--estimator", os.path.join(
        ROOT, estimator_closed_loop.JAX_ESTIMATOR)])
    assert out["reference"]["prediction_rmse_m"] == 1.2339 and out["card"] == "cpu"
    for k in ("prediction_rmse_m", "prediction_mae_m", "prediction_rmse_m_near3m",
              "tracking_true_rays", "tracking_estimated_rays"):
        assert np.isfinite(out[k]), k
    out = estimator_closed_loop.main(common + ["--train", "2", "--out", "cl.json"])
    assert out["training"]["iterations"] == 2 and len(out["training"]["curve"]) == 2
    assert (tmp_path / estimator_closed_loop.PORT_ESTIMATOR).exists()
    with open("cl.json") as f:
        assert json.load(f)["estimator"] == estimator_closed_loop.PORT_ESTIMATOR


def test_near_3m_rmse_is_the_jax_script_s():
    """The closed loop's near-3 m error is the JAX script's
    (``estimator_closed_loop.py:128-131``): each step's MSE over its rays
    with a true hit within 3 m, averaged over steps before the root; not the
    RMSE pooled over all near rays, which weighs steps by their near rays."""
    from extended_legged_gym_tpu_torch.scripts.estimator_closed_loop import near_mse

    r = rng(9)
    gt = (6.0 * r.random((5, 8, 32))).astype(np.float32)
    gt[0] = 5.0                                              # a step without near rays
    err = r.standard_normal((5, 8, 32)).astype(np.float32)
    jax_steps = [float((jnp.square(e) * (g < 3.0)).sum() / jnp.maximum((g < 3.0).sum(), 1))
                 for e, g in zip(jnp.asarray(err), jnp.asarray(gt))]
    got = [float(near_mse(torch.as_tensor(e), torch.as_tensor(g))) for e, g in zip(err, gt)]
    np.testing.assert_allclose(got, jax_steps, rtol=1e-6)
    assert got[0] == 0.0
    pooled = np.sqrt((err[gt < 3.0] ** 2).mean())
    assert abs(np.sqrt(np.mean(got)) - pooled) > 1e-3
