"""The port's rsl_rl ``.pt`` bridge (rl/torch_compat.py) against the JAX
package's, and the three entries that read a reference ``.pt`` through it:
``OnPolicyRunner.warmstart_from_reference``, the ``.pt`` MPC warm start
(``setup_rl_warmstart``) and the ``.pt`` teacher of
``scripts/evidence_artifacts``.

The repository holds no ``.pt``: each test writes a synthetic rsl_rl
checkpoint (``{"model_state_dict": actor.<i>, critic.<i>, std; "iter"}``,
the [128, 64, 32] ELU ActorCritic of the flat ANYmal-C task, weights from a
numpy seed) with ``torch.save``.  Actions within 1e-5; weights exactly,
``log_std`` (a log each package takes) within 1e-7."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_legged_gym_tpu.envs.legged_robot import LeggedRobot as JLeggedRobot
from extended_legged_gym_tpu.rl import torch_compat as jcompat
from extended_legged_gym_tpu.rl.runner import OnPolicyRunner as JOnPolicyRunner
from extended_legged_gym_tpu.robots.anymal_c import anymal_c_flat_cfg as janymal_c_flat_cfg
from extended_legged_gym_tpu.robots.anymal_c import anymal_c_ppo_cfg as janymal_c_ppo_cfg
from extended_legged_gym_tpu.robots.anymal_c_traj import AnymalCTrajGradSampling as JTraj
from extended_legged_gym_tpu.robots.anymal_c_traj import anymal_c_traj_sampling_cfg as jtraj_cfg
from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
from extended_legged_gym_tpu_torch.models.networks import ActorCritic, params_to_jax
from extended_legged_gym_tpu_torch.rl import torch_compat
from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_flat_cfg, anymal_c_ppo_cfg
from extended_legged_gym_tpu_torch.robots.anymal_c_traj import (AnymalCTrajGradSampling,
                                                               anymal_c_traj_sampling_cfg)
from extended_legged_gym_tpu_torch.scripts import evidence_artifacts

HIDDEN = (128, 64, 32)
# the engine's ANYmal-C joint order (URDF traversal); Isaac Gym's is sorted
JOINTS = ("LF_HAA", "LF_HFE", "LF_KFE", "LH_HAA", "LH_HFE", "LH_KFE",
          "RF_HAA", "RF_HFE", "RF_KFE", "RH_HAA", "RH_HFE", "RH_KFE")
SHUFFLED = ("RH_HAA", "RH_HFE", "RH_KFE", "LH_HAA", "LH_HFE", "LH_KFE",
            "RF_HAA", "RF_HFE", "RF_KFE", "LF_HAA", "LF_HFE", "LF_KFE")


def write_pt(path, seed=0, num_obs=48, num_actions=12):
    """A synthetic rsl_rl checkpoint of the flat task's ActorCritic."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, out in (("actor", num_actions), ("critic", 1)):
        dims = [num_obs, *HIDDEN, out]
        for k in range(len(dims) - 1):
            w = rng.standard_normal((dims[k + 1], dims[k])) / np.sqrt(dims[k])
            sd[f"{name}.{2 * k}.weight"] = torch.as_tensor(w.astype(np.float32))
            sd[f"{name}.{2 * k}.bias"] = torch.as_tensor(
                0.1 * rng.standard_normal(dims[k + 1]).astype(np.float32))
    sd["std"] = torch.as_tensor(rng.uniform(0.3, 1.0, num_actions).astype(np.float32))
    torch.save({"model_state_dict": sd, "optimizer_state_dict": {}, "iter": 200, "infos": None},
               path)
    return str(path)


@pytest.fixture(scope="module")
def pt(tmp_path_factory):
    return write_pt(tmp_path_factory.mktemp("ckpt") / "plane_walk_200.pt")


def _obs(n=6, seed=1):
    return np.random.default_rng(seed).standard_normal((n, 48)).astype(np.float32)


def test_checkpoint_reads_as_jax_does(pt):
    sd, it = torch_compat.load_rsl_rl_checkpoint(pt)
    jsd, jit_ = jcompat.load_rsl_rl_checkpoint(pt)
    assert it == jit_ == 200 and sd.keys() == jsd.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], jsd[k])
    with pytest.raises(FileNotFoundError, match="missing.pt"):
        torch_compat.load_rsl_rl_checkpoint(os.path.join(os.path.dirname(pt), "missing.pt"))


@pytest.mark.parametrize("names", [None, JOINTS, SHUFFLED], ids=["raw", "bridged", "shuffled"])
def test_reference_policy_matches_jax(pt, names):
    """load_reference_policy's actions, without the DOF bridge and with it
    (the sorted order and a shuffled one)."""
    obs = _obs()
    _, state, policy = torch_compat.load_reference_policy(pt, 48, 12, our_joint_names=names,
                                                          device="cpu")
    _, jparams, jpolicy = jcompat.load_reference_policy(pt, 48, 12, our_joint_names=names)
    np.testing.assert_allclose(policy(torch.as_tensor(obs)).numpy(),
                               np.asarray(jpolicy(jnp.asarray(obs))), rtol=1e-5, atol=1e-5)
    net = ActorCritic(48, 12, HIDDEN, HIDDEN)
    net.load_state_dict(state)
    np.testing.assert_allclose(params_to_jax(net)["params"]["log_std"],
                               np.asarray(jparams["params"]["log_std"]), rtol=0, atol=1e-7)
    perm, inv = torch_compat.dof_permutation(names or JOINTS)
    jperm, jinv = jcompat.dof_permutation(names or JOINTS)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(inv, jinv)


@pytest.mark.parametrize("names", [JOINTS, SHUFFLED], ids=["sorted", "shuffled"])
def test_weight_space_permutation_equals_the_wrapper(pt, names):
    """tests/test_warmstart.py::test_weight_space_dof_permutation_matches_wrapper
    in the port, and the permuted weights equal JAX's."""
    net, raw, wrapped = torch_compat.load_reference_policy(pt, 48, 12, our_joint_names=names,
                                                           device="cpu")
    native = torch_compat.permute_params_to_our_dof_order(raw, names)
    nnet = ActorCritic(48, 12, HIDDEN, HIDDEN)
    nnet.load_state_dict(native)
    obs = torch.as_tensor(_obs(5, 3))
    np.testing.assert_allclose(nnet.act_inference(obs).detach().numpy(),
                               wrapped(obs).numpy(), rtol=1e-5, atol=1e-6)
    perm, _ = torch_compat.dof_permutation(names)
    P = torch.as_tensor(perm)
    obs_ref = torch.cat([obs[:, :12], obs[:, 12:24][:, P], obs[:, 24:36][:, P],
                         obs[:, 36:48][:, P]], -1)
    np.testing.assert_allclose(nnet.evaluate(obs).detach().numpy(),
                               net.evaluate(obs_ref).detach().numpy(), rtol=1e-5, atol=1e-6)
    _, jraw, _ = jcompat.load_reference_policy(pt, 48, 12)
    jnative = jcompat.permute_params_to_our_dof_order(jraw, names)["params"]
    mine = params_to_jax(nnet)["params"]
    for part in ("actor", "critic"):
        for layer, leaves in jnative[part].items():
            for leaf, v in leaves.items():
                np.testing.assert_array_equal(mine[part][layer][leaf], np.asarray(v))
    # (torch.log and jnp.log may part by an ulp)
    np.testing.assert_allclose(mine["log_std"], np.asarray(jnative["log_std"]), rtol=0, atol=1e-7)


def _flat(cfg, n=4):
    cfg.env.num_envs = n
    cfg.noise.add_noise = False
    return cfg


def test_runner_warmstart_matches_jax(pt):
    """warmstart_from_reference: the same (DOF-bridged) parameters as the
    JAX runner's, and a fresh Adam state."""
    env = LeggedRobot(_flat(anymal_c_flat_cfg()), device="cpu")
    runner = OnPolicyRunner(env, anymal_c_ppo_cfg())
    runner.optimizer.count += 3.0                    # as if it had stepped
    runner.warmstart_from_reference(pt)
    jc = _flat(janymal_c_flat_cfg())
    jc.sim.solver = "aba"
    jrunner = JOnPolicyRunner(JLeggedRobot(jc), janymal_c_ppo_cfg())
    jrunner.warmstart_from_reference(pt)
    mine = params_to_jax(runner.network)["params"]
    want = jax.device_get(jrunner.state.ppo.params)["params"]
    for part in ("actor", "critic"):
        for layer, leaves in want[part].items():
            for leaf, v in leaves.items():
                np.testing.assert_array_equal(mine[part][layer][leaf], np.asarray(v))
    np.testing.assert_allclose(mine["log_std"], np.asarray(want["log_std"]), atol=1e-7)
    assert float(runner.optimizer.count) == 0.0 and float(runner.optimizer.mu.abs().max()) == 0.0
    m = runner.train_iteration()
    assert np.isfinite(float(m["loss"]))


def test_mpc_warmstart_from_pt_matches_jax(pt):
    """setup_rl_warmstart on a .pt: the bridged policy, as JAX's."""
    cfg = anymal_c_traj_sampling_cfg(2)
    env = AnymalCTrajGradSampling(cfg, device="cpu")
    policy = env.setup_rl_warmstart(pt)
    jc = jtraj_cfg(2)
    jc.sim.solver = "aba"
    jenv = JTraj(jc)
    jpolicy = jenv.setup_rl_warmstart(pt)
    obs = _obs(2, 4)
    np.testing.assert_allclose(policy(torch.as_tensor(obs)).numpy(),
                               np.asarray(jpolicy(jnp.asarray(obs))), rtol=1e-5, atol=1e-5)
    nodes = env.init_trajectories_from_rl(env.reset_all(seed=0))
    assert nodes.shape[0] == 2 and bool(torch.isfinite(nodes).all())


def test_distill_teacher_from_pt(pt, tmp_path):
    """The evidence script's .pt teacher is the bridged reference policy;
    an absent .pt fails naming it."""
    runner = evidence_artifacts.distill_runner(pt, envs=2, iters=1, device="cpu")
    obs = torch.as_tensor(_obs(2, 5))
    _, _, want = torch_compat.load_reference_policy(
        pt, 48, 12, our_joint_names=runner.env.model.joint_names, device="cpu")
    np.testing.assert_array_equal(runner.teacher_policy(obs).numpy(), want(obs).numpy())
    jenv = JLeggedRobot(_flat(janymal_c_flat_cfg(), 2))
    _, _, jteacher = jcompat.load_reference_policy(pt, 48, 12,
                                                   our_joint_names=jenv.model.joint_names)
    np.testing.assert_allclose(want(obs).numpy(), np.asarray(jteacher(jnp.asarray(obs.numpy()))),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(FileNotFoundError, match="absent.pt"):
        evidence_artifacts.distill_runner(str(tmp_path / "absent.pt"), envs=2, iters=1,
                                          device="cpu")
