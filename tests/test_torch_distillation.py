"""Distillation against the JAX package: the student-teacher networks, the
teacher loaded from the committed PPO checkpoint, ``Distillation``'s update
(gradient_length chunks, epochs replayed from the window-start carry, the
global-norm clip, Adam, a cosine schedule counted in optimizer steps) and one
DistillationRunner iteration (also with a teacher that reads the privileged
observation), plus the evidence script on the CPU.

Tolerances: forward passes 1e-5 absolute; the update on a given window (the
same inputs) the parameters 1e-4 of each tensor's largest magnitude, as
``tests/test_torch_ppo.py`` holds its update, the loss 1e-5 relative and the
schedule's learning rate 1e-6 relative; the runner iteration (4 env steps
whose physics agrees to float32 rounding, then 4 optimizer steps) the loss
1e-4 relative and the parameters 2e-3 of each tensor's largest magnitude, as
``tests/test_torch_runner.py`` holds a PPO iteration."""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from extended_legged_gym_tpu.envs.legged_robot import LeggedRobot as JLeggedRobot
from extended_legged_gym_tpu.models.networks import ActorCritic as JActorCritic
from extended_legged_gym_tpu.models.student_teacher import (StudentTeacher as JStudentTeacher,
                                                            StudentTeacherRecurrent as JSTRecurrent,
                                                            load_teacher_from_actor_critic as
                                                            jload_teacher)
from extended_legged_gym_tpu.rl.distillation import Distillation as JDistillation
from extended_legged_gym_tpu.rl.distillation_runner import DistillationRunner as JRunner
from extended_legged_gym_tpu.robots.anymal_c import anymal_c_flat_cfg as janymal_c_flat_cfg
from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
from extended_legged_gym_tpu_torch.models.networks import (ActorCritic, flax_tree,
                                                           inference_policy, load_flax_tree,
                                                           load_jax_checkpoint)
from extended_legged_gym_tpu_torch.models.student_teacher import (StudentTeacher,
                                                                  StudentTeacherRecurrent,
                                                                  load_teacher_from_actor_critic)
from extended_legged_gym_tpu_torch.rl.distillation import Distillation, cosine_decay_schedule
from extended_legged_gym_tpu_torch.rl.distillation_runner import DistillationRunner
from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_flat_cfg
from torch_parity import to_torch_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEACHER = os.path.join(ROOT, "logs/flat_anymal_c/Aug21_12-38-39_r5_ft4/model_final.pkl")
HID = (32, 16)
O, A, B = 10, 4, 6


def to_np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_close_trees(got, want, rel, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            assert_close_trees(got[k], want[k], rel, f"{path}/{k}")
        else:
            w = np.asarray(want[k])
            np.testing.assert_allclose(got[k], w, atol=rel * np.abs(w).max(), err_msg=f"{path}/{k}")


def schedule_count(opt_state) -> int:
    """The optimizer steps an optax chain's schedule has counted."""
    found = [s.count for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByScheduleState))
        if isinstance(s, optax.ScaleByScheduleState)]
    return int(found[0])


def nets(kind):
    if kind == "mlp":
        jnet = JStudentTeacher(num_actions=A, student_hidden_dims=HID, teacher_hidden_dims=HID)
        return jnet, StudentTeacher(O, O, A, HID, HID)
    jnet = JSTRecurrent(num_actions=A, student_hidden_dims=HID, teacher_hidden_dims=HID,
                        rnn_hidden_size=9, rnn_type=kind)
    return jnet, StudentTeacherRecurrent(O, O, A, HID, HID, rnn_hidden_size=9, rnn_type=kind)


@pytest.mark.parametrize("kind", ["mlp", "lstm", "gru", "mlp_update"])
def test_update_matches_jax(kind):
    """Three windows of T = 7 (chunks of 3, 3 and 1 at gradient_length 3),
    2 epochs each: 18 optimizer steps under a cosine schedule over 20 steps
    (alpha 0.1), targets large enough that the global-norm clip acts; the
    recurrent windows have dones and a non-zero window-start carry.
    ``mlp_update`` labels the window with the network's own teacher
    (``Distillation.update``)."""
    rnn = kind if kind in ("lstm", "gru") else None
    jnet, net = nets(rnn or "mlp")
    jsched = optax.cosine_decay_schedule(1e-3, 20, alpha=0.1)
    jalg = JDistillation(jnet, learning_rate=jsched, num_learning_epochs=2, gradient_length=3)
    state = jalg.init(jax.random.PRNGKey(0), O, O, batch_size=B)
    load_flax_tree(net, jax.device_get(state.params)["params"])
    alg = Distillation(net, learning_rate=cosine_decay_schedule(1e-3, 20, alpha=0.1),
                       num_learning_epochs=2, gradient_length=3)
    teacher0 = flax_tree(net.teacher)
    r = np.random.default_rng(1)
    for _ in range(3):
        s_obs = r.standard_normal((7, B, O)).astype(np.float32)
        t_act = (5.0 * r.standard_normal((7, B, A))).astype(np.float32)
        t_obs = r.standard_normal((7, B, O)).astype(np.float32)
        dones = (r.random((7, B)) < 0.2).astype(np.float32)
        carry = None
        if rnn:
            shape = (B, 9)
            carry = tuple(r.standard_normal(shape).astype(np.float32) for _ in range(2)) \
                if rnn == "lstm" else r.standard_normal(shape).astype(np.float32)
        jcarry = jax.tree_util.tree_map(jnp.asarray, carry)
        tcarry = (None if carry is None else tuple(map(torch.as_tensor, carry))
                  if rnn == "lstm" else torch.as_tensor(carry))
        if kind == "mlp_update":
            state, jm = jalg.update(state, jnp.asarray(s_obs), jnp.asarray(t_obs),
                                    jnp.asarray(dones))
            m = alg.update(torch.as_tensor(s_obs), torch.as_tensor(t_obs),
                           torch.as_tensor(dones))
        else:
            state, jm = jalg.update_on_actions(state, jnp.asarray(s_obs), jnp.asarray(t_act),
                                               jnp.asarray(dones), jcarry)
            m = alg.update_on_actions(torch.as_tensor(s_obs), torch.as_tensor(t_act),
                                      torch.as_tensor(dones), tcarry)
        np.testing.assert_allclose(float(m["behavior_loss"]), float(jm["behavior_loss"]),
                                   rtol=1e-5)
        assert_close_trees(flax_tree(net), jax.device_get(state.params)["params"], 1e-4)
    assert alg.num_updates == schedule_count(state.opt_state) == 18
    np.testing.assert_allclose(alg.learning_rate, float(jsched(18)), rtol=1e-6)
    # the teacher is frozen
    assert_close_trees(flax_tree(net.teacher), teacher0, 0.0)


def test_cosine_schedule_matches_optax():
    jsched = optax.cosine_decay_schedule(1e-3, 3000, alpha=0.1)
    sched = cosine_decay_schedule(1e-3, 3000, alpha=0.1)
    for count in (0, 1, 4, 1499, 2999, 3000, 6000):
        np.testing.assert_allclose(sched(count), float(jsched(count)), rtol=1e-6)


def test_teacher_from_the_committed_checkpoint():
    """``load_teacher_from_actor_critic`` puts the flat PPO checkpoint's actor
    into the teacher slot as the JAX function does: the teacher acts as the
    JAX ActorCritic's actor."""
    with open(TEACHER, "rb") as f:
        ac_params = pickle.load(f)["params"]
    jnet = JStudentTeacher(num_actions=12, teacher_hidden_dims=(128, 64, 32))
    jparams = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 48)), jnp.zeros((1, 48)))
    jparams = jload_teacher(jparams, ac_params)
    net = load_teacher_from_actor_critic(StudentTeacher(48, 48, 12,
                                                        teacher_hidden_dims=(128, 64, 32)),
                                         ac_params)
    obs = np.random.default_rng(2).standard_normal((16, 48)).astype(np.float32)
    want = np.asarray(jnet.apply(jparams, jnp.asarray(obs), method=jnet.evaluate_teacher))
    acted = JActorCritic(num_actions=12, actor_hidden_dims=(128, 64, 32),
                         critic_hidden_dims=(128, 64, 32)).apply(
        ac_params, jnp.asarray(obs), method=JActorCritic.act_inference)
    got = to_np(net.evaluate_teacher(torch.as_tensor(obs)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(acted), atol=1e-5)


# ------------------------------------------------------------------ the runner
def quiet(cfg):
    cfg.env.num_envs = 4
    cfg.noise.add_noise = False
    cfg.domain_rand.randomize_friction = cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.push_robots = False
    return cfg


@pytest.fixture(scope="module")
def teachers():
    """The committed flat PPO checkpoint's policy in each package."""
    with open(TEACHER, "rb") as f:
        params = pickle.load(f)["params"]
    jnet = JActorCritic(num_actions=12, actor_hidden_dims=(128, 64, 32),
                        critic_hidden_dims=(128, 64, 32))
    sd, norm = load_jax_checkpoint(TEACHER)
    net = ActorCritic(48, 12, (128, 64, 32), (128, 64, 32))
    net.load_state_dict(sd)
    return (lambda obs: jnet.apply(params, obs, method=jnet.act_inference),
            inference_policy(net, norm))


@pytest.mark.parametrize("rnn_type", [None, "lstm"], ids=["mlp", "lstm"])
def test_runner_iteration_matches_jax(teachers, rnn_type):
    """One iteration at 4 envs, 4 steps, 2 epochs of chunks of 3 and 1, from
    the JAX runner's env state, parameters and carry, the exploration noise
    of the JAX iteration injected."""
    jteacher, teacher = teachers
    jc = quiet(janymal_c_flat_cfg())
    jc.sim.solver = "aba"
    kw = dict(student_hidden_dims=HID, num_steps_per_env=4, num_learning_epochs=2,
              gradient_length=3, recurrent=rnn_type is not None, rnn_type=rnn_type or "lstm",
              rnn_hidden_size=9)
    jr = JRunner(JLeggedRobot(jc), jteacher, **kw)
    key = jax.random.PRNGKey(5)
    a1, es1, carry1, jm = jr._iteration(jr.alg_state, jr.env_state, jr.carry, key)
    noise = np.stack([np.asarray(jax.random.normal(k, (4, 12)))
                      for k in jax.random.split(key, 4)])

    runner = DistillationRunner(LeggedRobot(quiet(anymal_c_flat_cfg()), device="cpu"), teacher,
                                **kw)
    runner.env_state = to_torch_state(jr.env_state)
    load_flax_tree(runner.network, jax.device_get(jr.alg_state.params)["params"])
    m = runner.train_iteration(exploration_noise=torch.as_tensor(noise))
    np.testing.assert_allclose(float(m["behavior_loss"]), float(jm["behavior_loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m["mean_reward"]), float(jm["mean_reward"]), atol=1e-6)
    assert_close_trees(flax_tree(runner.network), jax.device_get(a1.params)["params"], 2e-3)
    np.testing.assert_allclose(to_np(runner.env_state.phys.base_pos),
                               np.asarray(es1.phys.base_pos), atol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(carry1),
                    jax.tree_util.tree_leaves(runner.carry) if rnn_type else []):
        np.testing.assert_allclose(to_np(b), np.asarray(a), atol=1e-4)
    assert runner.alg.num_updates == 4 and runner.iteration == 1


def test_runner_teacher_reads_the_privileged_observation():
    """With ``env.num_privileged_obs`` (56: the observation padded with
    zeros) the teacher labels the privileged observation in both packages:
    one MLP iteration as above with a linear teacher of 56 inputs."""
    from torch_family import to_port

    w = np.random.default_rng(4).standard_normal((56, 12)).astype(np.float32) * 0.1
    seen = []
    jteacher = lambda obs: obs @ jnp.asarray(w)

    def teacher(obs):
        seen.append(tuple(obs.shape))
        return obs @ torch.as_tensor(w)

    jc, c = quiet(janymal_c_flat_cfg()), quiet(anymal_c_flat_cfg())
    jc.sim.solver = "aba"
    jc.env.num_privileged_obs = c.env.num_privileged_obs = 56
    kw = dict(student_hidden_dims=HID, num_steps_per_env=4, num_learning_epochs=2,
              gradient_length=3)
    jr = JRunner(JLeggedRobot(jc), jteacher, **kw)
    key = jax.random.PRNGKey(6)
    a1, es1, _, jm = jr._iteration(jr.alg_state, jr.env_state, jr.carry, key)
    noise = np.stack([np.asarray(jax.random.normal(k, (4, 12)))
                      for k in jax.random.split(key, 4)])
    runner = DistillationRunner(LeggedRobot(c, device="cpu"), teacher, **kw)
    runner.env_state = to_port(jr.env_state)
    load_flax_tree(runner.network, jax.device_get(jr.alg_state.params)["params"])
    m = runner.train_iteration(exploration_noise=torch.as_tensor(noise))
    assert seen == [(4, 56)] * 4
    np.testing.assert_allclose(float(m["behavior_loss"]), float(jm["behavior_loss"]), rtol=1e-4)
    assert_close_trees(flax_tree(runner.network), jax.device_get(a1.params)["params"], 2e-3)


def test_student_policy_and_learn_on_cpu(teachers):
    """``learn`` runs on, the student policy acts, and the recurrent policy
    returns its carry."""
    _, teacher = teachers
    env = LeggedRobot(quiet(anymal_c_flat_cfg()), device="cpu")
    runner = DistillationRunner(env, teacher, student_hidden_dims=HID, num_steps_per_env=3)
    last = runner.learn(2, log_interval=100)
    assert np.isfinite(last["behavior_loss"]) and runner.alg.num_updates == 2 * 2 * 1
    assert tuple(runner.get_student_policy()(env.reset_all().obs).shape) == (4, 12)
    rec = DistillationRunner(env, teacher, student_hidden_dims=HID, num_steps_per_env=3,
                             recurrent=True, rnn_type="gru", rnn_hidden_size=8)
    actions, carry = rec.get_student_policy()(env.reset_all().obs, rec.carry)
    assert tuple(actions.shape) == (4, 12) and tuple(carry.shape) == (4, 8)


def test_evidence_script_on_cpu(tmp_path):
    """``estimator`` at 4 envs for 2 iterations writes the curve with the
    JAX artifact beside it; ``distill`` without ``--teacher-ckpt`` takes the
    reference's .pt teacher, and fails naming it where the file is absent."""
    from extended_legged_gym_tpu_torch.scripts import evidence_artifacts

    out = evidence_artifacts.main(["estimator", "--iters", "2", "--envs", "4", "--device", "cpu",
                                   "--reference", os.path.join(ROOT, "ESTIMATOR_r4.json"),
                                   "--out", str(tmp_path / "est.json")])
    assert [c[0] for c in out["curve"]] == [1, 2] and np.isfinite(out["loss_final"])
    assert out["reference"]["loss_first"] == 0.347752 and out["card"] == "cpu"
    with pytest.raises(FileNotFoundError, match="plane_walk_200.pt"):
        evidence_artifacts.main(["distill", "--iters", "1", "--envs", "2", "--device", "cpu"])
