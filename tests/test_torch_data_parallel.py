"""Data-parallel PPO in the port against the JAX package, in 2 processes over
gloo on the CPU.

The JAX side runs here: ``ppo_update`` / ``ppo_update_recurrent`` with
``axis_name="dp"`` under ``jax.shard_map`` over 2 of the 8 virtual CPU
devices (tests/conftest.py), on seeded numpy batches of T = 8 steps and 16
envs (8 per shard), and one ``_train_iteration`` of the JAX runner
(anymal_c_flat, ABA solver, 16 envs, [32, 16], empirical normalization).
The key is replicated, so every shard draws the same local permutations;
the port's ranks get them injected.  The workers (tests/torch_dp_worker.py)
import only torch and the port; they take their inputs and hand back their
results as ``torch.save`` files, and run while the JAX side compiles.

* The MLP update, with and without symmetry, and the recurrent update on
  each rank's shard match the JAX shards (parameters 2e-3 of each tensor's
  largest magnitude, each rank's losses 1e-3 relative to its shard's, the
  learning rate 1e-6 relative: tests/test_torch_runner.py's tolerances),
  and the ranks agree bit for bit.
* A one-process mesh with the group up (the collectives run) is bitwise
  equal to ``mesh=None``: the updates, ``RunningNorm.update``, and a runner
  iteration with RND and the normalizer.
* Two ranks that each hold the JAX runner's whole 16-env state reproduce its
  iteration (the same tolerances; the normalizer's mean and variance 1e-4,
  its count doubled).  Two ranks on distinct 8-env shards keep parameters,
  normalizers, learning rate, reward stage and RND state bitwise equal over
  2 iterations; ``mean_reward`` is the mean over both shards' episodes, and
  the stage advances on a mean that only the two shards together pass.
* A loss that is non-finite on one rank only (its gradients finite) skips
  the step on every rank: a difference on purpose from JAX, which ANDs the
  local loss (ROADMAP.md).
* The dry run's toy passes: the sample-sharded ``optimize`` equals the
  one-process one with the same noise within 1e-5.
* ``scripts/train.py`` under torchrun on 2 CPU processes: only rank 0
  writes its run directory, and the JAX runner reads its checkpoint.
"""
import glob
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from extended_legged_gym_tpu.envs.legged_robot import LeggedRobot as JLeggedRobot
from extended_legged_gym_tpu.models.networks import ActorCritic as JActorCritic
from extended_legged_gym_tpu.models.networks import ActorCriticRecurrent as JACR
from extended_legged_gym_tpu.models.networks import gaussian_log_prob as jlog_prob
from extended_legged_gym_tpu.models.networks import rnn_carry as jrnn_carry
from extended_legged_gym_tpu.rl import ppo as jppo
from extended_legged_gym_tpu.rl.runner import OnPolicyRunner as JRunner
from extended_legged_gym_tpu.robots.anymal_c import anymal_c_flat_cfg as janymal_c_flat_cfg
from extended_legged_gym_tpu.robots.anymal_c import anymal_c_ppo_cfg as janymal_c_ppo_cfg
from extended_legged_gym_tpu_torch.models.networks import params_from_jax
from torch_parity import to_torch_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dp_worker.py")
TIMEOUT_S = 300
T, B, OBS, A, HID, H = 8, 16, 10, 4, (32, 16), 16
N = 2                                    # ranks, and JAX shards
FIELDS = ("obs", "critic_obs", "actions", "rewards", "dones", "values", "log_probs", "mu",
          "sigma")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start(args, cwd=ROOT):
    return subprocess.Popen(args, cwd=cwd, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _t(x):
    return torch.as_tensor(np.array(x))


def _jax_mesh():
    return Mesh(np.array(jax.devices()[:N]), ("dp",))


def _gae(batch, rng):
    return jppo.compute_gae(batch.rewards, batch.dones, batch.values,
                            jnp.asarray(rng.standard_normal(B).astype(np.float32)), 0.99, 0.95)


def mlp_case(symmetric: bool):
    """(worker inputs, the JAX shard_map update) of the MLP case."""
    rng = np.random.default_rng(4 if symmetric else 0)
    jnet = JActorCritic(num_actions=A, actor_hidden_dims=HID, critic_hidden_dims=HID)
    params = jnet.init(jax.random.PRNGKey(1), jnp.zeros((1, OBS)), jnp.zeros((1, OBS)))
    obs = rng.standard_normal((T, B, OBS)).astype(np.float32)
    mean, std, value = jnet.apply(params, jnp.asarray(obs))
    actions = mean + std * jnp.asarray(rng.standard_normal((T, B, A)).astype(np.float32))
    batch = jppo.Transition(obs=jnp.asarray(obs), critic_obs=jnp.asarray(obs), actions=actions,
                            rewards=jnp.asarray(rng.standard_normal((T, B)).astype(np.float32)),
                            dones=jnp.asarray(rng.random((T, B)) < 0.1), values=value,
                            log_probs=jlog_prob(mean, std, actions), mu=mean,
                            sigma=jnp.broadcast_to(std, (T, A)))
    adv, ret = _gae(batch, rng)
    spec = None
    if symmetric:
        spec = ((rng.permutation(OBS), rng.choice([-1.0, 1.0], OBS).astype(np.float32)),
                (rng.permutation(A), rng.choice([-1.0, 1.0], A).astype(np.float32)), 0.5)
    key = jax.random.PRNGKey(11)
    cfg = jppo.PPOConfig(learning_rate=1e-3)
    perms = [_t(jax.random.permutation(k, T * B // N))
             for k in jax.random.split(key, cfg.num_learning_epochs)]
    inp = dict(recurrent=False, obs_dim=OBS, act_dim=A, hid=list(HID), lr=1e-3,
               params=jax.device_get(params), batch={k: _t(getattr(batch, k)) for k in FIELDS},
               adv=_t(adv), ret=_t(ret), perms=perms, symmetry=spec)

    def run():
        sym = None if spec is None else (jppo.make_mirror_fns(*spec[0]),
                                         jppo.make_mirror_fns(*spec[1]), spec[2])
        opt = jppo.make_optimizer(cfg)

        def f(params, batch, adv, ret, key):
            st = jppo.PPOState(params, opt.init(params), jnp.asarray(1e-3))
            st, m = jppo.ppo_update(jnet, cfg, st, batch, adv, ret, key, opt, axis_name="dp",
                                    symmetry=sym)
            return st.params, st.learning_rate, jax.tree.map(lambda x: x[None], m)

        return _shard_map(f, (P(), _batch_spec(), P(None, "dp"), P(None, "dp"), P()),
                          params, batch, adv, ret, key)

    return inp, run


def recurrent_case():
    rng = np.random.default_rng(5)
    jnet = JACR(num_actions=A, actor_hidden_dims=HID, critic_hidden_dims=HID,
                rnn_hidden_size=H, rnn_type="lstm")
    ca = jrnn_carry("lstm", H, (1,))
    params = jnet.init(jax.random.PRNGKey(3), jnp.zeros((1, OBS)), ca, ca, jnp.zeros((1, OBS)))
    obs = rng.standard_normal((T, B, OBS)).astype(np.float32)
    dones = rng.random((T, B)) < 0.15
    c0 = tuple(0.3 * rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    carries0 = (c0, tuple(0.5 * x for x in c0))
    ca, cc = jax.tree.map(jnp.asarray, carries0)
    rows = {k: [] for k in ("mu", "values", "actions", "log_probs")}
    for t in range(T):
        m, s, v, ca, cc = jnet.apply(params, jnp.asarray(obs[t]), ca, cc, jnp.asarray(obs[t]))
        act = m + s * jnp.asarray(rng.standard_normal((B, A)).astype(np.float32))
        for k, x in (("mu", m), ("values", v), ("actions", act),
                     ("log_probs", jlog_prob(m, s, act))):
            rows[k].append(x)
        keep = jnp.asarray(1.0 - dones[t])[:, None]
        ca, cc = jax.tree.map(lambda h: h * keep, (ca, cc))
    st = {k: jnp.stack(v) for k, v in rows.items()}
    batch = jppo.Transition(obs=jnp.asarray(obs), critic_obs=jnp.asarray(obs),
                            actions=st["actions"],
                            rewards=jnp.asarray(rng.standard_normal((T, B)).astype(np.float32)),
                            dones=jnp.asarray(dones), values=st["values"],
                            log_probs=st["log_probs"], mu=st["mu"],
                            sigma=jnp.broadcast_to(s, (T, A)))
    adv, ret = _gae(batch, rng)
    key = jax.random.PRNGKey(13)
    cfg = jppo.PPOConfig(learning_rate=1e-3)
    perms = [_t(jax.random.permutation(k, B // N))
             for k in jax.random.split(key, cfg.num_learning_epochs)]
    inp = dict(recurrent=True, obs_dim=OBS, act_dim=A, hid=list(HID), rnn_hidden=H, lr=1e-3,
               params=jax.device_get(params), batch={k: _t(getattr(batch, k)) for k in FIELDS},
               adv=_t(adv), ret=_t(ret), perms=perms,
               carries0=tuple(tuple(_t(h) for h in c) for c in carries0))

    def run():
        opt = jppo.make_optimizer(cfg)

        def f(params, batch, carries0, adv, ret, key):
            st = jppo.PPOState(params, opt.init(params), jnp.asarray(1e-3))
            st, m = jppo.ppo_update_recurrent(jnet, cfg, st, batch, carries0, adv, ret, key, opt,
                                              axis_name="dp")
            return st.params, st.learning_rate, jax.tree.map(lambda x: x[None], m)

        return _shard_map(f, (P(), _batch_spec(), P("dp"), P(None, "dp"), P(None, "dp"), P()),
                          params, batch, jax.tree.map(jnp.asarray, carries0), adv, ret, key)

    return inp, run


def _batch_spec():
    return jppo.Transition(**{k: (P() if k == "sigma" else P(None, "dp")) for k in FIELDS})


def _shard_map(f, in_specs, *args):
    """``f`` under shard_map on the 2-device mesh: (parameters and learning
    rate of shard 0, each shard's metrics)."""
    g = jax.jit(jax.shard_map(f, mesh=_jax_mesh(), in_specs=in_specs,
                              out_specs=(P(), P(), P("dp")), check_vma=False))
    params, lr, m = jax.device_get(g(*args))
    return dict(params=params, lr=float(lr), metrics={k: np.asarray(v) for k, v in m.items()})


def quiet(cfg):
    cfg.env.num_envs = B
    cfg.noise.add_noise = False
    cfg.domain_rand.randomize_friction = cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.push_robots = False
    cfg.sim.solver = "aba"
    return cfg


def small(tc):
    tc.seed = 3
    tc.runner.num_steps_per_env = T
    tc.runner.empirical_normalization = True
    tc.policy.actor_hidden_dims = tc.policy.critic_hidden_dims = list(HID)
    return tc


def runner_case():
    """(worker inputs, the JAX iteration) of the runner case: the JAX
    runner's state, parameters, action noise and permutations."""
    jr = JRunner(JLeggedRobot(quiet(janymal_c_flat_cfg())), small(janymal_c_ppo_cfg()))
    ts0 = jr.state
    _, k_collect, k_update = jax.random.split(ts0.key, 3)
    noise = np.stack([np.asarray(jax.random.normal(k, (B, 12)))
                      for k in jax.random.split(k_collect, T)])
    perms = [_t(jax.random.permutation(k, T * B))
             for k in jax.random.split(k_update, jr.ppo_cfg.num_learning_epochs)]
    inp = dict(env_state=to_torch_state(ts0.env_state),
               params=params_from_jax(jax.device_get(ts0.ppo.params)),
               noise=torch.as_tensor(noise), perms=perms)

    def run():
        ts1, jm = jax.device_get(jr._train_iter(ts0))
        return dict(params=ts1.ppo.params, metrics={k: float(v) for k, v in jm.items()},
                    norm=dict(mean=np.asarray(ts1.obs_norm.mean), var=np.asarray(ts1.obs_norm.var),
                              count=float(ts1.obs_norm.count)))

    return inp, run


TRAIN_ARGS = ["--task", "anymal_c_flat", "--num_envs", str(B), "--max_iterations", "2",
              "--device", "cpu", "--experiment_name", "dp", "--run_name", "t"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The JAX side, the 2-rank workers' and the world-size-1 worker's
    results, and the torchrun training's directory and output; the
    processes run while the JAX side compiles."""
    d = str(tmp_path_factory.mktemp("dp"))
    train_dir = tmp_path_factory.mktemp("train")
    train = _start([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(N),
                    "--master_port", str(_free_port()), "-m",
                    "extended_legged_gym_tpu_torch.scripts.train", *TRAIN_ARGS],
                   cwd=str(train_dir))
    cases = dict(mlp=mlp_case(False), mlp_sym=mlp_case(True), recurrent=recurrent_case())
    for name, (inp, _) in cases.items():
        torch.save(inp, os.path.join(d, f"ppo_{name}.pt"))
    rinp, rrun = runner_case()
    torch.save(rinp, os.path.join(d, "runner.pt"))
    port, port1 = _free_port(), _free_port()
    procs = [_start([sys.executable, WORKER, "pair", str(r), str(N), str(port), d])
             for r in range(N)]
    procs.append(_start([sys.executable, WORKER, "single", "0", "1", str(port1), d]))
    procs.append(train)
    try:
        want = {name: run() for name, (_, run) in cases.items()}
        want["runner"] = rrun()
    finally:
        outs = _finish(procs)
    pair = [torch.load(os.path.join(d, f"out_pair_{r}.pt"), weights_only=False) for r in range(N)]
    single = torch.load(os.path.join(d, "out_single_0.pt"), weights_only=False)
    return want, pair, single, (train_dir, outs[-1])


def _close_params(want, got):
    w = jax.tree_util.tree_leaves_with_path(want)
    g = jax.tree_util.tree_leaves(got)
    assert len(w) == len(g)
    for (path, wv), gv in zip(w, g):
        np.testing.assert_allclose(np.asarray(gv), wv, atol=2e-3 * np.abs(wv).max(),
                                   err_msg=str(path))


@pytest.mark.parametrize("case", ["mlp", "mlp_sym", "recurrent"])
def test_update_matches_jax_shard_map(results, case):
    want, pair = results[:2]
    w = want[case]
    ref = w["params"]["params"] if case == "recurrent" else w["params"]
    for rank, out in enumerate(pair):
        _close_params(ref, out[case]["params"])
        for k in ("loss", "value_loss", "surrogate_loss", "entropy", "kl"):
            np.testing.assert_allclose(out[case]["metrics"][k], w["metrics"][k][rank], rtol=1e-3,
                                       err_msg=f"{k} of rank {rank}")
        np.testing.assert_allclose(out[case]["lr"], w["lr"], rtol=1e-6)
        assert out[case]["metrics"]["nonfinite_skips"] == 0.0
    # the loss metrics stay per rank; what the ranks hold does not part
    assert pair[0][case]["metrics"]["loss"] != pair[1][case]["metrics"]["loss"]
    assert pair[0][case]["digest"] == pair[1][case]["digest"]


@pytest.mark.parametrize("what", ["mlp", "mlp_sym", "recurrent", "norm", "runner"])
def test_one_process_mesh_is_bitwise_mesh_none(results, what):
    a, b = results[2][what]
    assert a == b


def test_runner_on_duplicate_shards_matches_jax(results):
    want, pair = results[:2]
    w = want["runner"]
    for out in pair:
        o = out["runner_jax"]
        _close_params(w["params"], o["params"])
        np.testing.assert_allclose(o["metrics"]["mean_step_reward"], w["metrics"]["mean_step_reward"],
                                   atol=1e-4)
        for k in ("loss", "value_loss", "surrogate_loss", "entropy", "kl"):
            np.testing.assert_allclose(o["metrics"][k], w["metrics"][k], rtol=1e-3, err_msg=k)
        for k in ("learning_rate", "action_std"):
            np.testing.assert_allclose(o["metrics"][k], w["metrics"][k], rtol=1e-6, err_msg=k)
        for k in ("mean", "var"):
            np.testing.assert_allclose(o["norm"][k], w["norm"][k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)
        assert o["norm"]["count"] == 2 * w["norm"]["count"] == 2 * T * B
    assert pair[0]["runner_jax"]["digest"] == pair[1]["runner_jax"]["digest"]


def test_runner_ranks_stay_bitwise_equal_on_distinct_shards(results):
    pair = results[1]
    a, b = (out["runner_shards"] for out in pair)
    assert a["envs"] == b["envs"] == B // N
    assert a["digest"] == b["digest"]
    first = [out["runner_shards"]["rows"][0] for out in pair]
    # every env timed out on the first step: 8 episodes per shard, returns
    # near 6 and near 2
    assert [r["count"] for r in first] == [B // N, B // N]
    mean = sum(r["return_sum"] for r in first) / sum(r["count"] for r in first)
    for r in first:
        np.testing.assert_allclose(r["metrics"]["mean_reward"], mean, rtol=1e-6)
        assert r["metrics"]["episodes_done"] == B
        assert r["stage"] == 1 and r["metrics"]["reward_stage"] == 1.0
    assert first[0]["return_sum"] / (B // N) > 3.0 > first[1]["return_sum"] / (B // N)
    for ra, rb in zip(a["rows"], b["rows"]):
        # rnd_loss, like the PPO losses, is each rank's own
        for k in ("mean_reward", "mean_step_reward", "learning_rate", "kl", "episodes_done"):
            assert ra["metrics"][k] == rb["metrics"][k], k


def test_nonfinite_loss_on_one_rank_skips_the_step_on_every_rank(results):
    """Rank 1's third minibatch loss alone is NaN: both ranks skip that step
    (JAX's rank 0 would take it) and stay equal."""
    a, b = (out["nonfinite"] for out in results[1])
    assert a["skips"] == b["skips"] == 1.0
    assert a["digest"] == b["digest"]
    assert np.isfinite(a["loss"]) and not np.isfinite(b["loss"])


def test_dry_run_toy_passes_and_sharded_optimize(results):
    pair = results[1]
    train, mpc = pair[0]["dryrun"]
    assert train["pass"] == "toy_train" and train["envs_per_rank"] == 2 and train["agree"]
    assert mpc["pass"] == "toy_mpc" and mpc["rollouts"] == 4 and mpc["rollouts_per_rank"] == 2
    assert mpc["agree"] and mpc["finite"] and mpc["max_abs_err"] <= 1e-5
    assert all(x["agree"] for x in pair[1]["dryrun"])


def test_train_script_under_torchrun(results):
    """``torchrun --nproc_per_node 2 -m ...scripts.train`` on 2 CPU processes x
    8 envs, 2 iterations: one run directory, written by rank 0 alone (one
    console row per iteration), whose checkpoint the JAX runner reads."""
    from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
    from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner
    from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_flat_cfg, anymal_c_ppo_cfg

    train_dir, out = results[3]
    runs = glob.glob(str(train_dir / "logs" / "dp" / "*"))
    assert len(runs) == 1, (runs, out[-3000:])
    rows = [json.loads(x) for x in open(os.path.join(runs[0], "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2], rows
    assert len(glob.glob(os.path.join(runs[0], "events.out.tfevents.*"))) <= 1
    assert sum(line.startswith("it ") for line in out.splitlines()) == 2, out[-3000:]
    path = os.path.join(runs[0], "model_final.pkl")
    jc = janymal_c_flat_cfg()
    jc.env.num_envs = 4
    jr = JRunner(JLeggedRobot(jc), janymal_c_ppo_cfg())
    jr.load(path)
    assert int(jr.state.iteration) == 2
    cfg = anymal_c_flat_cfg()
    cfg.env.num_envs = 4
    runner = OnPolicyRunner(LeggedRobot(cfg, device="cpu"), anymal_c_ppo_cfg())
    runner.load(path)
    obs = np.random.default_rng(0).standard_normal((8, 48)).astype(np.float32)
    want = np.asarray(jr.get_inference_policy()(jnp.asarray(obs)))
    got = runner.get_inference_policy()(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
