"""Worker of tests/test_torch_data_parallel.py: one process of a gloo group
on the CPU, run as a script.  It imports torch and the port only (no JAX):
the test hands it its inputs as ``torch.save`` files and reads its results
back the same way.

    python tests/torch_dp_worker.py pair RANK 2 PORT DIR
    python tests/torch_dp_worker.py single 0 1 PORT DIR

``pair`` (2 ranks) runs the data-parallel updates on this rank's shard of
the JAX batches, the runner on duplicate and on distinct shards, a
non-finite loss on rank 1 only, and the dry run's toy passes; ``single``
(world size 1) runs each reduced path beside its ``mesh=None`` twin.
"""
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from extended_legged_gym_tpu_torch.models.networks import (ActorCritic,  # noqa: E402
                                                           ActorCriticRecurrent, RunningNorm,
                                                           flax_tree, params_from_jax,
                                                           params_to_jax)
from extended_legged_gym_tpu_torch.parallel.distributed import init_multi_host, shutdown  # noqa: E402
from extended_legged_gym_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from extended_legged_gym_tpu_torch.rl import ppo  # noqa: E402
from extended_legged_gym_tpu_torch.scripts import dryrun_multichip  # noqa: E402

SHARDED = ("obs", "critic_obs", "actions", "rewards", "dones", "values", "log_probs", "mu")


def shard(x, rank, n, axis):
    k = x.shape[axis] // n
    return x.narrow(axis, rank * k, k)


def make_net(inp):
    if inp["recurrent"]:
        net = ActorCriticRecurrent(inp["obs_dim"], inp["act_dim"], inp["hid"], inp["hid"],
                                   rnn_hidden_size=inp["rnn_hidden"], rnn_type="lstm")
    else:
        net = ActorCritic(inp["obs_dim"], inp["act_dim"], inp["hid"], inp["hid"])
    net.load_state_dict(params_from_jax(inp["params"]))
    return net


def run_update(inp, rank, n, mesh):
    """This rank's shard of the case's batch through the port's update;
    returns (network, learning rate, metrics)."""
    net = make_net(inp)
    cfg = ppo.PPOConfig(learning_rate=inp["lr"])
    b = inp["batch"]
    batch = ppo.Transition(**{k: (shard(v, rank, n, 1) if k in SHARDED else v)
                              for k, v in b.items()})
    adv, ret = (shard(inp[k], rank, n, 1) for k in ("adv", "ret"))
    lr0 = torch.tensor(inp["lr"])
    adam = ppo.Adam(net.parameters(), cfg.max_grad_norm)
    if inp["recurrent"]:
        carries0 = tuple(tuple(shard(h, rank, n, 0) for h in c) for c in inp["carries0"])
        lr, m = ppo.ppo_update_recurrent(net, cfg, adam, batch, carries0, adv, ret, lr0,
                                         perms=inp["perms"], mesh=mesh)
    else:
        sym = inp.get("symmetry")
        if sym is not None:
            sym = (ppo.make_mirror_fns(*sym[0]), ppo.make_mirror_fns(*sym[1]), sym[2])
        lr, m = ppo.ppo_update(net, cfg, adam, batch, adv, ret, lr0, perms=inp["perms"],
                               symmetry=sym, mesh=mesh)
    return net, lr, m


def tree_of(net, recurrent):
    return flax_tree(net) if recurrent else params_to_jax(net)


def floats(m):
    return {k: float(v) for k, v in m.items()}


def quiet_cfgs(num_envs, empirical=True, rnd=False):
    from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_flat_cfg, anymal_c_ppo_cfg

    cfg = anymal_c_flat_cfg()
    cfg.env.num_envs = num_envs
    cfg.noise.add_noise = False
    cfg.domain_rand.randomize_friction = cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.push_robots = False
    tc = anymal_c_ppo_cfg()
    tc.seed = 3
    tc.runner.num_steps_per_env = 8
    tc.runner.empirical_normalization = empirical
    tc.policy.actor_hidden_dims = tc.policy.critic_hidden_dims = [32, 16]
    if rnd:
        tc.algorithm.rnd_cfg = {"weight": 0.5, "hidden_dims": [16, 16], "num_outputs": 8}
    return cfg, tc


def rank_tensors(runner):
    """The state the ranks must hold alike, RND's included."""
    out = dryrun_multichip.runner_tensors(runner)
    if runner.rnd is not None:
        r, ro = runner.rnd, runner.rnd_optimizer
        out += [p.detach() for p in r.parameters()] + [ro.mu, ro.nu, ro.count, r.step]
        out += [t for nm in (r.state_norm, r.reward_norm) for t in (nm.mean, nm.var, nm.count)]
    return out


def runner_on_jax_state(mesh, d):
    """Each rank holds the JAX runner's whole 16-env state: one iteration
    with its draws."""
    from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
    from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner

    inp = torch.load(os.path.join(d, "runner.pt"), weights_only=False)
    cfg, tc = quiet_cfgs(16)
    runner = OnPolicyRunner(LeggedRobot(cfg, device="cpu"), tc, mesh=mesh)
    runner.env_state = inp["env_state"]
    runner.network.load_state_dict(inp["params"])
    m = runner.train_iteration(action_noise=inp["noise"], perms=inp["perms"])
    nm = runner.obs_norm
    return dict(params=params_to_jax(runner.network), metrics=floats(m),
                norm=dict(mean=nm.mean.numpy(), var=nm.var.numpy(), count=float(nm.count)),
                digest=dryrun_multichip.digest(rank_tensors(runner)))


def runner_on_shards(mesh, rank, iters=2):
    """Distinct 8-env shards (16 global envs through the registry), RND and
    the normalizer on; every env times out on the first step, rank 0's
    episodes with a return of 6 and rank 1's with 2."""
    from extended_legged_gym_tpu_torch import robots  # noqa: F401
    from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner
    from extended_legged_gym_tpu_torch.utils.task_registry import task_registry

    cfg, tc = quiet_cfgs(16, rnd=True)
    env, _ = task_registry.make_env("anymal_c_flat", env_cfg=cfg, device="cpu", mesh=mesh)
    runner = OnPolicyRunner(env, tc, mesh=mesh)
    es = runner.env_state
    runner.env_state = es.replace(
        episode_length=torch.full_like(es.episode_length, env.max_episode_length),
        episode_return=torch.full_like(es.episode_return, 6.0 if rank == 0 else 2.0))
    rows = []
    for _ in range(iters):
        m = runner.train_iteration()
        em = runner.env_state.episode_metrics
        rows.append(dict(metrics=floats(m), return_sum=float(em["return_sum"]),
                         count=float(em["count"]),
                         stage=int(runner.env_state.reward_stage)))
    return dict(envs=env.num_envs, rows=rows, digest=dryrun_multichip.digest(rank_tensors(runner)))


def nonfinite_on_one_rank(inp, rank, n, mesh):
    """The MLP case with rank 1's third minibatch loss made NaN (its
    gradients stay finite): every rank skips that step."""
    orig = ppo._ppo_loss
    calls = [0]

    def loss(*a):
        out = orig(*a)
        calls[0] += 1
        if rank == 1 and calls[0] == 3:
            out = (out[0] + float("nan"), *out[1:])
        return out

    ppo._ppo_loss = loss
    try:
        net, lr, m = run_update(inp, rank, n, mesh)
    finally:
        ppo._ppo_loss = orig
    return dict(skips=float(m["nonfinite_skips"]), loss=float(m["loss"]),
                digest=dryrun_multichip.digest(list(net.parameters()) + [lr]))


def pair(rank, n, port, d):
    init_multi_host(f"127.0.0.1:{port}", n, rank, device="cpu")
    mesh = make_mesh(n, device="cpu")
    out = {}
    try:
        for case in ("mlp", "mlp_sym", "recurrent"):
            inp = torch.load(os.path.join(d, f"ppo_{case}.pt"), weights_only=False)
            net, lr, m = run_update(inp, rank, n, mesh)
            out[case] = dict(params=tree_of(net, inp["recurrent"]), lr=float(lr),
                             metrics=floats(m),
                             digest=dryrun_multichip.digest(list(net.parameters()) + [lr]))
        out["nonfinite"] = nonfinite_on_one_rank(
            torch.load(os.path.join(d, "ppo_mlp.pt"), weights_only=False), rank, n, mesh)
        out["runner_jax"] = runner_on_jax_state(mesh, d)
        out["runner_shards"] = runner_on_shards(mesh, rank)
        out["dryrun"] = [dryrun_multichip.PASSES[p](mesh) for p in ("toy_train", "toy_mpc")]
    finally:
        shutdown()
    torch.save(out, os.path.join(d, f"out_pair_{rank}.pt"))


def single(port, d):
    """World size 1 with the group up (the collectives run): each reduced
    path's bits against its ``mesh=None`` twin."""
    from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
    from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner

    init_multi_host(f"127.0.0.1:{port}", 1, 0, device="cpu")
    mesh = make_mesh(1, device="cpu")
    out = {}
    try:
        for case in ("mlp", "mlp_sym", "recurrent"):
            inp = torch.load(os.path.join(d, f"ppo_{case}.pt"), weights_only=False)
            got = [run_update(inp, 0, 2, mh) for mh in (None, mesh)]     # a half batch
            out[case] = [dryrun_multichip.digest(list(net.parameters()) + [lr]
                                                 + [m[k] for k in sorted(m)])
                         for net, lr, m in got]
        x = torch.randn(8, 16, 48, generator=torch.Generator().manual_seed(0))
        norms = [RunningNorm.create(48).update(x, mh).update(2.0 * x + 1.0, mh)
                 for mh in (None, mesh)]
        out["norm"] = [dryrun_multichip.digest([nm.mean, nm.var, nm.count]) for nm in norms]
        digests = []
        for mh in (None, mesh):
            cfg, tc = quiet_cfgs(16, rnd=True)
            runner = OnPolicyRunner(LeggedRobot(cfg, device="cpu"), tc, mesh=mh)
            m = runner.train_iteration()
            digests.append(dryrun_multichip.digest(rank_tensors(runner)
                                                   + [m[k] for k in sorted(m)]))
        out["runner"] = digests
    finally:
        shutdown()
    torch.save(out, os.path.join(d, "out_single_0.pt"))


if __name__ == "__main__":
    torch.set_num_threads(1)
    mode, rank, n, port, d = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), \
        sys.argv[5]
    if mode == "pair":
        pair(rank, n, port, d)
    else:
        single(port, d)
    print(f"RESULT {mode} {rank} ok", flush=True)
