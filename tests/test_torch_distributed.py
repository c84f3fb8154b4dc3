"""The port's torch.distributed layer (parallel/distributed.py,
parallel/mesh.py) and the sharded rollout of scripts/weak_scaling.py in
real processes over the ``gloo`` backend on the CPU, as
tests/test_distributed.py runs the JAX package's two processes.

Each test starts its processes with its own timeout and kills them on
expiry.  The worker is this file run as a script: it joins the group (from
explicit arguments or from torchrun's environment variables), all-reduces
per-rank gradients to their mean, broadcasts rank 0's parameters, shards and
gathers a batch, and rolls out a sample-sharded ``rollout_batch`` of a tiny
ANYmal-C config (1 main env, 2 samples per rank, H=2) whose gathered
rewards must equal the one-process rollout of all samples (1e-5), then one
weak-scaling row at world size 2."""
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(extra=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra or {})
    return env


def _run(procs):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.mark.parametrize("mode", ["explicit", "environment"])
def test_two_process_gloo(mode):
    n, port = 2, _free_port()
    procs = []
    for rank in range(n):
        extra = ({} if mode == "explicit" else
                 dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(n),
                      RANK=str(rank), LOCAL_RANK=str(rank)))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, str(rank), str(n), str(port)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=_env(extra),
            text=True))
    outs = _run(procs)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        assert f"RESULT {rank} ok" in out, out[-4000:]


def test_init_multi_host_single_process_defaults():
    """Nothing to join (no address, no torchrun variables): one process, no
    group, the JAX function's keys."""
    code = ("from extended_legged_gym_tpu_torch.parallel.distributed import init_multi_host\n"
            "import torch.distributed as dist\n"
            "info = init_multi_host(device='cpu')\n"
            "assert info['process_count'] == 1 and info['is_main'] and info['process_index'] == 0\n"
            "assert info['global_devices'] == info['local_devices'] == 1, info\n"
            "assert not dist.is_initialized()\n"
            "from extended_legged_gym_tpu_torch.parallel.mesh import make_mesh, shard_batch\n"
            "import torch\n"
            "m = make_mesh(device='cpu')\n"
            "x = torch.arange(6.0).reshape(3, 2)\n"
            "assert m.size == 1 and torch.equal(shard_batch({'x': x}, m, 3)['x'], x)\n"
            "print('RESULT ok')\n")
    p = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=_env(), text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    out = _run([p])[0]
    assert p.returncode == 0 and "RESULT ok" in out, out[-4000:]


def worker(mode, rank, n, port):
    import torch
    import torch.distributed as dist

    from extended_legged_gym_tpu_torch.parallel.distributed import init_multi_host, shutdown
    from extended_legged_gym_tpu_torch.parallel.mesh import (gather_batch, make_mesh, replicate,
                                                             shard_batch)
    from extended_legged_gym_tpu_torch.scripts import weak_scaling

    torch.set_num_threads(1)
    if mode == "explicit":
        info = init_multi_host(coordinator_address=f"127.0.0.1:{port}", num_processes=n,
                               process_id=rank, device="cpu")
    else:
        info = init_multi_host(device="cpu")
    assert info["process_count"] == n and info["process_index"] == rank, info
    assert info["global_devices"] == n * info["local_devices"] and info["is_main"] == (rank == 0)
    assert dist.get_backend() == "gloo"
    mesh = make_mesh(n, device="cpu")
    assert (mesh.axis_name, mesh.rank, mesh.size) == ("dp", rank, n)

    # data-parallel gradient reduction: the mean of the ranks' gradients
    g = torch.full((4,), 2.0 * (rank + 1))
    dist.all_reduce(g)
    g /= n
    assert torch.allclose(g, torch.full((4,), 2.0 * sum(range(1, n + 1)) / n)), g
    # parameters broadcast from rank 0
    synced = replicate({"w": torch.full((3,), rank * 100.0), "step": (torch.tensor(rank),)}, mesh)
    assert torch.equal(synced["w"], torch.zeros(3)) and int(synced["step"][0]) == 0
    # a batch sharded along axis 1 and gathered back; other leaves whole
    full = torch.arange(2 * 4 * 3.0).reshape(2, 4, 3)
    part = shard_batch({"x": full, "c": torch.ones(2, 3)}, mesh, 4, axis=1)
    assert part["x"].shape == (2, 4 // n, 3) and part["c"].shape == (2, 3)
    assert torch.equal(gather_batch(part["x"], mesh, axis=1), full)

    # the sample-sharded rollout equals the one-process rollout of all samples
    per, H = 2, 2
    env = weak_scaling.rollout_env(1, per, H, "cpu")
    state = replicate(env.reset_all(seed=0), mesh)
    us = weak_scaling.candidates(env, per * n, H)
    rew = weak_scaling.sharded_rollout_batch(env, state, shard_batch(us, mesh, per * n, axis=1),
                                             mesh)
    assert rew.shape == (1, per * n, H + 1)
    whole = env.rollout_batch(env.reset_all(seed=0), us)
    assert torch.allclose(rew, whole, rtol=1e-5, atol=1e-5), (rew - whole).abs().max()
    row = weak_scaling.measure(per, H, 1, mesh=mesh, device="cpu", reps=1)
    assert row["devices"] == n and row["samples"] == per * n and row["t_rollout_s"] > 0
    shutdown()
    print(f"RESULT {rank} ok", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
