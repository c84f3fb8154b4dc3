"""One rank of a small data-parallel run of ``train-rough-dp4`` on the CPU
(gloo), started by ``test_bench_harness.py`` under ``torchrun``: prints rank
0's result line; ``--fault`` plants a fault in the program: ``exchange``
leaves its reductions out (each rank steps alone), ``unchanged`` applies no
optimizer step, ``half`` takes each minibatch loss over its first half."""
from __future__ import annotations

import argparse
import json
import time

from benchmark.run import ROOT, join_mesh, run_cell


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fault", default="")
    args = ap.parse_args()
    from extended_legged_gym_tpu_torch.rl import ppo

    if args.fault == "exchange":
        ppo.pmean = lambda tensors, mesh: list(tensors)
    elif args.fault == "unchanged":
        ppo.Adam.step = lambda self, grads, lr, ok: None
    elif args.fault == "half":
        orig = ppo._ppo_loss

        def half_loss(cfg, mean, std, value, mb):
            n = mean.shape[0] // 2
            return orig(cfg, mean[:n], std, value[:n], {k: v[:n] for k, v in mb.items()})
        ppo._ppo_loss = half_loss
    mesh = join_mesh(4, device="cpu")
    line = run_cell(ROOT, "train-rough-dp4", 2 ** 31 + 5, 0.2, False, mesh.device,
                    traffic_override=dict(num_envs=16, check_rows_per_step=2),
                    log=lambda s: None, t_start=time.perf_counter(), mesh=mesh)
    if line is not None:
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
