"""The readings that a cell's limits are set from, on the chip at the cell's
own size: for each seed, set-up as a run makes it (no measured window), then
the check's numbers for the program, for the control (the plain reference in
the program's place with its matrix products in TF32, the precision below
the configuration's float32 with TF32 off) and for each planted fault the
cell can have.  One process reads all seeds (on several cards, one process
per card under ``torchrun``; rank 0 reads the numbers).

    python3 -m benchmark.calibrate --workload <name> --seeds 11 12 13 \\
        [--kinds program control unchanged half altered exchange] [--all-kinds-for K] \\
        [--out chiprun_out/x.jsonl]

``--all-kinds-for K``: only the first ``K`` seeds read every kind, the
others the program alone.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import torch

from .run import ROOT, cache_env, join_mesh, launch, load_cell, make_driver


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kinds", nargs="+", default=None)
    ap.add_argument("--all-kinds-for", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    _, cell, config, traffic = load_cell(ROOT, args.workload)
    chips = int(cell["chips"])
    if chips > 1 and "LOCAL_RANK" not in os.environ:
        return launch(chips, argv, module="benchmark.calibrate")
    mesh = join_mesh(chips) if chips > 1 else None
    kinds = args.kinds
    sink = open(args.out, "a") if args.out and (mesh is None or mesh.rank == 0) else None
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        drv = make_driver(ROOT, config, traffic, seed,
                          mesh.device if mesh is not None else "cuda:0", mesh)
        drv.setup()
        t_setup = time.perf_counter() - t0
        kinds = kinds or ["program", "control", *drv.FAULTS]
        drv.release()
        few = args.all_kinds_for is not None and i >= args.all_kinds_for
        kinds_now = ["program"] if few else kinds
        gc.collect()
        torch.cuda.empty_cache()
        if drv.rank != 0:
            continue
        for kind in kinds_now:
            t1 = time.perf_counter()
            numbers = drv.numbers(drv.candidate(kind))
            row = dict(workload=args.workload, seed=seed, kind=kind, numbers=numbers,
                       setup_s=t_setup, check_s=time.perf_counter() - t1,
                       device=torch.cuda.get_device_name(0))
            print(json.dumps(row), flush=True)
            if sink:
                sink.write(json.dumps(row) + "\n")
                sink.flush()
        del drv
        gc.collect()
        torch.cuda.empty_cache()
    if sink:
        sink.close()
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
