"""Run one cell of the benchmark of ``extended_legged_gym_tpu_torch`` on the
CUDA cards of this machine and print its result as one JSON line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration file and a traffic file; the traffic's ``driver``
names the module under ``drivers/`` that runs it.  Set-up builds the program
from the seed and runs the steps the check follows; the window then runs
steps for ``--seconds``; with ``--trace 1`` under the profiler, and the
per-layer metrics of the cell are read from the trace, the spans and the
counters by the readers under ``metrics/``.  After the window the program is
freed and the plain reference (``reference/``) judges the check steps
(``check.py``): each number is printed beside its limit, last on standard
error and last in the result's line.

A cell on several cards runs one process per card under ``torchrun``, which
this command starts on a port chosen at run time; the processes join the
port's data-parallel mesh and rank 0 prints the result.  A run without
enough CUDA cards, or one after which JAX or the JAX package is loaded,
exits non-zero and prints no result."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

from .check import judge, load_limits  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "extended_legged_gym_tpu")


def cache_env(root: str) -> None:
    """Every build and kernel cache at a fixed directory inside the checkout."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def load_cell(root: str, workload: str):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return bench, cell, config, traffic


def make_driver(root: str, config: dict, traffic: dict, seed: int, device, mesh=None):
    """The driver ``drivers/<traffic's driver>.py`` names as ``DRIVER``."""
    mod = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    return mod.DRIVER(root, config, traffic, seed, device, mesh)


def per_layer_metrics(root: str, bench: dict, cell: dict, ctx: dict) -> Dict[str, dict]:
    """Each per-layer metric of this cell from its reader
    ``metrics/<name>.py`` (``read(ctx)``: a number, or None where it finds
    nothing to read)."""
    out = {}
    for m in bench["per_layer"]:
        if cell["name"] not in m.get("workloads", [cell["name"]]):
            continue
        path = os.path.join(root, "benchmark", "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location("benchmark_metric_" + m["name"], path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(root: str, workload: str, seed: int, seconds: float, traced: bool, device,
             traffic_override: Optional[dict] = None, log=None,
             t_start: Optional[float] = None, mesh=None) -> Optional[dict]:
    """One run of a cell on ``device``; returns the result's line (a dict),
    on a mesh only on rank 0 (None on the others).  ``main`` calls it on the
    card; tests call it on the CPU at small sizes.  ``setup_s`` counts from
    ``t_start`` (by default this module's import)."""
    import torch

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    bench, cell, config, traffic = load_cell(root, workload)
    traffic = dict(traffic, **(traffic_override or {}))
    drv = make_driver(root, config, traffic, seed, device, mesh)
    drv.setup()
    setup_s = time.perf_counter() - (T_START if t_start is None else t_start)
    log(f"set-up done: {setup_s} s")
    cuda = drv.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(drv.device)
    res = drv.window(seconds, traced)
    peak = torch.cuda.max_memory_allocated(drv.device) if cuda else 0
    tr = res["trace"]
    busy = tr.busy_s if tr is not None else 0.0
    if drv.world > 1:
        # the fullest card's peak, the cards' mean busy time
        t = torch.tensor([float(peak), busy], dtype=torch.float64, device=drv.device)
        torch.distributed.all_reduce(t[:1], op=torch.distributed.ReduceOp.MAX)
        torch.distributed.all_reduce(t[1:], op=torch.distributed.ReduceOp.SUM)
        peak, busy = int(t[0]), float(t[1]) / drv.world
        if drv.rank != 0:
            return None
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {bad}")
    work = drv.work()
    spans = {k: list(v) for k, v in drv.spans.items()}
    counters = dict(drv.counters)

    metrics = drv.end_to_end(res)
    metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    if traced:
        ctx = dict(trace=tr, spans=spans, counters=counters, steps=res["steps"],
                   window_s=res["seconds"], work=work, config=config, traffic=traffic)
        metrics = per_layer_metrics(root, bench, cell, ctx)

    drv.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = drv.numbers(drv.candidate("program"))
    limits = load_limits(root, workload)
    correct = judge(numbers, limits) and res["failed"] == 0
    checks = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(drv.device) if cuda else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": res["steps"], "failed": res["failed"],
            "metrics": metrics, "device": device_info}
    if traced and tr is not None:
        device_info.update(busy_s=busy, window_s=tr.window_s)
        line["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    line["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return line


def launch(chips: int, argv, module: str = "benchmark.run") -> int:
    """``module`` with ``argv`` under ``torchrun``, one process per card, the
    rendezvous on a free local port; its exit code."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, BENCHMARK_T0=repr(time.time() - (time.perf_counter() - T_START)))
    return subprocess.call([sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
                            "--nproc_per_node", str(chips), "--master_addr", "127.0.0.1",
                            "--master_port", str(port), "-m", module, *argv],
                           cwd=ROOT, env=env)


def join_mesh(chips: int, device="cuda"):
    """This process's place in the port's data-parallel mesh under
    ``torchrun``."""
    from extended_legged_gym_tpu_torch.parallel.distributed import init_multi_host
    from extended_legged_gym_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device=init_multi_host(device=device)["device"])
    if mesh.size != chips:
        raise SystemExit(f"a world of {mesh.size} processes for a cell of {chips} cards")
    return mesh


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    if not os.path.isdir(os.path.join(ROOT, "extended_legged_gym_tpu_torch")):
        print("the program (extended_legged_gym_tpu_torch) is not in this checkout",
              file=sys.stderr)
        return 1
    import torch

    chips = int(load_cell(ROOT, args.workload)[1]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    if chips > 1 and "LOCAL_RANK" not in os.environ:
        return launch(chips, argv)
    mesh, t_start = None, None
    if chips > 1:
        mesh = join_mesh(chips)
        # set-up counts from the launcher's start
        t_start = time.perf_counter() - (time.time() - float(os.environ["BENCHMARK_T0"]))
    if mesh is None or mesh.rank == 0:
        print(f"device: {torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}; "
              f"nvidia-smi name, power.limit: {power_limit()}", file=sys.stderr, flush=True)
    try:
        line = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                        mesh.device if mesh is not None else "cuda:0", t_start=t_start, mesh=mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    if line is not None:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
