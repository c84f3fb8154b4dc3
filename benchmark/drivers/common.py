"""What every driver shares: the cell it runs, set-up, the measured window
(untraced or under the profiler with the harness's host ranges), and the
check of the configuration the program was built with."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Tuple

import torch

from .. import trace as trace_mod
from ..record import patched


class Driver:
    """A cell's run.  Subclasses build the program (``build``), take one
    timed step (``step``), record the steps that the check follows
    (``check_steps``), free the program (``release``), give the end-to-end
    metrics of a window (``end_to_end``), the candidates and the numbers of
    the check, and the work one step needs (``work``).  ``FAULTS`` names the
    faults ``candidate`` can plant."""

    FAULTS: Tuple[str, ...] = ()

    def __init__(self, root: str, config: dict, traffic: dict, seed: int, device, mesh=None):
        self.root, self.config, self.traffic = root, config, traffic
        self.seed = seed
        # the port's data-parallel mesh (one process per card), or None
        self.mesh = mesh
        self.rank, self.world = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
        # numpy's RandomState takes seeds below 2**32: both sides use this one
        self.prog_seed = seed % (2 ** 32)
        self.device = torch.device(device)
        self.row_gen = torch.Generator().manual_seed(self.prog_seed + 1)
        self.spans: Dict[str, List[float]] = {}
        self.counters: Dict[str, float] = {}

    def path(self, rel: str) -> str:
        return os.path.join(self.root, rel)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self):
        self.build()
        self.check_steps()
        self.sync()

    # ------------------------------------------------------------ window
    def window(self, seconds: float, traced: bool) -> dict:
        """Steps until ``seconds`` have passed: ``{steps, failed, seconds,
        trace}``; a step that started before the end runs to its end."""
        self.spans = {}
        before = self.counter_values()
        prof = None
        with contextlib.ExitStack() as stack:
            if traced:
                prof = stack.enter_context(self.profiler())
                for obj, name, label in self.trace_ranges():
                    stack.enter_context(patched(obj, name, _ranged(label)))
                for obj, name, key in self.trace_timers():
                    stack.enter_context(patched(obj, name, self._timed(key)))
                stack.enter_context(torch.profiler.record_function(trace_mod.WINDOW))
            self.sync()
            t0 = time.perf_counter()
            steps = failed = 0
            while True:
                failed += 0 if self.step() else 1
                steps += 1
                if self._agreed(time.perf_counter() - t0 >= seconds):
                    break
            self.sync()
            elapsed = time.perf_counter() - t0
        after = self.counter_values()
        self.counters = {k: after[k] - before[k] for k in after}
        return dict(steps=steps, failed=failed, seconds=elapsed,
                    trace=trace_mod.from_profiler(prof) if prof is not None else None)

    def gather(self, tree: Dict[str, torch.Tensor]):
        """Every rank's ``tree`` (the same shapes on each) as a list by rank on
        rank 0 and None on the others; ``[tree]`` on one card."""
        if self.world == 1:
            return [tree]
        out = [{} for _ in range(self.world)] if self.rank == 0 else None
        for k, v in tree.items():
            x = v.reshape(-1).to(torch.uint8 if v.dtype == torch.bool else v.dtype).contiguous()
            parts = [torch.empty_like(x) for _ in range(self.world)] if self.rank == 0 else None
            torch.distributed.gather(x, parts, dst=0)
            if out is not None:
                for r in range(self.world):
                    out[r][k] = parts[r].to(v.dtype).view(v.shape)
        return out

    def _agreed(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank (the ranks stop together)."""
        if self.world == 1:
            return flag
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        torch.distributed.broadcast(t, src=0)
        return bool(t.item())

    def profiler(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def counter_values(self) -> Dict[str, float]:
        return {}

    def trace_ranges(self) -> List[Tuple[object, str, str]]:
        """``(object, attribute, label)`` of the calls the traced window wraps
        in the host range ``bench:<label>``."""
        return []

    def trace_timers(self) -> List[Tuple[object, str, str]]:
        """``(object, attribute, span)`` of the calls the traced window times
        between two synchronisations, into ``spans[span]`` (seconds)."""
        return []

    def _timed(self, key: str):
        def make(fn):
            def wrapped(*a, **kw):
                self.sync()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.sync()
                self.spans.setdefault(key, []).append(time.perf_counter() - t0)
                return out
            return wrapped
        return make


def _ranged(label: str):
    def make(fn):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(trace_mod.PREFIX + label):
                return fn(*a, **kw)
        return wrapped
    return make


def verify_config(config: dict, *cfgs) -> None:
    """Raise where the program's configuration departs from the
    configuration file in any value the file states in a group of the
    program's config tree (``env``, ``terrain``, ..., ``policy``,
    ``algorithm``, ``runner``, ``trajectory_opt``)."""
    from extended_legged_gym_tpu_torch.utils.config import class_to_dict

    built = {}
    for cfg in cfgs:
        built.update(class_to_dict(cfg))
    bad = []

    def walk(want, got, path):
        if isinstance(want, dict):
            if not isinstance(got, dict):
                bad.append(path)
                return
            for k, v in want.items():
                if k not in got:
                    bad.append(f"{path}.{k}")
                else:
                    walk(v, got[k], f"{path}.{k}")
        elif isinstance(want, (list, tuple)):
            if not isinstance(got, (list, tuple)) or len(want) != len(got):
                bad.append(path)
                return
            for i, (a, b) in enumerate(zip(want, got)):
                walk(a, b, f"{path}[{i}]")
        elif want != got:
            bad.append(f"{path}: file {want!r}, program {got!r}")

    for group, values in config.items():
        if isinstance(built.get(group), dict):
            walk(values, built[group], group)
    if bad:
        raise ValueError("the program's configuration departs from the configuration file: "
                         + "; ".join(bad[:10]))
