"""Where the device waits and what launches its kernels, by the program's own
phases: the port's ``elg:<name>`` profiler ranges
(``extended_legged_gym_tpu_torch/utils/tracing.py``) read from a
torch.profiler trace of the measured window.

Each idle interval of the window is split exactly over the innermost span
open during it (the rest is "outside"), so the parts sum to the window's
idle time; each kernel is put down to the innermost span open at its launch,
joined to the runtime's launch event by correlation id (a kernel whose
launch is not in the trace is counted as unattributed).  The glue is what
runs inside ``env.step`` and ``rollout.step``, the physics kernel's launch
call (``physics.launch``) left out.

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s> [--program-spans 0|1]

runs the cell traced, as ``python3 -m benchmark.run ... --trace 1`` does
(its result line first), and then prints one JSON line ``{"spans": ...}``
of these readings per step of the window; ``--program-spans 0`` runs the
same with the program's spans switched off, for their cost.  The harness's
``trace.py`` does not keep these ranges: a cell's per-layer metrics cannot
read them until it does."""
from __future__ import annotations

import bisect
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import ANNOTATIONS, NON_KERNELS, WINDOW, _is_annotation, _merge

SPAN = "elg:"
OUTSIDE = "outside"
GLUE_ROOTS = ("env.step", "rollout.step")
NOT_GLUE = ("physics.launch",)
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")


class SpanTrace:
    """The program's spans, device activity and kernel launches of one
    traced window.

    ``spans`` ``(name, start_ns, end_ns)`` without the prefix, one thread's,
    so they nest; ``device`` ``(name, start_ns, end_ns, correlation)`` of
    every device activity; ``launches`` the host time of each correlation
    id's launch."""

    def __init__(self, spans: Sequence[Tuple[str, int, int]],
                 device: Sequence[Tuple[str, int, int, int]], launches: Dict[int, int],
                 t0: int, t1: int):
        self.t0, self.t1 = t0, t1
        self.spans = sorted(spans, key=lambda s: (s[1], -s[2]))
        self.device = [d for d in device if d[2] > t0 and d[1] < t1]
        self.launches = launches
        self._starts, self._paths = self._segments()

    def _segments(self):
        """The window cut where a span opens or closes: each piece's start
        and the names of the spans open over it, outermost first."""
        bounds = sorted({self.t0, self.t1} | {t for _, s, e in self.spans for t in (s, e)
                                                if self.t0 < t < self.t1})
        starts, paths, stack, i = [], [], [], 0
        for a in bounds[:-1]:
            while stack and stack[-1][2] <= a:
                stack.pop()
            while i < len(self.spans) and self.spans[i][1] <= a:
                if self.spans[i][2] > a:
                    stack.append(self.spans[i])
                i += 1
            starts.append(a)
            paths.append(tuple(s[0] for s in stack if s[2] > a))
        return starts, paths

    def _path_at(self, t: int) -> Tuple[str, ...]:
        k = bisect.bisect_right(self._starts, t) - 1
        return self._paths[k] if 0 <= k and t < self.t1 else ()

    def idle(self) -> List[Tuple[Tuple[str, ...], int]]:
        """``(path, ns)`` of every idle piece of the window."""
        merged = _merge([(max(s, self.t0), min(e, self.t1)) for _, s, e, _ in self.device])
        gaps, prev = [], self.t0
        for s, e in merged:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        ends = self._starts[1:] + [self.t1]
        out, k = [], 0
        for a, b in gaps:
            k = max(bisect.bisect_right(self._starts, a) - 1, 0)
            while k < len(self._starts) and self._starts[k] < b:
                lo, hi = max(a, self._starts[k]), min(b, ends[k])
                if hi > lo:
                    out.append((self._paths[k], hi - lo))
                k += 1
        return out

    def idle_by_span(self) -> Dict[str, float]:
        """Idle seconds by the innermost span open ("outside" where none is)."""
        tot: Dict[str, float] = {}
        for path, ns in self.idle():
            key = path[-1] if path else OUTSIDE
            tot[key] = tot.get(key, 0.0) + ns / 1e9
        return tot

    def kernel_paths(self) -> Tuple[List[Tuple[str, ...]], int]:
        """The span path at each kernel's launch, and the number of kernels
        whose launch could not be joined."""
        paths, missing = [], 0
        for name, _, _, corr in self.device:
            if name.startswith(NON_KERNELS):
                continue
            t = self.launches.get(corr)
            if t is None:
                missing += 1
            else:
                paths.append(self._path_at(t))
        return paths, missing

    def launches_by_span(self) -> Dict[str, int]:
        paths, missing = self.kernel_paths()
        tot: Dict[str, int] = {}
        for path in paths:
            key = path[-1] if path else OUTSIDE
            tot[key] = tot.get(key, 0) + 1
        if missing:
            tot["unattributed"] = missing
        return tot

    def readings(self, steps: int) -> dict:
        """Per step of the window: idle ms and kernels with a glue span
        innermost, idle ms while ``mpc.polish`` is open at any depth; the
        window's idle and kernels by innermost span; the unattributed share."""
        idle = self.idle()
        glue_idle = sum(ns for path, ns in idle if is_glue(path))
        polish_idle = sum(ns for path, ns in idle if "mpc.polish" in path)
        paths, missing = self.kernel_paths()
        kernels = len(paths) + missing
        return dict(
            steps=steps, spans=len(self.spans),
            glue_idle_ms=glue_idle / 1e6 / steps, glue_launches=sum(map(is_glue, paths)) / steps,
            polish_idle_ms=polish_idle / 1e6 / steps, kernels=kernels,
            unattributed_share=missing / kernels if kernels else 0.0,
            idle_s=sum(ns for _, ns in idle) / 1e9,
            idle_by_span=_top(self.idle_by_span()), launches_by_span=_top(self.launches_by_span()))


def is_glue(path: Tuple[str, ...]) -> bool:
    """A path whose innermost span lies in ``env.step`` or ``rollout.step``
    (either included), other than the physics kernel's launch call."""
    return bool(path) and path[-1] not in NOT_GLUE and any(p in GLUE_ROOTS for p in path)


def _top(d: dict) -> dict:
    return dict(sorted(d.items(), key=lambda kv: -kv[1]))


def read(prof) -> Optional[SpanTrace]:
    """The spans of a finished ``torch.profiler.profile``; ``None`` where the
    trace holds no window, no device activity or no program span."""
    from torch.autograd import DeviceType

    spans, device, launches, window = [], [], {}, None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = int(ev.start_ns())
        end = start + int(ev.duration_ns())
        if ev.device_type() == DeviceType.CUDA:
            if not (name.startswith(ANNOTATIONS + (SPAN,)) or _is_annotation(ev)):
                device.append((name, start, end, int(ev.correlation_id())))
        elif name.startswith(SPAN):
            spans.append((name[len(SPAN):], start, end))
        elif name == WINDOW:
            window = (start, end)
        elif _launch_kind(ev):
            launches[int(ev.correlation_id())] = start
    if window is None or not device or not spans:
        return None
    return SpanTrace(spans, device, launches, *window)


def _launch_kind(ev) -> bool:
    kind = getattr(ev, "activity_type", None)
    return kind() in LAUNCH_KINDS if callable(kind) else ev.name().startswith("cu")


# ---------------------------------------------------------------- the command
def main(argv=None) -> int:
    import argparse
    import os

    from . import run, trace
    from .record import patched

    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program-spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    chips = int(run.load_cell(run.ROOT, args.workload)[1]["chips"])
    if chips > 1 and "LOCAL_RANK" not in os.environ:
        return run.launch(chips, argv, module="benchmark.spans")
    got = {}

    def keep_spans(from_profiler):
        def wrapped(prof):
            got["trace"] = read(prof)
            return from_profiler(prof)
        return wrapped

    def add_readings(per_layer):
        def wrapped(root, bench, cell, ctx):
            st, tr = got.get("trace"), ctx["trace"]
            if st is not None:
                got["readings"] = dict(
                    st.readings(ctx["steps"]), program_spans=args.program_spans,
                    harness_idle_gaps=dict(tr.idle_gaps(50)) if tr is not None else None,
                    harness_kernels=tr.kernel_count() if tr is not None else None,
                    spans_in_harness_device=sum(
                        1 for d in tr.device if d[0].startswith(SPAN)) if tr is not None else None)
            return per_layer(root, bench, cell, ctx)
        return wrapped

    run_argv = ["--workload", args.workload, "--seed", str(args.seed),
                "--seconds", str(args.seconds), "--trace", "1"]
    with patched(trace, "from_profiler", keep_spans), \
            patched(run, "per_layer_metrics", add_readings):
        if args.program_spans:
            rc = run.main(run_argv)
        else:
            from extended_legged_gym_tpu_torch.utils import tracing

            with patched(tracing, "_profiler_enabled", lambda _: lambda: False):
                rc = run.main(run_argv)
    if "readings" in got:
        print(json.dumps({"spans": got["readings"]}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
