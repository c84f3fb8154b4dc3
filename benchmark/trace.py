"""Reading a torch.profiler trace of the measured window: device busy time
(the union of the device's activity intervals), kernels by name, and the idle
gaps of the device by what the host was doing, from the harness's
``record_function`` ranges (``bench:<name>``)."""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

PREFIX = "bench:"
WINDOW = PREFIX + "window"
NON_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")
ANNOTATIONS = (PREFIX, "nccl:")


def _is_annotation(ev) -> bool:
    probe = getattr(ev, "is_user_annotation", None)
    return bool(probe()) if callable(probe) else False


class TraceSummary:
    """What the per-layer readers read from one traced window.

    ``device`` holds ``(name, start_ns, end_ns)`` of every device activity
    (kernels, copies, sets); ``ranges`` ``(name, start_ns, end_ns)`` of the
    harness's host ranges, ``name`` without the prefix."""

    def __init__(self, device: Sequence[Tuple[str, int, int]],
                 ranges: Sequence[Tuple[str, int, int]]):
        win = [r for r in ranges if r[0] == WINDOW[len(PREFIX):]]
        if not win:
            raise ValueError("the trace holds no window range")
        self.t0, self.t1 = win[0][1], win[0][2]
        self.window_s = (self.t1 - self.t0) / 1e9
        self.device = [d for d in device if d[2] > self.t0 and d[1] < self.t1]
        self.ranges = [r for r in ranges if r[0] != WINDOW[len(PREFIX):]]
        self._merged = _merge([(max(s, self.t0), min(e, self.t1)) for _, s, e in self.device])
        self.busy_s = float(sum(e - s for s, e in self._merged)) / 1e9

    def kernels(self) -> List[Tuple[str, int, int]]:
        return [d for d in self.device if not d[0].startswith(NON_KERNELS)]

    def kernel_count(self) -> int:
        return len(self.kernels())

    def kernel_seconds(self, patterns: Iterable[str]) -> float:
        pats = tuple(patterns)
        return sum(e - s for n, s, e in self.kernels() if any(p in n for p in pats)) / 1e9

    def range_count(self, name: str) -> int:
        return sum(1 for r in self.ranges if r[0] == name)

    def top_device_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, int] = {}
        for name, s, e in self.device:
            tot[name[:64]] = tot.get(name[:64], 0) + (e - s)
        return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Seconds of device idleness inside the window, by the innermost
        harness range open at each gap's midpoint."""
        gaps, prev = [], self.t0
        for s, e in self._merged:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        tot: Dict[str, int] = {}
        events = sorted([(s, 0, i) for i, (_, s, _) in enumerate(self.ranges)]
                        + [((a + b) // 2, 1, j) for j, (a, b) in enumerate(gaps)])
        stack: List[int] = []
        for t, kind, i in events:
            while stack and self.ranges[stack[-1]][2] < t:
                stack.pop()
            if kind == 0:
                stack.append(i)
                continue
            owner = self.ranges[stack[-1]][0] if stack else "outside_the_harness_ranges"
            a, b = gaps[i]
            tot["idle_in_" + owner] = tot.get("idle_in_" + owner, 0) + (b - a)
        return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def _merge(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    iv = [(s, e) for s, e in intervals if e > s]
    if not iv:
        return []
    a = np.array(sorted(iv), dtype=np.int64)
    ends = np.maximum.accumulate(a[:, 1])
    starts = a[:, 0]
    new = np.ones(len(a), dtype=bool)
    new[1:] = starts[1:] > ends[:-1]
    idx = np.flatnonzero(new)
    last = np.append(idx[1:] - 1, len(a) - 1)
    return list(zip(starts[idx].tolist(), ends[last].tolist()))


def from_profiler(prof) -> Optional[TraceSummary]:
    """The summary of a finished ``torch.profiler.profile``; ``None`` when
    its trace holds no device activity (a CPU run)."""
    from torch.autograd import DeviceType

    device, ranges = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = int(ev.start_ns())
        end = start + int(ev.duration_ns())
        if ev.device_type() == DeviceType.CUDA:
            # ranges (the harness's, c10d's "nccl:<op>") appear on the
            # device's timeline too; they are no device work of their own
            if not (name.startswith(ANNOTATIONS) or _is_annotation(ev)):
                device.append((name, start, end))
        elif name.startswith(PREFIX):
            ranges.append((name[len(PREFIX):], start, end))
    if not device:
        return None
    return TraceSummary(device, ranges)
