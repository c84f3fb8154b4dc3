"""CPU tests of ``benchmark/spans.py`` on hand-made traces: the idle split
over the program's spans sums to the window's idle time and matches hand
sums, kernels follow their launch's correlation id, and the harness's own
trace reader reads the same with the program's ranges in the trace.

    python -m pytest benchmark/tests -q -p no:cacheprovider -o addopts=""
"""
from __future__ import annotations

import pytest
from torch.autograd import DeviceType

from benchmark import spans as spans_mod
from benchmark import trace as trace_mod
from benchmark.spans import SpanTrace, is_glue

MS = 1_000_000                         # ns

# window 0-100 ms: env.step 10-60 (physics 10-20 with pack, launch, unpack;
# reward 30-50), mpc.polish 70-90 around a rollout step 70-80
SPANS = [("env.step", 10 * MS, 60 * MS), ("env.physics", 10 * MS, 20 * MS),
         ("physics.pack", 10 * MS, 12 * MS), ("physics.launch", 12 * MS, 13 * MS),
         ("physics.unpack", 13 * MS, 15 * MS), ("env.reward", 30 * MS, 50 * MS),
         ("mpc.polish", 70 * MS, 90 * MS), ("rollout", 70 * MS, 90 * MS),
         ("rollout.step", 70 * MS, 80 * MS)]
# (name, start, end, correlation); busy 5-11, 14-25, 40-45, 85-95
DEVICE = [("gather_kernel", 5 * MS, 11 * MS, 1), ("decimated_step_kernel", 14 * MS, 25 * MS, 2),
          ("Memcpy HtoD", 40 * MS, 45 * MS, 3), ("reward_kernel", 41 * MS, 44 * MS, 4),
          ("polish_kernel", 85 * MS, 95 * MS, 5), ("lost_kernel", 86 * MS, 87 * MS, 6)]
# launch times: 1 before any span, 2 in physics.launch, 4 in env.reward,
# 5 in rollout.step; 6 has no launch event
LAUNCHES = {1: 4 * MS, 2: int(12.5 * MS), 3: 31 * MS, 4: 32 * MS, 5: 75 * MS}


def span_trace():
    return SpanTrace(SPANS, DEVICE, LAUNCHES, 0, 100 * MS)


def test_idle_split_is_exact_and_sums_to_the_window_idle():
    idle = span_trace().idle_by_span()
    # busy 5-11, 14-25, 40-45, 85-95: idle 0-5, 11-14, 25-40, 45-85, 95-100
    assert sum(idle.values()) == pytest.approx(0.068)
    assert idle == pytest.approx({
        "outside": 0.020,                   # 0-5, 60-70, 95-100
        "physics.pack": 0.001, "physics.launch": 0.001, "physics.unpack": 0.001,
        "env.step": 0.015,                  # 25-30, 50-60
        "env.reward": 0.015,                # 30-40, 45-50
        "rollout.step": 0.010,              # 70-80
        "rollout": 0.005})                  # 80-85


def test_readings_per_step_by_hand():
    r = span_trace().readings(steps=2)
    # glue idle: pack 1, unpack 1, env.step 15, reward 15, rollout.step 10;
    # physics.launch's 1 ms and the rollout's own 5 ms are not glue
    assert r["glue_idle_ms"] == pytest.approx(42 / 2)
    # polish: rollout.step 10 + rollout 5 = 15 ms
    assert r["polish_idle_ms"] == pytest.approx(15 / 2)
    # kernels (the copy left out): 1 outside, 2 in physics.launch, 4 in
    # env.reward, 5 in rollout.step, 6 unattributed
    assert r["kernels"] == 5
    assert r["glue_launches"] == pytest.approx(2 / 2)
    assert r["unattributed_share"] == pytest.approx(1 / 5)
    assert r["launches_by_span"] == {"outside": 1, "physics.launch": 1, "env.reward": 1,
                                     "rollout.step": 1, "unattributed": 1}
    assert r["idle_s"] == pytest.approx(0.068)


def test_launches_follow_the_correlation_id_not_the_run_time():
    # the physics kernel runs 14-25 ms, after env.physics closed at 20 ms and
    # inside env.step alone, yet it was launched inside physics.launch
    paths, missing = span_trace().kernel_paths()
    assert ("env.step", "env.physics", "physics.launch") in paths and missing == 1


def test_glue_is_inside_the_env_and_rollout_steps():
    assert is_glue(("mpc.step", "env.step"))
    assert is_glue(("rollout", "rollout.step", "env.physics", "physics.unpack"))
    assert not is_glue(("env.step", "env.physics", "physics.launch"))
    assert not is_glue(("mpc.step", "mpc.optimize", "mpc.diffuse", "rollout"))
    assert not is_glue(())


class Ev:
    """A stand-in for one Kineto event of a finished profile."""

    def __init__(self, name, start, end, cuda=False, corr=0, kind="cpu_op", annotation=False):
        self._v = (name, start, end, cuda, corr, kind, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def correlation_id(self):
        return self._v[4]

    def activity_type(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("R", (), {"events": lambda _: events})()


def profile_events(with_spans: bool):
    evs = [Ev("bench:window", 0, 100 * MS), Ev("bench:env.step", 9 * MS, 61 * MS),
           Ev("bench:window", 0, 100 * MS, cuda=True, kind="gpu_user_annotation",
              annotation=True)]
    evs += [Ev(n, s, e, cuda=True, corr=c, kind="kernel") for n, s, e, c in DEVICE]
    evs += [Ev("cudaLaunchKernel", t, t + 10, corr=c, kind="cuda_runtime")
            for c, t in LAUNCHES.items()]
    evs += [Ev("aten::add", 31 * MS, 32 * MS, corr=3)]      # a CPU op's id is another count
    if with_spans:
        evs += [Ev("elg:" + n, s, e, kind="user_annotation", annotation=True) for n, s, e in SPANS]
        # the ranges that enclose kernels appear on the device's timeline too
        evs += [Ev("elg:" + n, s, e, cuda=True, kind="gpu_user_annotation", annotation=True)
                for n, s, e in SPANS[:2]]
    return evs


def test_read_takes_spans_kernels_and_launches_from_the_profile():
    st = spans_mod.read(Prof(profile_events(True)))
    assert sorted(st.spans) == sorted(SPANS)
    assert [d[:4] for d in st.device] == DEVICE
    assert st.launches == LAUNCHES
    assert (st.t0, st.t1) == (0, 100 * MS)
    assert spans_mod.read(Prof(profile_events(False))) is None


def test_the_harness_reads_the_same_with_the_program_spans():
    a = trace_mod.from_profiler(Prof(profile_events(False)))
    b = trace_mod.from_profiler(Prof(profile_events(True)))
    assert a.device == b.device and a.ranges == b.ranges
    assert (a.busy_s, a.kernel_count(), a.window_s) == (b.busy_s, b.kernel_count(), b.window_s)
    assert a.idle_gaps() == b.idle_gaps() and a.top_device_ops() == b.top_device_ops()
