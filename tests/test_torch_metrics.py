"""The training metrics writer (utils/metrics.py) against the JAX package's:
the JSONL record, the TensorBoard sink read back with tensorboard's
``EventAccumulator`` (scalars equal to the JSONL rows, float32), the W&B and
Neptune adapters dropping out without their packages (neither is installed
here), ``use_tensorboard=False``, and nothing made on disk before the first
write."""
import json
import os

import numpy as np
import pytest
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from extended_legged_gym_tpu.utils.metrics import MetricsWriter as JMetricsWriter
from extended_legged_gym_tpu_torch.utils import metrics
from extended_legged_gym_tpu_torch.utils.metrics import MetricsWriter

ROWS = [(0, {"Loss/value_function": 0.5, "Train/mean_reward": -1.25}),
        (1, {"Loss/value_function": 0.375, "Train/mean_reward": 2.0 / 3.0}),
        (5, {"Loss/value_function": 0.1, "Train/mean_reward": 7.5})]


def write_rows(w):
    for step, m in ROWS:
        w.write(step, m)
    w.close()


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture
def no_logger_env(monkeypatch):
    monkeypatch.delenv("ELG_LOGGER", raising=False)


def test_tensorboard_sink_matches_the_jsonl_rows(tmp_path, no_logger_env):
    w = MetricsWriter(str(tmp_path / "run"))
    write_rows(w)
    rows = read_jsonl(tmp_path / "run" / "metrics.jsonl")
    assert [r["step"] for r in rows] == [0, 1, 5]
    events = [f for f in os.listdir(tmp_path / "run") if f.startswith("events.out.tfevents")]
    assert len(events) == 1
    acc = EventAccumulator(str(tmp_path / "run"))
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == sorted(ROWS[0][1])
    for tag in ROWS[0][1]:
        got = acc.Scalars(tag)
        assert [e.step for e in got] == [r["step"] for r in rows]
        np.testing.assert_array_equal(np.float32([e.value for e in got]),
                                      np.float32([r[tag] for r in rows]))


def test_rows_match_the_jax_writer(tmp_path, no_logger_env):
    write_rows(MetricsWriter(str(tmp_path / "port"), use_tensorboard=False))
    write_rows(JMetricsWriter(str(tmp_path / "jax"), use_tensorboard=False))
    got, want = (read_jsonl(tmp_path / d / "metrics.jsonl") for d in ("port", "jax"))
    assert [{k: v for k, v in r.items() if k != "time"} for r in got] == \
        [{k: v for k, v in r.items() if k != "time"} for r in want]


@pytest.mark.parametrize("backend", ["wandb", "neptune"])
@pytest.mark.parametrize("through", ["ELG_LOGGER", "argument"])
def test_missing_wandb_and_neptune_leave_no_sink(tmp_path, monkeypatch, backend, through):
    if through == "ELG_LOGGER":
        monkeypatch.setenv("ELG_LOGGER", backend)
        w = MetricsWriter(str(tmp_path / "run"))
    else:
        monkeypatch.delenv("ELG_LOGGER", raising=False)
        w = MetricsWriter(str(tmp_path / "run"), backend=backend)
    w.write(0, {"a": 1.0})
    assert w.sinks == [] and w.tb is None
    w.close()
    assert read_jsonl(tmp_path / "run" / "metrics.jsonl")[0]["a"] == 1.0
    assert os.listdir(tmp_path / "run") == ["metrics.jsonl"]


def test_use_tensorboard_false_leaves_no_sink(tmp_path, no_logger_env):
    w = MetricsWriter(str(tmp_path / "run"), use_tensorboard=False)
    w.write(3, {"a": 2.0})
    assert w.sinks == [] and w.tb is None
    w.close()
    assert os.listdir(tmp_path / "run") == ["metrics.jsonl"]


def test_nothing_is_made_before_the_first_write(tmp_path, no_logger_env):
    w = MetricsWriter(str(tmp_path / "a" / "run"))
    assert not (tmp_path / "a").exists() and w.sinks == [] and w.tb is None
    w.write(0, {"a": 1.0})
    assert (tmp_path / "a" / "run" / "metrics.jsonl").is_file()
    assert type(w.tb).__name__ == "SummaryWriter"
    w.close()


def test_close_closes_every_sink(tmp_path, monkeypatch):
    """A sink whose package imports is opened at the first write, gets every
    scalar, and is closed by ``close``."""
    closed, seen = [], []

    class FakeRun:
        def __init__(self, log_dir, project=None):
            self.log_dir = log_dir

        def add_scalar(self, k, v, step):
            seen.append((k, v, step))

        def close(self):
            closed.append(self.log_dir)

    monkeypatch.setattr(metrics, "_WandbSink", FakeRun)
    w = MetricsWriter(str(tmp_path / "run"), backend="wandb")
    write_rows(w)
    assert closed == [str(tmp_path / "run")] and w.sinks == []
    assert seen == [(k, float(v), step) for step, m in ROWS for k, v in m.items()]


def test_a_sink_whose_set_up_fails_is_dropped_with_a_warning(tmp_path, monkeypatch):
    """Neptune installed but refusing to start (no credentials): a warning, no
    sink, the JSONL rows written."""
    def refuse(log_dir, project=None):
        raise RuntimeError("no credentials")

    monkeypatch.setattr(metrics, "_NeptuneSink", refuse)
    w = MetricsWriter(str(tmp_path / "run"), backend="neptune")
    with pytest.warns(UserWarning, match="neptune sink dropped"):
        w.write(0, {"a": 1.0})
    assert w.sinks == []
    w.close()
    assert read_jsonl(tmp_path / "run" / "metrics.jsonl")[0]["a"] == 1.0
