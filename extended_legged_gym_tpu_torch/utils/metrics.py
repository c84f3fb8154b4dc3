"""Training metrics writers (port of ``utils/metrics.py``): JSON lines always,
and one more sink where its package imports: TensorBoard (the default), W&B
or Neptune, as ``cfg.runner.logger`` names them in the reference.  The JSONL
file is the canonical record either way; a sink whose package is missing
drops out silently, one whose set-up fails otherwise (W&B or Neptune
without credentials) with a warning."""
from __future__ import annotations

import json
import os
import time
import warnings
from typing import Dict, Optional


class _WandbSink:
    """Scalars to a W&B run (the reference's ``WandbSummaryWriter``)."""

    def __init__(self, log_dir: str, project: Optional[str] = None):
        import wandb  # raises if absent: the caller drops the sink

        self.run = wandb.init(project=project or os.environ.get("WANDB_PROJECT", "elg_tpu"),
                              dir=log_dir, resume="allow")

    def add_scalar(self, k, v, step):
        self.run.log({k: v}, step=step)

    def close(self):
        self.run.finish()


class _NeptuneSink:
    """Scalars to a Neptune run (the reference's ``NeptuneSummaryWriter``)."""

    def __init__(self, log_dir: str, project: Optional[str] = None):
        import neptune  # raises if absent: the caller drops the sink

        self.run = neptune.init_run(project=project)

    def add_scalar(self, k, v, step):
        self.run[k].append(v, step=step)

    def close(self):
        self.run.stop()


class MetricsWriter:
    """Appends one JSON object per ``write`` to ``<log_dir>/metrics.jsonl``
    and fans the scalars out to ``sinks``.  ``backend`` is "tensorboard",
    "wandb" or "neptune" (default: ``$ELG_LOGGER``, else "tensorboard");
    ``use_tensorboard=False`` leaves the TensorBoard backend without a sink.
    The directory, the file and the sinks are made at the first write, so a
    run that never logs leaves no empty run directory behind."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True,
                 backend: Optional[str] = None):
        self.log_dir = log_dir
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._use_tensorboard = use_tensorboard
        self._backend = backend or os.environ.get("ELG_LOGGER", "tensorboard")
        self._f = None
        self.sinks = []

    def _materialize(self):
        os.makedirs(self.log_dir, exist_ok=True)
        self._f = open(self.path, "a")
        if self._use_tensorboard and self._backend == "tensorboard":
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
            self.sinks.append(SummaryWriter(log_dir=self.log_dir, flush_secs=30))
        elif self._backend in ("wandb", "neptune"):
            sink = _WandbSink if self._backend == "wandb" else _NeptuneSink
            try:
                self.sinks.append(sink(self.log_dir))
            except ImportError:
                pass
            except Exception as e:      # the service's set-up: the run goes on without it
                warnings.warn(f"{self._backend} sink dropped: {e!r}")

    @property
    def tb(self):
        """The first sink (the TensorBoard writer by default), or ``None``."""
        return self.sinks[0] if self.sinks else None

    def write(self, step: int, metrics: Dict[str, float]):
        if self._f is None:
            self._materialize()
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        for sink in self.sinks:
            for k, v in metrics.items():
                sink.add_scalar(k, float(v), step)

    def close(self):
        """Close the file and every sink; a later write opens them anew."""
        if self._f is not None:
            self._f.close()
            self._f = None
        for sink in self.sinks:
            sink.close()
        self.sinks = []
