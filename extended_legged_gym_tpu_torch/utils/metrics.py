"""Training metrics as JSON lines (port of ``utils/metrics.py``, JSONL sink
only: TensorBoard, W&B and Neptune are not ported)."""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    """Appends one JSON object per ``write`` to ``<log_dir>/metrics.jsonl``.
    The directory and file are made at the first write, so a run that never
    logs leaves no empty run directory behind."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = None

    def write(self, step: int, metrics: Dict[str, float]):
        if self._f is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._f = open(self.path, "a")
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
