"""Environment state record and replay (port of ``utils/replay.py``, after the
reference's ``env_replay_mixin.py``): a recorder keeps each step's physics
state (``EnvState.phys``) as host-side numpy, exports and loads the frames
with pickle, and puts a frame back into an env state on the env's device.
"""
from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..physics.engine import PhysState


def _map_phys(fn, *states: PhysState) -> PhysState:
    """``fn`` over the matching fields of ``states``."""
    return PhysState(*[fn(*(getattr(s, f.name) for s in states))
                       for f in dataclasses.fields(PhysState)])


class StateRecorder:
    """Per-step snapshots of ``EnvState.phys`` as numpy (device memory stays
    flat), with an optional dict of extras per step."""

    def __init__(self):
        self.frames: List[PhysState] = []
        self.extras: List[Dict] = []

    def record_step(self, env_state, extra: Optional[Dict] = None):
        self.frames.append(_map_phys(lambda x: x.detach().cpu().numpy(), env_state.phys))
        self.extras.append(extra or {})

    def __len__(self):
        return len(self.frames)

    def export(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(dict(frames=self.frames, extras=self.extras), f)

    @classmethod
    def load(cls, path: str) -> "StateRecorder":
        rec = cls()
        with open(path, "rb") as f:
            d = pickle.load(f)
        rec.frames, rec.extras = d["frames"], d["extras"]
        return rec

    def replay_frame(self, env_state, idx: int):
        """``env_state`` with its physics state replaced by frame ``idx``, on
        the device of ``env_state``."""
        dev = env_state.phys.base_pos.device
        return env_state.replace(phys=_map_phys(lambda x: torch.as_tensor(x, device=dev),
                                                self.frames[idx]))

    def iter_replay(self, env_state) -> Iterator[Any]:
        for i in range(len(self.frames)):
            yield self.replay_frame(env_state, i)

    def stacked(self) -> PhysState:
        """All frames as one PhysState of numpy arrays with a leading time
        axis."""
        return _map_phys(lambda *xs: np.stack(xs), *self.frames)
