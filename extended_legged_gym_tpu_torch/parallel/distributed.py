"""Multi-process initialization over ``torch.distributed`` (port of
``parallel/distributed.py``; the reference's torchrun / NCCL setup).

One process per card: ``nccl`` on the card, ``gloo`` where the caller asks
for the CPU.  The rendezvous address and the topology come from explicit
arguments or from torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``); with neither there is nothing to
join and the process runs alone, as the JAX function does on a plain
machine.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


def init_multi_host(coordinator_address: Optional[str] = None,
                    num_processes: Optional[int] = None, process_id: Optional[int] = None,
                    local_rank: Optional[int] = None, device="cuda",
                    timeout_s: float = 300.0) -> dict:
    """Join (or start) the process group and return the topology: the JAX
    function's keys ``process_index``, ``process_count``, ``local_devices``
    (one card per process), ``global_devices`` and ``is_main``, and
    ``device``, this process's device.

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL), by default
    ``MASTER_ADDR:MASTER_PORT``; ``num_processes``, ``process_id`` and
    ``local_rank`` default to ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``
    (else 1, 0 and ``process_id``).  On the card the process takes card
    ``local_rank``.  A process group that is already up is reused."""
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    num_processes = int(num_processes if num_processes is not None
                        else env.get("WORLD_SIZE", 1))
    process_id = int(process_id if process_id is not None else env.get("RANK", 0))
    local_rank = int(local_rank if local_rank is not None
                     else env.get("LOCAL_RANK", process_id))
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    if coordinator_address is not None and not dist.is_initialized():
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=url,
                                world_size=num_processes, rank=process_id,
                                timeout=datetime.timedelta(seconds=timeout_s))
    rank = dist.get_rank() if dist.is_initialized() else 0
    size = dist.get_world_size() if dist.is_initialized() else 1
    return dict(process_index=rank, process_count=size, local_devices=1, global_devices=size,
                is_main=rank == 0, device=dev)


def shutdown():
    """Leave the process group, where one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
