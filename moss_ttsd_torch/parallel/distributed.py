"""Multi-process initialization, PyTorch port of
``moss_ttsd_tpu/parallel/distributed.py`` (``initialize_multihost``; the
global mesh waits for the port's parallelism).

One call to ``torch.distributed.init_process_group`` before the first
collective: ``nccl`` for the card, one card a process, ``gloo`` when the
caller asks for the CPU. Nothing on the machine announces a cluster, so
the address, the world size and the rank come from the arguments or from
the JAX package's environment variables:
  JAX_COORDINATOR_ADDRESS  host:port of process 0 (or a ``tcp://`` or
                           ``file://`` init method)
  JAX_NUM_PROCESSES        world size
  JAX_PROCESS_ID           this process's rank
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..core.device import DeviceLike, resolve_device


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: DeviceLike = "cuda") -> bool:
    """Join the default process group. Returns False, and does nothing,
    when no coordinator address is given or set (a single-process run);
    True once the group is up. On the card, rank r uses card r modulo the
    cards the host has."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo", init_method=init,
        world_size=num_processes, rank=process_id)
    return True
