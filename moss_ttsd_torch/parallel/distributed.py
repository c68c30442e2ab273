"""Multi-process initialization, PyTorch port of
``moss_ttsd_tpu/parallel/distributed.py`` (``initialize_multihost``,
``global_mesh``).

One call to ``torch.distributed.init_process_group`` before the first
collective: ``nccl`` for the card, one card a process, ``gloo`` when the
caller asks for the CPU (or for ``backend="gloo"``: processes that share
one card). Nothing on the machine announces a cluster, so the address,
the world size and the rank come from the arguments, from the JAX
package's environment variables:
  JAX_COORDINATOR_ADDRESS  host:port of process 0 (or a ``tcp://`` or
                           ``file://`` init method)
  JAX_NUM_PROCESSES        world size
  JAX_PROCESS_ID           this process's rank
or from the ones ``python -m torch.distributed.run`` sets (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; ``LOCAL_RANK`` picks the card),
the counterpart of JAX's pod auto-detection.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from ..core.device import DeviceLike, resolve_device


def _launcher_env():
    """("env://", world size, rank) from torch.distributed.run's variables
    (its agent holds the store the ranks join), or None when they are not
    set."""
    if "MASTER_ADDR" not in os.environ or "RANK" not in os.environ:
        return None
    return "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: DeviceLike = "cuda",
                         backend: Optional[str] = None,
                         timeout_s: Optional[float] = None) -> bool:
    """Join the default process group. Returns False, and does nothing,
    when no address is given or set (a single-process run); True once the
    group is up. On the card, rank r uses card ``LOCAL_RANK`` (or r) modulo
    the cards the host has. ``backend`` overrides the device's default
    (nccl on the card, gloo on the CPU); ``timeout_s`` bounds every
    collective (a peer that died fails the others instead of hanging
    them). A process already in a group stays in it (True)."""
    if dist.is_initialized():
        return True
    launcher = _launcher_env()
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
        if coordinator_address is None and launcher is not None:
            coordinator_address, world, rank = launcher
            num_processes = world if num_processes is None else num_processes
            process_id = rank if process_id is None else process_id
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    kwargs = {} if timeout_s is None else {"timeout": timedelta(
        seconds=timeout_s)}
    dist.init_process_group(
        backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init, world_size=num_processes, rank=process_id,
        **kwargs)
    return True


def local_init_method() -> str:
    """A ``tcp://127.0.0.1`` init method on a free port (a one-process
    group, or ranks spawned on this host)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def global_mesh(data: Optional[int] = None, model: int = 1,
                device_type: str = "cuda"):
    """A ("data", "model") mesh over every process of the group (after
    ``initialize_multihost``). Keep ``model`` within one host, so the
    model axis's collectives stay on its links."""
    from .mesh import make_mesh
    return make_mesh(data=data, model=model, device_type=device_type)
