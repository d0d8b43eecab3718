"""Process-group start-up for DP x TP runs (port of
`parallel/distributed.py`).

One process per rank, as torchrun launches them: every rank runs the same
host loop (SPMD). `initialize_distributed` reads either launcher's
environment and is a no-op for one process. The backend follows the
topology, never a failure: NCCL when every local rank has a card of its
own, gloo when ranks share a card or run on the CPU (gloo carries CUDA
tensors for `all_reduce` and `broadcast`, the only collectives the
sharded paths issue on the card; each one is staged through the host).
The process group gets a timeout, so a collective that one rank never
joins fails instead of hanging.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
_timeout_s = DEFAULT_TIMEOUT_S  # the joined group's, for group_timeout_s


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def local_rank() -> int:
    """This process's rank on its host (torchrun's LOCAL_RANK; else the
    global rank, one host)."""
    r = _env_int("LOCAL_RANK")
    if r is not None:
        return r
    return dist.get_rank() if dist.is_initialized() else 0


def local_device() -> torch.device:
    """The rank's device: cuda:{LOCAL_RANK % device_count} on a card, else
    the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def choose_backend(local_world_size: int) -> str:
    """NCCL when each local rank has a card of its own, else gloo (ranks
    sharing a card, or the CPU: NCCL refuses two ranks on one card)."""
    if torch.cuda.is_available() and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the process group; a no-op for one process or when already
    joined.

    The arguments default from JAX's variables (COORDINATOR_ADDRESS
    "host:port", NUM_PROCESSES, PROCESS_ID) or torchrun's (MASTER_ADDR /
    MASTER_PORT, WORLD_SIZE, RANK). On a card the rank's device is made
    current (`local_device`) first, as NCCL's object collectives need.
    """
    if dist.is_initialized():
        return
    if num_processes is None:
        num_processes = _env_int("NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("PROCESS_ID", "RANK")
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes in (None, 1):
        return  # one process: nothing to join
    if process_id is None:
        raise ValueError(f"{num_processes} processes but no rank: set RANK "
                         "(torchrun) or PROCESS_ID, or pass process_id")
    if coordinator_address is not None:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    elif os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        init_method = "env://"
    else:
        raise ValueError(f"{num_processes} processes but no rendezvous: set "
                         "MASTER_ADDR/MASTER_PORT (torchrun) or "
                         "COORDINATOR_ADDRESS, or pass coordinator_address")
    local_world = _env_int("LOCAL_WORLD_SIZE") or num_processes
    if backend is None:
        backend = choose_backend(local_world)
    if torch.cuda.is_available():
        torch.cuda.set_device(local_device())
    global _timeout_s
    _timeout_s = float(timeout_s)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if process_id == 0:
        print(f"distributed: {num_processes} ranks, backend {backend} "
              f"({local_world} local ranks, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " cards)", flush=True)


def group_timeout_s() -> float:
    """The collective timeout that `initialize_distributed` gave the
    process group (DEFAULT_TIMEOUT_S for a group joined otherwise)."""
    return _timeout_s


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def launched_ranks() -> int:
    """The ranks of this launch: the process group's size once joined, else
    what the launcher's environment says (1 outside torchrun)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return _env_int("WORLD_SIZE", "NUM_PROCESSES") or 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Rank 0 (or the only process): the one that prints and writes."""
    return rank() == 0


def local_batch_slice(global_batch: int, mesh=None) -> slice:
    """This rank's rows of a batch split over the mesh's data axis (the
    whole batch without a mesh). Raises on a batch the axis does not
    divide."""
    from .mesh import AXIS_DATA, axis_rank, axis_size

    n, i = axis_size(mesh, AXIS_DATA), axis_rank(mesh, AXIS_DATA)
    per = global_batch // n
    if per * n != global_batch:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} data ranks")
    return slice(i * per, (i + 1) * per)
