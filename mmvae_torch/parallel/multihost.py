"""Multi-process runs (port of ``mmvae_tpu/parallel/multihost.py``).

One process a card, joined in a ``torch.distributed`` process group:

* :func:`initialize` -- the group's bring-up, from explicit arguments,
  JAX's trio ``MMVAE_COORDINATOR`` / ``MMVAE_NUM_PROCESSES`` /
  ``MMVAE_PROCESS_ID``, or torchrun's ``RANK`` / ``WORLD_SIZE`` /
  ``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``. It never falls back to
  one process: a group that cannot form raises.
* :func:`is_primary` -- the gate of host-side writes (the config, the
  metrics, the checkpoints): exactly one process writes.
* :func:`process_count`, :func:`fetch_replicated` (the identity: DP state
  is a full copy on every rank) and :func:`sync` (a barrier).
"""

from __future__ import annotations

import os
from typing import Any

import torch
import torch.distributed as dist

__all__ = [
    "initialize",
    "is_primary",
    "process_count",
    "process_index",
    "fetch_replicated",
    "sync",
]

def _env_int(name: str) -> int | None:
    return int(os.environ[name]) if name in os.environ else None


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
) -> None:
    """Bring up the process group (idempotent: a second call returns).

    The address (``host:port``), the world size and this process's rank
    come from the arguments, else from ``MMVAE_COORDINATOR`` /
    ``MMVAE_NUM_PROCESSES`` / ``MMVAE_PROCESS_ID``, else from torchrun's
    ``MASTER_ADDR:MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``; what none of
    them gives raises ``RuntimeError``. ``backend`` defaults to ``"nccl"``
    where CUDA is available and ``"gloo"`` elsewhere. Under NCCL the rank's
    device is ``cuda:{LOCAL_RANK}`` (the rank without ``LOCAL_RANK``), made
    the current device before the group forms.
    """
    if dist.is_initialized():
        return
    addr = coordinator_address or os.environ.get("MMVAE_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("MMVAE_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("MMVAE_PROCESS_ID")
    if addr is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    missing = [name for name, v in (("coordinator address", addr),
                                    ("number of processes", num_processes),
                                    ("process id", process_id)) if v is None]
    if missing:
        raise RuntimeError(
            f"multihost.initialize: no {', '.join(missing)}; pass them, or set "
            "MMVAE_COORDINATOR/MMVAE_NUM_PROCESSES/MMVAE_PROCESS_ID or torchrun's "
            "MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not a rank of {num_processes}")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    bound = {}
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a card")
        local_rank = _env_int("LOCAL_RANK")
        device = torch.device("cuda", process_id if local_rank is None else local_rank)
        torch.cuda.set_device(device)
        bound = {"device_id": device}  # NCCL bound to the card forms its communicator eagerly
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=num_processes,
                            rank=process_id, **bound)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on exactly one process (the host-side writer): rank 0, or the
    one process of a run without a group."""
    return process_index() == 0


def fetch_replicated(tree: Any) -> Any:
    """The process-local value of replicated state: DP parameters are a full
    copy on every rank already, so this is the identity."""
    return tree


def sync() -> None:
    """A barrier across the processes (nothing without a group or at one
    process)."""
    if process_count() > 1:
        dist.barrier()
