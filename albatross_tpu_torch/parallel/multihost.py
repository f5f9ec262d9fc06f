"""Multi-process orchestration helpers.

Counterpart of ``albatross_tpu.parallel.multihost``: where the JAX package
joins ``jax.distributed``, the port joins a ``torch.distributed`` process
group, from the environment ``torchrun`` sets (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) or from explicit arguments.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group (no-op when one is already initialized, or
    for a single-process run).

    Without arguments the ``torchrun`` environment decides;
    ``coordinator_address`` ("host:port") with ``num_processes`` and
    ``process_id`` joins explicitly.  The backend is NCCL with a GPU and
    gloo without one, unless ``backend`` names another."""
    if dist.is_initialized():
        return
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return  # single process: nothing to join
    if process_id is None:
        process_id = int(os.environ["RANK"])
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend or ("nccl" if torch.cuda.is_available() else "gloo"),
                            init_method=init, world_size=num_processes, rank=process_id)


def global_mesh(axis_names: Sequence[str] = ("data",), shape=None, device=None):
    """Mesh over every rank of the world (call after initialize_multihost)."""
    from .mesh import make_mesh

    return make_mesh(None, axis_names, shape, device)


def process_local_batch(global_batch_size: int) -> int:
    """Rows this process contributes to a globally sharded batch."""
    count = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch_size % count != 0:
        raise ValueError(f"global batch {global_batch_size} not divisible by {count} processes")
    return global_batch_size // count
