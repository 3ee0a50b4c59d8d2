"""Multi-process initialization.

The port of ``fdoct_tpu/parallel/distributed.py``.  The JAX package joins
hosts with ``jax.distributed``; PyTorch runs one process per device and joins
them with ``torch.distributed``: every process runs the same program, owns
one device and its block of each batch, and the collectives of
:mod:`fdoct_tpu_torch.parallel.sharded` span the world.  ``torchrun
--nproc-per-node N python -m fdoct_tpu_torch ...`` starts such a world and
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` for :func:`initialize_multihost`.  A world of one process
(:class:`WorldOfOne`) needs no launcher: it is how a 1 × 1 mesh runs.
"""

from __future__ import annotations

import os
import tempfile

import torch.distributed as dist

#: the process-group backend of each device type: nccl between cards, gloo on
#: the CPU.  A mesh never runs one device type's tensors on the other's backend.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device_type: str) -> str:
    """The backend of :data:`BACKENDS` for ``device_type``."""
    try:
        return BACKENDS[device_type]
    except KeyError:
        raise ValueError(f"no process-group backend for device type {device_type!r}; "
                         f"one of {sorted(BACKENDS)}") from None


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str = "nccl") -> bool:
    """Initialize the default process group when running multi-process.

    With no arguments the world comes from the environment: the process count
    from ``FDOCT_NUM_PROCESSES`` (as in the JAX package) or torchrun's
    ``WORLD_SIZE``, the rank from ``RANK``, the rendezvous from
    ``MASTER_ADDR``/``MASTER_PORT``.  ``coordinator`` ("host:port") names the
    rendezvous instead.  Returns True when it initialized the group, False
    for a single-process run (a no-op, so the same entry points work at
    n = 1)."""
    if num_processes is None:
        num_processes = int(os.environ.get("FDOCT_NUM_PROCESSES",
                                           os.environ.get("WORLD_SIZE", "1")))
    if num_processes <= 1 and coordinator is None:
        return False
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    init = f"tcp://{coordinator}" if coordinator is not None else "env://"
    dist.init_process_group(backend, init_method=init, world_size=num_processes, rank=rank)
    return True


class WorldOfOne:
    """The default process group as a world of one process (rank 0 of 1) on
    ``device_type``'s backend, over a ``FileStore`` in a fresh temporary
    directory: no launcher and no port.  :meth:`close` (or leaving a ``with``
    block) destroys the group and removes the directory."""

    def __init__(self, device_type: str):
        self._dir = tempfile.TemporaryDirectory(prefix="fdoct_world_")
        store = dist.FileStore(os.path.join(self._dir.name, "store"), 1)
        dist.init_process_group(backend_for(device_type), store=store, rank=0, world_size=1)

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()
        self._dir.cleanup()

    def __enter__(self) -> "WorldOfOne":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
