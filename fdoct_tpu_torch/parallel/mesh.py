"""Device-mesh construction and the collectives the mesh steps use.

The port of ``fdoct_tpu/parallel/mesh.py``.  A JAX mesh is a grid of the
devices one controller drives; here it is a
``torch.distributed.device_mesh.DeviceMesh`` over the processes of the
default group, one device each, with the axes ``('data', 'ascan')``.  Each
rank holds only its block of a batch, so the collectives that JAX inserts for
``psum``, ``pmin``/``pmax`` and ``all_gather`` are explicit calls here, made
through :func:`all_reduce` and :func:`all_gather`.  They count the bytes they
hand to each collective in :data:`COLLECTIVE_BYTES` (with the halo sends of
``sharded``), the counterpart of the HLO accounting of the JAX package's
scaling harness (``scripts/bench_scaling.collective_bytes``).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from fdoct_tpu_torch.parallel.distributed import backend_for

#: the mesh axes: frames (data parallelism) × lateral A-scan rows
AXES = ("data", "ascan")

#: bytes this process has handed to collectives since the last reset:
#: ``all_reduce`` its input, ``all_gather`` the gathered result (as the HLO
#: accounting counts a result shape), ``send`` the halo rows it sent to its
#: 'ascan' neighbours
COLLECTIVE_BYTES = {"all_reduce": 0, "all_gather": 0, "send": 0}


def reset_collective_bytes() -> None:
    for name in COLLECTIVE_BYTES:
        COLLECTIVE_BYTES[name] = 0


def nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def make_mesh(n_data: int | None = None, n_ascan: int | None = None,
              devices=None, device_type: str = "cuda") -> DeviceMesh:
    """A ('data', 'ascan') mesh over the initialized default process group.

    Default: every rank on 'data' (frame parallelism); pass ``n_ascan`` to
    give ranks to the lateral A-scan axis of each B-scan.  ``devices``: the
    global ranks the mesh spans, in mesh order (default: the whole world;
    every rank of the world calls this).  ``n_data * n_ascan`` must be
    their count.  ``device_type`` is explicit: 'cuda' takes the nccl backend
    and makes ``cuda:{LOCAL_RANK}`` this process's card, 'cpu' takes gloo; a
    process group on another backend is an error, never switched."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: run under torchrun and "
                           "call initialize_multihost(), or open a WorldOfOne(device_type)")
    backend = backend_for(device_type)
    if dist.get_backend() != backend:
        raise ValueError(f"a {device_type} mesh needs the {backend} backend; the process group "
                         f"runs {dist.get_backend()}")
    ranks = list(range(dist.get_world_size()) if devices is None else devices)
    n = len(ranks)
    if n_data is None and n_ascan is None:
        n_data, n_ascan = n, 1
    elif n_data is None:
        n_data = n // n_ascan
    elif n_ascan is None:
        n_ascan = n // n_data
    if n_data * n_ascan != n:
        raise ValueError(f"mesh {n_data}x{n_ascan} != {n} devices")
    if device_type == "cuda":
        torch.cuda.set_device(_local_rank())
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(n_data, n_ascan),
                      mesh_dim_names=AXES)


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` on a 'cuda' mesh, the CPU on
    a 'cpu' mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", _local_rank())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh.get_local_rank(axis)


def all_reduce(x: torch.Tensor, op, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``x`` reduced with ``op`` over ``axis``, in place; returns ``x``."""
    dist.all_reduce(x, op, group=mesh.get_group(axis))
    COLLECTIVE_BYTES["all_reduce"] += nbytes(x)
    return x


def all_reduce_minmax(lo: torch.Tensor, hi: torch.Tensor,
                      group) -> tuple[torch.Tensor, torch.Tensor]:
    """(min of ``lo``, max of ``hi``) elementwise over the process group
    ``group``, as one MAX all-reduce of (−lo, hi): JAX's pmin + pmax in one
    collective (negation is exact)."""
    both = torch.stack([-lo, hi])
    dist.all_reduce(both, dist.ReduceOp.MAX, group=group)
    COLLECTIVE_BYTES["all_reduce"] += nbytes(both)
    return -both[0], both[1]


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The blocks ``x`` of every rank on ``axis``, stacked in axis order:
    (axis size, *x.shape)."""
    n = axis_size(mesh, axis)
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))       # the blocks end to end
    dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.get_group(axis))
    COLLECTIVE_BYTES["all_gather"] += nbytes(out)
    return out.view(n, *x.shape)
