"""Data-parallel layout over ``torch.distributed`` ranks.

PyTorch counterpart of ``varnet_tpu/parallel/mesh.py``.  The JAX package puts
one ``Mesh`` with a ``data`` axis over every chip and shards the test-function
axis of the fixed data over it; here each process (rank) owns one device and
holds only its own contiguous block of that axis: the block that JAX's
``P("data")`` gives shard ``rank``.  Parameters are replicated (broadcast from
rank 0), and the one gradient reduction per step is a ``dist.all_reduce`` of a
single packed tensor.  Weak residuals are local to each test function's
support, so no other axis is needed.

A :class:`Mesh` with ``group=None`` is one process with no collective at all:
every reduction below is then the identity.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.mlp import tree_map


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def default_device() -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` when CUDA is available, else
    the CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cpu")


def initialize_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> int:
    """Join the default process group (``torch.distributed.init_process_group``)
    and return its world size.

    With no arguments the group comes from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); without that
    environment this is a no-op that returns 1, so callers can invoke it
    unconditionally (the JAX package's single-host behaviour).  ``backend``
    defaults to ``"nccl"`` when CUDA is available and ``"gloo"`` otherwise;
    name ``"gloo"`` to run several ranks on one GPU (NCCL refuses that).  An
    already initialized group is kept.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    if init_method is None and world_size is None and "WORLD_SIZE" not in os.environ:
        return 1
    if backend is None:
        backend = _backend_for(default_device())
    kwargs = {} if init_method is None else {"init_method": init_method}
    if world_size is not None:
        kwargs["world_size"] = int(world_size)
    if rank is not None:
        kwargs["rank"] = int(rank)
    dist.init_process_group(backend=backend, **kwargs)
    return dist.get_world_size()


@dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel layout: ``n_shards`` ranks,
    its ``rank``, the process ``group`` (None: a single process, no
    collective) and the ``device`` its shard lives on."""

    n_shards: int
    rank: int
    group: Any
    device: torch.device

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh over the initialized default group (every rank), or a
    one-process mesh without one.  ``n_devices`` None takes the group's world
    size (the JAX package's "all devices"); another value must equal it.
    ``device`` defaults to :func:`default_device`."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and int(n_devices) != world:
        where = ("the initialized process group's world size" if dist.is_initialized()
                 else "the world size without a process group (initialize_distributed "
                      "under torchrun first)")
        raise ValueError(f"n_devices={int(n_devices)} does not match {where}, {world}")
    device = default_device() if device is None else torch.device(device)
    if not dist.is_initialized():
        return Mesh(1, 0, None, device)
    return Mesh(world, dist.get_rank(), dist.group.WORLD, device)


def shard_rows(a, mesh: Mesh, axis: int = 0) -> np.ndarray:
    """This rank's contiguous block of ``a`` along ``axis`` (host arrays; the
    axis must divide by ``n_shards``: pad first)."""
    a = np.asarray(a)
    n = a.shape[axis]
    if n % mesh.n_shards:
        raise ValueError(f"axis {axis} of length {n} does not divide into "
                         f"{mesh.n_shards} shards; pad to a multiple first")
    size = n // mesh.n_shards
    return np.take(a, np.arange(mesh.rank * size, (mesh.rank + 1) * size), axis=axis)


def _placer(mesh: Mesh, dtype, axis: Optional[int]):
    def place(a):
        if a is None:
            return None
        a = np.asarray(a) if axis is None else shard_rows(a, mesh, axis)
        if dtype is not None:
            a = np.array(a, dtype=torch.empty(0, dtype=dtype).numpy().dtype)
        return torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)

    return place


def shard_quad(quad, mesh: Mesh, dtype=None, batched: bool = False):
    """A QuadData of host arrays as tensors on this rank's device: the
    per-test-function arrays as its block, the shared [nQ] tables (N, dN, w)
    whole, unless they are per-node tables (``quad.tables_per_node``), which
    shard with their test functions.  ``batched=True`` for the mini-batch
    layout [B, Kb, ...], whose axis 1 shards."""
    axis = 1 if batched else 0
    rows = _placer(mesh, dtype, axis)
    tables = rows if quad.tables_per_node else _placer(mesh, dtype, None)
    return type(quad)(
        coords=rows(quad.coords), N=tables(quad.N), dN=tables(quad.dN), w=tables(quad.w),
        kappa=rows(quad.kappa), vel=rows(quad.vel), src=rows(quad.src),
        react=rows(quad.react), mask=rows(quad.mask))


def shard_points(points, mesh: Mesh, dtype=None):
    """A PointData (BC / IC / observation rows) or a FluxData (Neumann / Robin
    rows): every array by axis 0."""
    return type(points)(*(_placer(mesh, dtype, 0)(a) for a in points))


shard_flux = shard_points   # the JAX package's name for the flux rows


def shard_hard(hard, mesh: Mesh, dtype=None, batched: bool = False):
    """The exact-BC tables ``(HardQuad, HardPts or None, HardQuad or None)``
    at the quad, observation and flux coords: each array by its leading K / N
    axis (None leaves stay None); ``batched=True`` when the quad tables are in
    the mini-batch layout [B, Kb, ...] (axis 1 shards), the observation and
    flux tables staying full-batch like their rows."""
    hq, hpts, hflux = hard

    def put(tables, axis):
        if tables is None:
            return None
        return type(tables)(*(_placer(mesh, dtype, axis)(a) for a in tables))

    return put(hq, 1 if batched else 0), put(hpts, 0), put(hflux, 0)


def replicate(tree, mesh: Mesh):
    """A copy of a tree of tensors on this rank's device, rank 0's values on
    every rank (one ``broadcast`` per leaf; none without a group)."""
    def leaf(t):
        t = torch.as_tensor(t).detach().to(mesh.device, copy=True)
        if mesh.distributed:
            dist.broadcast(t, src=0, group=mesh.group)
        return t

    return tree_map(leaf, tree)


def all_reduce_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``t`` summed over the ranks, in place (one ``dist.all_reduce``); the
    identity without a group."""
    if mesh is not None and mesh.distributed:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank (a no-op without a group)."""
    if mesh is not None and mesh.distributed:
        dist.barrier(group=mesh.group)
