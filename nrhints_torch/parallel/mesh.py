"""Data parallelism over ranks (port of ``nrhints_tpu/parallel/mesh.py``):
one process per card in a ``torch.distributed`` group (NCCL on the card,
gloo on the CPU), the parameters replicated, each rank on its own rows of
the global batch, and every gradient summed by one all-reduce a step, as
the original code's DDP trainer ran, but with the JAX package's global
loss (``train/step.py``).

How the JAX package's layout maps onto ranks:

* one JAX process per host -> one host of ranks: the ranks with the same
  ``rank // LOCAL_WORLD_SIZE``;
* a host's local chips on the ``('data',)`` mesh -> the host's ranks, one
  card each (``cuda:LOCAL_RANK``);
* ``process_index`` / ``process_count`` -> host index / host count;
* ``len(jax.devices())`` -> the world size.

A host draws its batch as a JAX process does (``DataManager(local_rank=
host index)``), and each of its ranks keeps its contiguous block of rows in
rank order (``shard_batch``), which is what JAX's
``make_array_from_process_local_data`` assembles.  ``LOCAL_WORLD_SIZE`` and
``LOCAL_RANK`` come from the environment, as torchrun sets them; without
them every rank is on one host.

JAX's ``shard_rays_call`` has no counterpart: XLA cannot partition a Pallas
call, so JAX runs each kernel under ``shard_map``; here each rank runs the
kernels on its own rows, which is all the partitioning there is.

With ``sample_axis_size`` k > 1 the ranks form JAX's 2-D ``('data',
'sample')`` grid: rank r is device (r // k, r % k) of the (data, k) mesh.
The k ranks of a sample group (one data index) hold the same rows of the
global batch, as JAX replicates the batch over 'sample'; the renderer's
marches split their work over the sample group and all-gather it
(``render/renderer.py``), and the gradients are summed over the data group
(the ranks of one sample index), so each row counts once.  Each group is a
``dist.new_group``, made by every rank in the same order.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from nrhints_torch.utils import tree_items

# Longer than a rank's wait for its slowest peer: a test view's 500-step
# registration, or the main rank's mesh at the final resolution.
DEFAULT_TIMEOUT = timedelta(minutes=30)
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def local_layout(rank: int, world_size: int) -> tuple[int, int]:
    """(local rank, ranks per host) from torchrun's ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE``; without them, one host of ``world_size`` ranks."""
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if per_host < 1 or world_size % per_host:
        raise ValueError(f"LOCAL_WORLD_SIZE={per_host} does not divide the world size {world_size}")
    return int(os.environ.get("LOCAL_RANK", rank % per_host)), per_host


def under_torchrun() -> bool:
    return all(v in os.environ for v in TORCHRUN_ENV)


def initialize_multihost(init_method: Optional[str] = None, rank: Optional[int] = None,
                         world_size: Optional[int] = None, *, device="cuda", backend: Optional[str] = None,
                         timeout: timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the process group (the JAX package's ``jax.distributed.initialize``).

    With no ``init_method``, from torchrun's environment (``env://``:
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``); else from
    the given rendezvous, rank and world size (spawned workers, tests).
    ``backend``: NCCL on the card and gloo on the CPU unless named.  On the
    card each rank binds ``cuda:LOCAL_RANK``."""
    if init_method is None:
        missing = [v for v in TORCHRUN_ENV if v not in os.environ]
        if missing:
            raise ValueError(f"initialize_multihost: no rendezvous given and torchrun's {missing} are not set")
        init_method, rank, world_size = "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {}
    if dev.type == "cuda":
        local_rank, _ = local_layout(rank, world_size)
        if local_rank >= torch.cuda.device_count():
            raise ValueError(f"rank {rank} wants cuda:{local_rank}; {torch.cuda.device_count()} card(s) visible")
        torch.cuda.set_device(local_rank)
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", local_rank)  # the communicator is made now, not in a capture
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size, timeout=timeout,
                            **kw)


@dataclass(frozen=True)
class DataMesh:
    """This rank's place in the data-parallel group.  ``backend`` is None
    where there is no process group (one rank: the single-device step).
    With ``sample_axis_size`` k > 1, the (data, k) grid: ``sample_group``
    holds the k ranks of this rank's data index, ``data_group`` the ranks
    of its sample index (both None where k is 1: the whole group serves)."""

    rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    device: torch.device
    backend: Optional[str] = None
    sample_axis_size: int = 1
    sample_group: Any = field(default=None, compare=False, repr=False)
    data_group: Any = field(default=None, compare=False, repr=False)

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    @property
    def data_size(self) -> int:
        """Ranks on the 'data' axis: the batch's row blocks."""
        return self.world_size // self.sample_axis_size

    @property
    def data_index(self) -> int:
        return self.rank // self.sample_axis_size

    @property
    def sample_index(self) -> int:
        return self.rank % self.sample_axis_size

    @property
    def host_data_rows(self) -> int:
        """Row blocks of a host's batch: its ranks' data indices (one where a
        sample group spans several hosts)."""
        return max(1, self.local_world_size // self.sample_axis_size)

    @property
    def draw_index(self) -> int:
        """The host batch this rank's host draws (``DataManager``'s
        ``local_rank``): the host index, or where a sample group spans
        hosts, the data index, so the hosts of one group draw alike."""
        return self.host_index * self.local_world_size // self.sample_axis_size // self.host_data_rows

    @property
    def draw_count(self) -> int:
        """Distinct host batches: the global batch splits into this many."""
        return self.data_size // self.host_data_rows

    @property
    def host_index(self) -> int:
        return self.rank // self.local_world_size

    @property
    def host_count(self) -> int:
        return self.world_size // self.local_world_size

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def comm_device(self) -> torch.device:
        """Where a host-side collective's tensors go: the card under NCCL,
        else the CPU."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def make_mesh(data_axis_size: int = -1, *, sample_axis_size: int = 1, device="cpu") -> DataMesh:
    """The ``('data',)`` axis over every rank of the group (one rank where
    no group was joined), or with ``sample_axis_size`` k > 1 the (data, k)
    grid of JAX's ``make_mesh``: rank r at (r // k, r % k).
    ``data_axis_size``: -1 for the world size (with k, the world size // k),
    else it must give a grid of exactly the group's ranks; a grid larger
    than the group raises ``ValueError`` as JAX's does for one larger than
    its devices (so does one smaller: one rank a device, none idle).
    ``device``: "cpu", or "cuda" for this rank's card.  With k > 1 every
    rank makes the sample groups, then the data groups, in order."""
    if dist.is_initialized():
        rank, world, backend = dist.get_rank(), dist.get_world_size(), dist.get_backend()
    else:
        rank, world, backend = 0, 1, None
    k = sample_axis_size
    if k < 1:
        raise ValueError(f"sample_axis_size must be at least 1, got {k}")
    data = (world // k if data_axis_size == -1 else data_axis_size)
    if k == 1 and data != world:
        raise ValueError(f"data_axis_size {data_axis_size} != the world size {world}: one rank a device, every rank "
                         f"on the 'data' axis")
    if k > 1 and (data < 1 or data * k != world):
        raise ValueError(f"a {data}x{k} ('data', 'sample') grid needs {max(data, 1) * k} ranks; the group has "
                         f"{world}: one rank a device, every rank on the grid")
    local_rank, per_host = local_layout(rank, world)
    if k > 1 and per_host % k and k % per_host:
        raise ValueError(f"{per_host} ranks a host and sample_axis_size {k}: one must divide the other")
    dev = torch.device(device)
    if dev.type == "cuda" and backend is not None:
        dev = torch.device("cuda", local_rank)
    groups = {}
    if k > 1:
        for i in range(data):
            g = dist.new_group([i * k + j for j in range(k)])
            if i == rank // k:
                groups["sample_group"] = g
        for j in range(k):
            g = dist.new_group([i * k + j for i in range(data)])
            if j == rank % k:
                groups["data_group"] = g
    return DataMesh(rank, world, local_rank, per_host, dev, backend, k, **groups)


def shard_batch(mesh: Optional[DataMesh], batch, batch_axis: int = 0):
    """This rank's contiguous block of a host batch (a tensor or a
    ``PixelBundle``), in the host's data order along ``batch_axis`` (1 for
    a stacked [K, rays, ...] batch): the k ranks of a sample group take the
    same block."""
    if mesh is None or mesh.host_data_rows == 1:
        return batch
    n = (batch if isinstance(batch, torch.Tensor) else batch.h_indices).shape[batch_axis]
    parts = mesh.host_data_rows
    if n % parts:
        raise ValueError(f"a host batch of {n} rays does not split over {parts} ranks")
    per, local = n // parts, mesh.local_rank // mesh.sample_axis_size
    idx = (slice(None),) * batch_axis + (slice(local * per, (local + 1) * per),)

    def rows(x):
        return None if x is None else x[idx].contiguous()

    if isinstance(batch, torch.Tensor):
        return rows(batch)
    return dataclasses.replace(batch, **{f.name: rows(getattr(batch, f.name)) for f in dataclasses.fields(batch)})


def rank_rows(mesh: DataMesh, n_local: int) -> slice:
    """This rank's rows of a global batch of ``n_local * data_size`` rays
    (those of its data index)."""
    return slice(mesh.data_index * n_local, (mesh.data_index + 1) * n_local)


@torch.no_grad()
def replicate(mesh: Optional[DataMesh], tree):
    """Every leaf of a nested dict of tensors broadcast from rank 0, in
    place (JAX's ``replicate``) -> the tree."""
    if mesh is not None and mesh.distributed:
        for _, t in tree_items(tree):
            dist.broadcast(t, src=0)
    return tree


def all_reduce_grads(tensors: list, group=None) -> None:
    """Sum ``tensors`` over ``group``'s ranks (the whole group by default)
    in place through one flat f32 buffer: one all-reduce, which a CUDA
    graph can hold.  Every rank gets the same bytes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()


def all_reduce_scalar(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of a 0-d tensor over ``group``'s ranks, as a new tensor."""
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def sample_all_gather(mesh: DataMesh, t: torch.Tensor) -> torch.Tensor:
    """[k * rows, ...]: ``t`` of every rank of this rank's sample group,
    stacked along the first axis in sample order (one
    ``all_gather_into_tensor``, which a CUDA graph can hold under NCCL)."""
    t = t.contiguous()
    out = torch.empty((mesh.sample_axis_size * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=mesh.sample_group)
    return out


def all_gather_object_or_array(mesh: Optional[DataMesh], x):
    """Every rank's ``x``, in rank order: a numpy array of the same shape
    and dtype on every rank -> stacked [world, ...]; any other picklable
    object -> a list.  Without a process group, ``x`` as the one rank's."""
    if mesh is None or not mesh.distributed:
        return x[None] if isinstance(x, np.ndarray) else [x]
    if not isinstance(x, np.ndarray):
        out = [None] * mesh.world_size
        dist.all_gather_object(out, x)
        return out
    t = torch.from_numpy(np.ascontiguousarray(x)).to(mesh.comm_device)
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t)
    return np.stack([p.cpu().numpy() for p in parts])


def broadcast_object(mesh: Optional[DataMesh], obj):
    """Rank 0's ``obj`` on every rank."""
    if mesh is None or not mesh.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier(mesh: Optional[DataMesh]) -> None:
    if mesh is not None and mesh.distributed:
        dist.barrier()
