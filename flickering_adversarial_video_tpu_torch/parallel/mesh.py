"""Data parallelism over ranks: the port's counterpart of the JAX package's
``parallel/mesh.py``.

The JAX package runs one process over a 1-D device mesh (axis ``'data'``):
the batch sharded over it, delta, the victim and Adam's state replicated, and
XLA's psum of d(delta).  The port says the same in PyTorch's own idiom:

* one process per card, launched by ``torchrun`` (``python -m
  torch.distributed.run --nproc-per-node N``), in one ``torch.distributed``
  process group: NCCL on CUDA, gloo on the CPU.  A "mesh of N devices" is a
  group of N ranks (:class:`Mesh`);
* each rank reads its own shards (``tfrecord_batches(host_id=rank,
  num_hosts=W)``), so the global batch is the ranks' batches in rank order,
  as ``jax.make_array_from_process_local_data`` assembles it; delta and the
  victim are whole on every rank (each rank builds the victim from the same
  checkpoint or seed, as each JAX host does);
* the engine sums d(delta) and the batch's statistics over the ranks in one
  collective inside its step (``AttackEngine._step``), before Adam, which
  then runs on every rank alike, so delta and the moments stay equal on
  every rank;
* the vectorized sweeps split the slot axis: each rank runs its share of the
  slots over its share of the videos, with no collective.

A process with no group is world 1: the engine takes today's path, and the
sweeps run every slot.  Nothing falls back: an NCCL group that cannot be made
raises, and so does a rank whose card does not exist.

Host-side agreements (does every rank still have a batch? each rank's
results) go through a gloo group on the CPU, ``Mesh.control``, so that they
never wait for the device; it is the data group itself when that is gloo.

A batch that the ranks do not divide shrinks the mesh, as the JAX runners
shrink theirs (:func:`mesh_size`): ranks [0, d) form it on a subgroup of
their own (``torch.distributed.new_group``, which every rank calls), d = 1
leaves rank 0 without a group, and the ranks from d on are idle
(``Mesh.idle``): they run nothing and wait in :func:`join_world` until the
others end, so that the launcher sees every rank exit.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"  # the axis the batch is split over (the JAX mesh's name)
# how long the idle ranks of a shrunk mesh wait for the run's end
IDLE_WAIT = datetime.timedelta(days=7)
_world_wait: Optional[Any] = None  # the world's gloo group of a shrunk mesh


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of one data-parallel run, and this rank's place in it."""

    group: Optional[Any]     # the data group (dist.ProcessGroup); None: one process
    control: Optional[Any]   # a gloo group for the host's agreements
    rank: int
    world: int               # the mesh's ranks, [0, world)
    device: torch.device     # this rank's device

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    @property
    def idle(self) -> bool:
        """Is this rank outside a shrunk mesh?"""
        return self.rank >= self.world


def world_size() -> int:
    """The number of ranks of this run: the initialized group's, else
    torchrun's ``WORLD_SIZE``, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def launched() -> bool:
    """Is this process a rank of a run: torchrun's environment, or a group
    already joined?"""
    return "WORLD_SIZE" in os.environ or (dist.is_available() and dist.is_initialized())


def initialize_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                           rank: Optional[int] = None, world_size: Optional[int] = None) -> int:
    """Join the run's process group, once per process, and return the rank.

    Under torchrun the group comes from its environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``);
    elsewhere from an explicit `init_method` (``file://`` or ``tcp://``),
    `rank` and `world_size`.  A process with neither has no group (rank 0).
    `backend` None is NCCL when CUDA is available, else gloo.  For NCCL the
    process's current card becomes ``LOCAL_RANK`` (else `rank`), which must
    exist."""
    if dist.is_initialized():
        return dist.get_rank()
    if init_method is None and "WORLD_SIZE" not in os.environ:
        return 0
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else 0))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank with LOCAL_RANK {local} has no card ({torch.cuda.device_count()} visible): "
                "NCCL takes one card a rank; two ranks on one card need backend='gloo' and "
                "eager steps")
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method,
                            rank=-1 if rank is None else rank,
                            world_size=-1 if world_size is None else world_size)
    return dist.get_rank()


def mesh_size(batch: int, world: int) -> int:
    """The ranks a batch of `batch` runs on: the largest count, no more
    than min(`world`, `batch`), that divides it (the JAX runners' device
    count, ``runners/common.py:249-254``)."""
    return next(d for d in range(min(world, batch), 0, -1) if batch % d == 0)


def make_mesh(device=None, size: Optional[int] = None) -> Mesh:
    """This process's mesh over the first `size` ranks (default all): the
    default group (joined from torchrun's environment when there is one) on
    `device` (``resolve_device``: ``cuda:LOCAL_RANK`` under torchrun), or
    world 1 with no group.  A smaller `size` is a collective, as
    ``new_group`` is: every rank calls it; ranks [0, size) get a subgroup
    (none at size 1), the others an idle mesh."""
    global _world_wait
    initialize_distributed()
    dev = resolve_device(device)
    if not dist.is_initialized():
        return Mesh(None, None, 0, 1, dev)
    group = dist.group.WORLD
    backend = dist.get_backend(group)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL group runs on the card, not on {dev}")
    world, rank = dist.get_world_size(), dist.get_rank()
    size = world if size is None else size
    if not 0 < size <= world:
        raise ValueError(f"a mesh of {size} ranks in a world of {world}")
    if size == world:
        _world_wait = None
        control = group if backend == "gloo" else dist.new_group(backend="gloo")
        return Mesh(group, control, rank, world, dev)
    _world_wait = dist.new_group(backend="gloo", timeout=IDLE_WAIT)
    group = control = None
    if size > 1:
        ranks = list(range(size))
        group = dist.new_group(ranks)
        control = group if backend == "gloo" else dist.new_group(ranks, backend="gloo")
    if rank >= size:
        group = control = None
    return Mesh(group, control, rank, size, dev)


def join_world() -> None:
    """Wait until every rank of the world is here, when a shrunk mesh left
    ranks idle: they call it at once, the mesh's ranks at their run's end
    (nothing otherwise)."""
    if _world_wait is not None:
        dist.barrier(group=_world_wait)


def refuse_world(path: str, hint: str) -> None:
    """Raise when this run has more than one rank: `path` has no split over
    ranks and would run the same clips on every rank."""
    w = world_size()
    if w > 1:
        raise ValueError(f"{path} has no split over ranks: each of the {w} ranks would attack "
                         f"the same clips and write the same files; {hint}")


def slot_split(path: str, use_mesh: bool, slots: int) -> bool:
    """Does the per-video `path` split its slots over the ranks (`use_mesh`
    with more than one slot)?  Raises when several ranks would run it
    without that split, and, as the JAX sweep, when the ranks do not divide
    `slots`."""
    split = use_mesh and slots > 1
    if not split:
        refuse_world(f"{path} without --slots N --mesh",
                     "pass --slots (a multiple of the ranks) and --mesh")
    elif slots % world_size():
        raise ValueError(f"slots ({slots}) must be a multiple of the mesh size ({world_size()})")
    return split


def shard_batch(mesh: Optional[Mesh], batch: Any) -> Any:
    """This rank's contiguous slice of a global batch (every leaf's leading
    axis), in rank order: rank r of W holds rows [r B/W, (r+1) B/W)."""
    if mesh is None or mesh.world == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    n = batch.shape[0]
    if n % mesh.world:
        raise ValueError(f"a batch of {n} does not split over {mesh.world} ranks")
    b = n // mesh.world
    return batch[mesh.rank * b:(mesh.rank + 1) * b]


def put_replicated(mesh: Optional[Mesh], tensor: torch.Tensor) -> torch.Tensor:
    """`tensor` on this rank's device holding rank 0's value on every rank
    (a broadcast; the tensor as it is without a group)."""
    if mesh is None or mesh.group is None:
        return tensor
    same = tensor.device.type == mesh.device.type
    out = (tensor if same else tensor.to(mesh.device)).clone(
        memory_format=torch.contiguous_format)
    dist.broadcast(out, 0, group=mesh.group)
    return out


def all_reduce(mesh: Optional[Mesh], tensor: torch.Tensor) -> torch.Tensor:
    """`tensor` summed over the ranks, in place (nothing without a group).
    Inside a captured step this is the graph's collective: the warm-up makes
    the first one, so that NCCL's communicator exists before the capture."""
    if mesh is not None and mesh.group is not None:
        dist.all_reduce(tensor, group=mesh.group)
    return tensor


def all_ranks(mesh: Optional[Mesh], flag: bool) -> bool:
    """Whether `flag` holds on every rank (the host's agreement, on the
    control group; `flag` itself without a group)."""
    if mesh is None or mesh.control is None:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.control)
    return bool(t.item())


def gather_objects(mesh: Optional[Mesh], obj: Any) -> List[Any]:
    """Every rank's `obj` (picklable), in rank order, on every rank."""
    if mesh is None or mesh.control is None:
        return [obj]
    out: List[Any] = [None] * mesh.world
    dist.all_gather_object(out, obj, group=mesh.control)
    return out
