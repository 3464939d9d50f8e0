"""Data parallelism over torch.distributed ranks (the JAX package's device mesh)."""

from .mesh import (DATA_AXIS, Mesh, all_ranks, all_reduce, gather_objects,
                   initialize_distributed, launched, make_mesh, put_replicated, refuse_world,
                   shard_batch, slot_split, world_size)
