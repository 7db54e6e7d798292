"""Data parallelism over ``torch.distributed`` (port of ``pda/parallel``)."""

from .mesh import (DATA_AXIS, SPACE_AXIS, Mesh, assert_replicated, get_mesh, get_mesh_2d,
                   replicated, shard_batch)

__all__ = ["DATA_AXIS", "SPACE_AXIS", "Mesh", "assert_replicated", "get_mesh", "get_mesh_2d",
           "replicated", "shard_batch"]
