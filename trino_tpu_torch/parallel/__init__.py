"""The device mesh: shards of one process on its cards, and the copies
between them (counterpart of ``trino_tpu/parallel``)."""

from .mesh import (Mesh, ShardedBatch, get_mesh,  # noqa: F401
                   shard_batch, shard_parts, unshard_batch)
from .spmd import (broadcast_sharded,  # noqa: F401
                   distributed_group_aggregate, repartition_by_hash)
