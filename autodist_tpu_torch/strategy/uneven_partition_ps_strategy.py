"""UnevenPartitionedPS: uneven shard counts (counterpart of
``autodist_tpu/strategy/uneven_partition_ps_strategy.py``).

The shard count is the smallest integer > 1 that does not divide dim 0
(:func:`get_uneven_num_shards`); the engine pads the axis to a multiple of
the replicas, so the padding rows carry zero gradients.
"""
from autodist_tpu_torch.strategy.partitioned_ps_strategy import PartitionedPS


def get_uneven_num_shards(dim0, max_shards):
    """The smallest integer > 1 up to ``max_shards`` that does not divide
    ``dim0``; 1 when ``dim0 <= 2`` or there is none."""
    if dim0 is None or dim0 <= 2:
        return 1
    for k in range(2, min(dim0, max_shards) + 1):
        if dim0 % k != 0:
            return k
    return 1


class UnevenPartitionedPS(PartitionedPS):
    def _num_shards(self, v, num_anchors, num_accelerators):
        cap = self._max_shards or max(num_anchors, num_accelerators)
        return get_uneven_num_shards(v.shape[0] if v.shape else None, cap)
