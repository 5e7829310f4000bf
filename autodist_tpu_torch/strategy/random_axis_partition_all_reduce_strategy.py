"""RandomAxisPartitionAR: partition along a random eligible axis
(counterpart of ``autodist_tpu/strategy/random_axis_partition_all_reduce_strategy.py``).

:func:`get_num_shards_and_axis` draws the axis among the dimensions > 1
(dim 0 for a sparse variable) from the builder's own
``random.Random(seed)``, in ``var_infos`` order, so a seed gives the JAX
builder's axes; the count is that dimension's smallest divisor > 1.
"""
import random

from autodist_tpu_torch.strategy.partitioned_all_reduce_strategy import PartitionedAR
from autodist_tpu_torch.strategy.partitioned_ps_strategy import get_num_shards


def get_num_shards_and_axis(shape, max_shards, rng, sparse=False):
    """(shard count, axis) of a variable of ``shape``, the axis drawn by
    ``rng``."""
    if not shape:
        return 1, 0
    if sparse:
        return get_num_shards(shape[0], max_shards), 0
    eligible = [i for i, d in enumerate(shape) if d > 1]
    if not eligible:
        return 1, 0
    axis = rng.choice(eligible)
    return get_num_shards(shape[axis], max_shards), axis


class RandomAxisPartitionAR(PartitionedAR):
    def __init__(self, chunk_size=128, all_reduce_spec="AUTO", compressor="NoneCompressor",
                 max_shards=None, seed=10000):
        super().__init__(chunk_size, all_reduce_spec, compressor, max_shards)
        self._rng = random.Random(seed)

    def _shards_for(self, v, num_devices):
        cap = self._max_shards or num_devices
        return get_num_shards_and_axis(v.shape, cap, self._rng, v.sparse)
