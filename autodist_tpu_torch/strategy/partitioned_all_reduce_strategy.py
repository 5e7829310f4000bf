"""PartitionedAR: partition each variable, then all-reduce its shards
(counterpart of ``autodist_tpu/strategy/partitioned_all_reduce_strategy.py``).

Dense variable ``v`` splits on the axis and into the count
:meth:`PartitionedAR._shards_for` gives (dim 0 and its smallest divisor
> 1 up to ``max_shards``); each shard's ``part_config`` node is an
AllReduce node of the next bucket group.  Sparse and unsplit variables
get one AllReduce node.  The engine realises a partitioned variable as
SHARDED storage (:mod:`autodist_tpu_torch.kernel.partitioner`).
"""
from autodist_tpu_torch.proto import schema
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.base import Strategy
from autodist_tpu_torch.strategy.partitioned_ps_strategy import get_num_shards


class PartitionedAR(AllReduce):
    def __init__(self, chunk_size=128, all_reduce_spec="AUTO", compressor="NoneCompressor",
                 max_shards=None, schedule="barrier", hierarchy="auto",
                 dcn_compressor=None):
        super().__init__(chunk_size, all_reduce_spec, compressor, schedule=schedule,
                         hierarchy=hierarchy, dcn_compressor=dcn_compressor)
        self._max_shards = max_shards

    def _shards_for(self, v, num_devices):
        """(shard count, axis) of ``v``."""
        cap = self._max_shards or num_devices
        return get_num_shards(v.shape[0] if v.shape else None, cap), 0

    def build(self, model_item, resource_spec):
        s = Strategy()
        self.make_graph_config(s.proto, resource_spec)
        num_devices = max(1, resource_spec.num_accelerators)
        idx = 0
        for v in model_item.var_infos:
            if not v.trainable:
                continue
            k, axis = self._shards_for(v, num_devices)
            if k <= 1 or v.sparse:
                s.node_config.append(self._node(v, idx // self.chunk_size))
                idx += 1
                continue
            partition = [1] * len(v.shape)
            partition[axis] = k
            s.node_config.append(schema.Node(
                var_name=v.name, sparse=v.sparse, partition=partition,
                part_config=[self._node(v, (idx + i) // self.chunk_size, f"{v.name}/part_{i}")
                             for i in range(k)]))
            idx += k
        return s
