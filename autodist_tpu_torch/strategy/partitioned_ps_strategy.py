"""PartitionedPS: shard large variables over the PS anchors (counterpart
of ``autodist_tpu/strategy/partitioned_ps_strategy.py``).

Each variable's shard count is the smallest divisor > 1 of its dim 0, up
to ``max_shards`` (:func:`get_num_shards`); a variable of more than one
shard gets ``partition = [k, 1, ...]`` and one ``part_config`` node a
shard, each placed on the least-loaded anchor, the others one PS node as
:class:`PSLoadBalancing` places them.  The engine realises a partitioned
variable as SHARDED storage over every replica, its dim 0 padded to a
multiple of R (:mod:`autodist_tpu_torch.kernel.partitioner`): the shard
count stays metadata, as in JAX.
"""
from autodist_tpu_torch.proto import schema
from autodist_tpu_torch.strategy.base import Strategy
from autodist_tpu_torch.strategy.ps_lb_strategy import PSLoadBalancing, byte_size_load_fn


def get_num_shards(dim0, max_shards):
    """The smallest divisor > 1 of ``dim0`` up to ``max_shards``; 1 when
    ``dim0 <= 1`` or it has none there."""
    if dim0 is None or dim0 <= 1:
        return 1
    for k in range(2, min(dim0, max_shards) + 1):
        if dim0 % k == 0:
            return k
    return 1


class PartitionedPS(PSLoadBalancing):
    def __init__(self, local_proxy_variable=False, sync=True, staleness=0,
                 max_shards=None, ps_axes=None):
        super().__init__(local_proxy_variable, sync, staleness, ps_axes=ps_axes)
        self._max_shards = max_shards

    def _num_shards(self, v, num_anchors, num_accelerators):
        # capped at the anchors or the accelerators, whichever is more,
        # unless max_shards is given
        cap = self._max_shards or max(num_anchors, num_accelerators)
        return get_num_shards(v.shape[0] if v.shape else None, cap)

    def _place(self, load):
        dest = min(self.loads, key=self.loads.get)
        self.loads[dest] += load
        return dest

    def build(self, model_item, resource_spec):
        s = Strategy()
        self.make_graph_config(s.proto, resource_spec)
        anchors = self._anchors(resource_spec)
        self.loads = {a: 0.0 for a in anchors}
        for v in model_item.var_infos:
            if not v.trainable:
                continue
            k = self._num_shards(v, len(anchors), resource_spec.num_accelerators)
            if k <= 1:
                s.node_config.append(self._node(v, self._place(byte_size_load_fn(v))))
                continue
            per_shard = byte_size_load_fn(v) / k
            s.node_config.append(schema.Node(
                var_name=v.name, sparse=v.sparse, partition=[k] + [1] * (len(v.shape) - 1),
                part_config=[self._node(v, self._place(per_shard), f"{v.name}/part_{i}")
                             for i in range(k)]))
        return s
