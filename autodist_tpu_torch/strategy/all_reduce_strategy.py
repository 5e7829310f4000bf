"""AllReduce strategy: every dense variable -> collective all-reduce.

Counterpart of ``autodist_tpu/strategy/all_reduce_strategy.py``: variable
``i`` (in ``ModelItem.var_infos`` order) joins bucket group
``i // chunk_size``.  The port realises the compressor knob's six codecs
(``NoneCompressor``, ``BF16Compressor``/``HorovodCompressor``,
``BF16CompressorEF``/``HorovodCompressorEF``, ``Int8Compressor``,
``Int8CompressorEF``, ``EquarxInt8Compressor``), the sharded update
(``sharded_update="sharded"``) and bf16-compute / f32-master precision
(``precision="bf16_master"``, which implies the sharded update: the f32
master is the flat shard), and the other knobs' defaults (barrier
schedule, flat hierarchy); the rest raise ``NotImplementedError`` at
construction.
"""
from autodist_tpu_torch.proto import schema
from autodist_tpu_torch.strategy.base import (Strategy, StrategyBuilder,
                                              resolve_compressor, resolve_hierarchy,
                                              resolve_precision, resolve_schedule,
                                              resolve_sharded_update)

_AR = schema.AllReduceSynchronizer
_SPECS = {
    "AUTO": _AR.AUTO,
    "ICI": _AR.ICI,
    "DCN_HIERARCHICAL": _AR.DCN_HIERARCHICAL,
    # reference names accepted as aliases
    "NCCL": _AR.ICI,
    "RING": _AR.ICI,
}


class AllReduce(StrategyBuilder):
    def __init__(self, chunk_size=128, all_reduce_spec="AUTO",
                 compressor="NoneCompressor", schedule="barrier",
                 hierarchy="auto", dcn_compressor=None,
                 sharded_update="replicated", schedule_ir=None,
                 precision="f32"):
        if chunk_size < 1:
            raise ValueError("The chunk_size must be greater than zero")
        if dcn_compressor is not None or schedule_ir:
            raise NotImplementedError(
                "dcn_compressor and schedule_ir are a later slice of the port "
                "(ROADMAP, Queue A item 5)")
        self.chunk_size = chunk_size
        self.all_reduce_spec = all_reduce_spec
        self.compressor = resolve_compressor(compressor)
        self.schedule = resolve_schedule(schedule)
        self.hierarchy = resolve_hierarchy(hierarchy)
        self.precision = resolve_precision(precision)
        if self.precision:   # the f32 master lives in the sharded update's flat shard
            sharded_update = "sharded"
        self.sharded_update = resolve_sharded_update(sharded_update)

    def _node(self, v, group):
        ar = schema.AllReduceSynchronizer(
            spec=_SPECS.get(str(self.all_reduce_spec).upper(), _AR.AUTO),
            compressor=self.compressor, group=group, schedule=self.schedule,
            hierarchy=self.hierarchy, sharded_update=self.sharded_update,
            precision=self.precision)
        return schema.Node(var_name=v.name, sparse=v.sparse, AllReduceSynchronizer=ar)

    def build(self, model_item, resource_spec):
        s = Strategy()
        self.make_graph_config(s.proto, resource_spec)
        idx = 0
        for v in model_item.var_infos:
            if not v.trainable:
                continue
            s.node_config.append(self._node(v, idx // self.chunk_size))
            idx += 1
        return s
