"""AllReduce strategy: every dense variable -> collective all-reduce.

Counterpart of ``autodist_tpu/strategy/all_reduce_strategy.py``: variable
``i`` (in ``ModelItem.var_infos`` order) joins bucket group
``i // chunk_size``, and every knob of the JAX builder is realised:

- ``compressor``: the seven codecs (``NoneCompressor``,
  ``BF16Compressor``/``HorovodCompressor``,
  ``BF16CompressorEF``/``HorovodCompressorEF``, ``Int8Compressor``,
  ``Int8CompressorEF``, ``EquarxInt8Compressor``, ``PowerSGDCompressor``);
- ``schedule="overlap"``: each bucket's sync issued from autograd hooks
  during the backward pass, in reverse bucket order;
- ``hierarchy="two_level"`` with an optional ``dcn_compressor`` for the
  cross-node hop: reduce-scatter within a node, all-reduce of the shard
  across nodes, all-gather within the node, on a ``{replica_dcn,
  replica_ici}`` mesh that :meth:`AllReduce.make_graph_config` factors
  from the spec's hosts when the spec has no ``mesh:`` request;
- ``schedule_ir``: an explicit collective program (validated here);
- ``sharded_update="sharded"`` and ``precision="bf16_master"`` (which
  implies the sharded update: the f32 master is the flat shard).
"""
from autodist_tpu_torch.proto import schema
from autodist_tpu_torch.parallel.mesh import hierarchical_axes
from autodist_tpu_torch.strategy.base import (Strategy, StrategyBuilder,
                                              resolve_compressor, resolve_hierarchy,
                                              resolve_precision, resolve_schedule,
                                              resolve_schedule_ir, resolve_sharded_update)

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
        self.chunk_size = chunk_size
        self.all_reduce_spec = all_reduce_spec
        self.compressor = resolve_compressor(compressor)
        self.schedule = resolve_schedule(schedule)
        self.hierarchy = resolve_hierarchy(hierarchy)
        self.precision = resolve_precision(precision)
        if self.precision:   # the f32 master lives in the sharded update's flat shard
            sharded_update = "sharded"
        self.sharded_update = resolve_sharded_update(sharded_update)
        self.dcn_compressor = (0 if dcn_compressor is None
                               else resolve_compressor(dcn_compressor))
        self.schedule_ir = resolve_schedule_ir(schedule_ir)

    def _node(self, v, group):
        ar = schema.AllReduceSynchronizer(
            spec=_SPECS.get(str(self.all_reduce_spec).upper(), _AR.AUTO),
            compressor=self.compressor, group=group, schedule=self.schedule,
            hierarchy=self.hierarchy, dcn_compressor=self.dcn_compressor,
            sharded_update=self.sharded_update, schedule_ir=self.schedule_ir,
            precision=self.precision)
        return schema.Node(var_name=v.name, sparse=v.sparse, AllReduceSynchronizer=ar)

    def make_graph_config(self, strategy, resource_spec):
        """Replicas and mesh; under ``hierarchy="two_level"`` with no
        ``mesh:`` request, the mesh is factored by the spec's hosts into
        ``{replica_dcn: hosts, replica_ici: devices per host}``
        (:func:`~autodist_tpu_torch.parallel.mesh.hierarchical_axes`)."""
        StrategyBuilder.make_graph_config(strategy, resource_spec)
        if self.hierarchy == _AR.TWO_LEVEL and not resource_spec.mesh_request:
            axes = hierarchical_axes(resource_spec, len(strategy.graph_config.replicas))
            strategy.graph_config.mesh = schema.MeshConfig(axis_names=list(axes),
                                                           axis_sizes=list(axes.values()))

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
