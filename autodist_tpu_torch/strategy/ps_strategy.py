"""PS strategy: every variable synchronised through a sharded parameter
server (counterpart of ``autodist_tpu/strategy/ps_strategy.py``).

Every trainable variable gets a ``PSSynchronizer`` whose
``reduction_destination`` is the chief node's first accelerator (its
first device when it has none).  The engine realises a synchronous PS as
weight-update sharding: the gradients are reduce-scattered, each replica
updates its flat 1/R shard of every variable, and the fresh shards are
all-gathered (:mod:`autodist_tpu_torch.kernel.graph_transformer`), so
``local_proxy_variable`` changes the JSON and not the program, as in JAX.

``ps_axes`` names the mesh axes the scatter and gather span; the port
takes it only when it is the whole data axis (``("replica",)``, which JAX
normalises back to the default); a subset of a factored mesh is a later
slice (ROADMAP, Queue A item 6, with ``test_ps_mesh_subset.py``).  ``sync=False`` and ``staleness > 0``
build, and raise at ``distribute`` (Queue A item 6).
"""
from autodist_tpu_torch.const import AXIS_REPLICA
from autodist_tpu_torch.proto import schema
from autodist_tpu_torch.strategy.base import Strategy, StrategyBuilder


class PS(StrategyBuilder):
    def __init__(self, local_proxy_variable=False, sync=True, staleness=0,
                 ps_axes=None):
        self._local_replication = local_proxy_variable
        self._sync = sync
        self._staleness = staleness
        self._ps_axes = tuple(ps_axes) if ps_axes else None
        if self._ps_axes not in (None, (AXIS_REPLICA,)):
            raise NotImplementedError(
                f"ps_axes={self._ps_axes}: a PS confined to a subset of the data axes "
                f"(the replica_dcn x replica_ici mesh) is a later slice of the port "
                f"(ROADMAP, Queue A item 6); the port takes ps_axes=('{AXIS_REPLICA}',)")

    def _dest(self, anchor):
        return ("mesh:" + ",".join(self._ps_axes)) if self._ps_axes else anchor

    def _node(self, v, anchor):
        ps = schema.PSSynchronizer(reduction_destination=self._dest(anchor),
                                   local_replication=self._local_replication,
                                   sync=self._sync, staleness=self._staleness)
        return schema.Node(var_name=v.name, sparse=v.sparse, PSSynchronizer=ps)

    def build(self, model_item, resource_spec):
        s = Strategy()
        self.make_graph_config(s.proto, resource_spec)
        chief = resource_spec.chief
        anchor = next((k for k, d in resource_spec.accelerator_devices
                       if d.address == chief), chief)
        s.node_config.extend(self._node(v, anchor) for v in model_item.var_infos
                             if v.trainable)
        return s
