"""Parallax: dense gradients to AllReduce, sparse ones to a load-balanced PS
(counterpart of ``autodist_tpu/strategy/parallax_strategy.py``, after the
Parallax paper, arXiv 1808.02621).

A sparse variable (``sparse_vars``) gets a PS node on the least-loaded
anchor by byte size, its lookup's backward syncing the rows; every dense
variable an AllReduce node of the next bucket group.  ``ps_axes`` confines
the PS variables' scatter and gather as :class:`PS` does.
"""
from autodist_tpu_torch.proto import schema
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.base import Strategy
from autodist_tpu_torch.strategy.ps_lb_strategy import PSLoadBalancing, byte_size_load_fn


class Parallax(AllReduce):
    def __init__(self, chunk_size=128, all_reduce_spec="AUTO", compressor="NoneCompressor",
                 local_proxy_variable=False, sync=True, staleness=0, ps_axes=None,
                 schedule="barrier", hierarchy="auto", dcn_compressor=None,
                 sharded_update="replicated"):
        super().__init__(chunk_size, all_reduce_spec, compressor, schedule=schedule,
                         hierarchy=hierarchy, dcn_compressor=dcn_compressor,
                         sharded_update=sharded_update)
        self._local_replication = local_proxy_variable
        self._sync = sync
        self._staleness = staleness
        self._ps_axes = tuple(ps_axes) if ps_axes else None

    def _dest(self, anchor):
        return ("mesh:" + ",".join(self._ps_axes)) if self._ps_axes else anchor

    def build(self, model_item, resource_spec):
        s = Strategy()
        self.make_graph_config(s.proto, resource_spec)
        loads = {a: 0.0 for a in PSLoadBalancing._anchors(resource_spec)}
        idx = 0
        for v in model_item.var_infos:
            if not v.trainable:
                continue
            if v.sparse:
                dest = min(loads, key=loads.get)
                loads[dest] += byte_size_load_fn(v)
                ps = schema.PSSynchronizer(reduction_destination=self._dest(dest),
                                           local_replication=self._local_replication,
                                           sync=self._sync, staleness=self._staleness)
                s.node_config.append(schema.Node(var_name=v.name, sparse=True,
                                                 PSSynchronizer=ps))
            else:
                s.node_config.append(self._node(v, idx // self.chunk_size))
                idx += 1
        return s
