"""PSLoadBalancing: greedy byte-size balanced PS placement, the default
builder (counterpart of ``autodist_tpu/strategy/ps_lb_strategy.py``).

Each node offers one anchor, its first accelerator (its address when it
has none); each trainable variable, in ``var_infos`` order, goes to the
least-loaded anchor, and its byte size (:func:`byte_size_load_fn`) adds to
that anchor's entry of ``loads``.  The engine realises it as :class:`PS`.
"""
from autodist_tpu_torch.strategy.base import Strategy
from autodist_tpu_torch.strategy.ps_strategy import PS


def byte_size_load_fn(var_info):
    """A variable's load: its byte size (at least 1)."""
    return max(var_info.byte_size, 1)


class PSLoadBalancing(PS):
    def __init__(self, local_proxy_variable=False, sync=True, staleness=0,
                 ps_axes=None):
        super().__init__(local_proxy_variable, sync, staleness, ps_axes)
        self.loads = {}

    @staticmethod
    def _anchors(resource_spec):
        anchors = []
        for addr in resource_spec.node_addresses:
            devs = [k for k, d in resource_spec.accelerator_devices if d.address == addr]
            anchors.append(devs[0] if devs else addr)
        return anchors

    def build(self, model_item, resource_spec):
        s = Strategy()
        self.make_graph_config(s.proto, resource_spec)
        self.loads = {a: 0.0 for a in self._anchors(resource_spec)}
        for v in model_item.var_infos:
            if not v.trainable:
                continue
            dest = min(self.loads, key=self.loads.get)
            self.loads[dest] += byte_size_load_fn(v)
            s.node_config.append(self._node(v, dest))
        return s
