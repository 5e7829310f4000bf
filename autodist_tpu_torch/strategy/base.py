"""Strategy wrapper, builder base class and compiler.

Counterpart of ``autodist_tpu/strategy/base.py`` over the JSON schema of
:mod:`autodist_tpu_torch.proto.schema`: the chief serialises a built
:class:`Strategy` by id, workers load it; :class:`StrategyCompiler` prunes
node configs of non-trainable variables and resolves replica device
strings to ``mesh:<index>``.  The ``resolve_*`` helpers map a builder's
knobs to schema enums, with the JAX package's names, aliases and values
(every one realised), and ``resolve_schedule_ir`` validates a schedule-IR
program.
"""
import copy
import os
import time
from abc import ABC, abstractmethod

from autodist_tpu_torch.const import DEFAULT_SERIALIZATION_DIR
from autodist_tpu_torch.kernel.device.resolver import DeviceResolver
from autodist_tpu_torch.parallel.mesh import check_mesh_axes, factorize
from autodist_tpu_torch.proto import schema
from autodist_tpu_torch.utils import logging

_COUNTER = [0]


def _new_id():
    _COUNTER[0] += 1
    return time.strftime("%Y%m%d%H%M%S") + f"-{os.getpid()}-{_COUNTER[0]}"


class Strategy:
    """Wrapper around a ``schema.Strategy`` message."""

    def __init__(self, strategy_msg=None):
        self._msg = strategy_msg or schema.Strategy()
        if not self._msg.id:
            self._msg.id = _new_id()

    @property
    def id(self):
        return self._msg.id

    @property
    def proto(self):
        return self._msg

    @property
    def node_config(self):
        return self._msg.node_config

    @property
    def graph_config(self):
        return self._msg.graph_config

    def node_for(self, var_name):
        for n in self._msg.node_config:
            if n.var_name == var_name:
                return n
        return None

    @staticmethod
    def _path(strategy_id):
        return os.path.join(DEFAULT_SERIALIZATION_DIR, strategy_id)

    def serialize(self, path=None):
        path = path or self._path(self._msg.id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._msg.path = path
        with open(path, "w") as f:
            f.write(schema.dumps(self._msg))
        logging.debug("Serialized strategy %s to %s", self._msg.id, path)
        return path

    @classmethod
    def deserialize(cls, strategy_id=None, path=None):
        path = path or cls._path(strategy_id)
        with open(path) as f:
            return cls(schema.loads(schema.Strategy, f.read()))

    def copy(self):
        msg = copy.deepcopy(self._msg)
        msg.id = _new_id()
        return Strategy(msg)

    def __str__(self):
        return f"Strategy(id={self._msg.id}, nodes={len(self._msg.node_config)})"


class StrategyBuilder(ABC):
    """Maps (ModelItem, ResourceSpec) -> Strategy."""

    @abstractmethod
    def build(self, model_item, resource_spec) -> Strategy:
        raise NotImplementedError

    @staticmethod
    def make_graph_config(strategy, resource_spec):
        """Fill replicas (every accelerator, else the CPUs) and the mesh:
        the spec's ``mesh:`` request (replica and seq axes, one size may be
        -1), else the default 1-D replica mesh."""
        replicas = [k for k, _ in resource_spec.accelerator_devices]
        if not replicas:
            replicas = [k for k, _ in resource_spec.cpu_devices]
        strategy.graph_config.replicas = replicas
        request = resource_spec.mesh_request
        if request:
            check_mesh_axes(list(request))
            strategy.graph_config.mesh = schema.MeshConfig(
                axis_names=list(request),
                axis_sizes=factorize(len(replicas), list(request.values())))
        else:
            strategy.graph_config.mesh = schema.MeshConfig(
                axis_names=["replica"], axis_sizes=[len(replicas)])


_AR = schema.AllReduceSynchronizer


def _resolve(kind, value, aliases):
    """Map a knob (alias name or enum value) to its enum."""
    if isinstance(value, int) and not isinstance(value, bool):
        choices = {int(v): v for v in aliases.values()}
        if value not in choices:
            raise ValueError(f"Unknown {kind} enum value {value}; accepted names/values: "
                             f"{sorted(aliases)}")
        return choices[value]
    key = value if kind == "compressor" else str(value).lower()
    if key not in aliases:
        raise ValueError(f"Unknown {kind} {value!r}; accepted names/values: {sorted(aliases)}")
    return aliases[key]


_COMPRESSOR_ALIASES = {
    "NoneCompressor": _AR.NoneCompressor,
    "HorovodCompressor": _AR.BF16Compressor,
    "HorovodCompressorEF": _AR.BF16CompressorEF,
    "BF16Compressor": _AR.BF16Compressor,
    "BF16CompressorEF": _AR.BF16CompressorEF,
    "Int8Compressor": _AR.Int8Compressor,
    "Int8CompressorEF": _AR.Int8CompressorEF,
    "PowerSGDCompressor": _AR.PowerSGDCompressor,
    "EquarxInt8Compressor": _AR.EquarxInt8Compressor,
    "equarx_int8": _AR.EquarxInt8Compressor,
}
_SCHEDULE_ALIASES = {"barrier": _AR.BARRIER, "overlap": _AR.OVERLAP}
_HIERARCHY_ALIASES = {"auto": _AR.AUTO_HIERARCHY, "flat": _AR.FLAT,
                      "two_level": _AR.TWO_LEVEL, "hierarchical": _AR.TWO_LEVEL,
                      "2level": _AR.TWO_LEVEL}
_SHARDED_UPDATE_ALIASES = {"replicated": _AR.REPLICATED_UPDATE, "sharded": _AR.SHARDED,
                           "zero": _AR.SHARDED, "sharded_update": _AR.SHARDED}
_PRECISION_ALIASES = {"f32": _AR.F32, "bf16_master": _AR.BF16_COMPUTE_F32_MASTER,
                      "bf16_compute_f32_master": _AR.BF16_COMPUTE_F32_MASTER,
                      "mixed": _AR.BF16_COMPUTE_F32_MASTER}


def resolve_compressor(name_or_value):
    return _resolve("compressor", name_or_value, _COMPRESSOR_ALIASES)


def resolve_schedule(name_or_value):
    return _resolve("schedule", name_or_value, _SCHEDULE_ALIASES)


def resolve_hierarchy(name_or_value):
    return _resolve("hierarchy", name_or_value, _HIERARCHY_ALIASES)


def resolve_sharded_update(name_or_value):
    if isinstance(name_or_value, bool):
        name_or_value = "sharded" if name_or_value else "replicated"
    return _resolve("sharded_update", name_or_value, _SHARDED_UPDATE_ALIASES)


def resolve_precision(name_or_value):
    return _resolve("precision", name_or_value, _PRECISION_ALIASES)


def resolve_schedule_ir(value):
    """A ``schedule_ir`` knob (a serialised phase list
    ``"<op>@<axis>[+<axis>...][:<codec>];..."`` or a parsed ``ScheduleIR``)
    as its canonical string, its grammar and codec placement validated;
    ``None``, ``""`` and ``0`` mean "follow the hierarchy knob" (JAX
    ``strategy/base.py:272-297``)."""
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir

    if value is None or value == "" or value == 0:
        return ""
    if isinstance(value, sir.ScheduleIR):
        prog = value
    elif isinstance(value, int):
        raise ValueError(
            f"Unknown schedule_ir value {value!r}; expected a serialized phase list "
            f"'<op>@<axis>[+<axis>...][:<codec>];...' with ops "
            f"{', '.join(repr(o) for o in sir.OPS)} and codec names/values: "
            f"{sorted(_COMPRESSOR_ALIASES)}")
    else:
        prog = sir.loads(value)
    sir.validate(prog)
    return sir.dumps(prog)


class StrategyCompiler:
    """Resolve + prune a strategy against the concrete cluster."""

    def __init__(self, model_item=None, resource_spec=None):
        self._model_item = model_item
        self._resource_spec = resource_spec

    def compile(self, strategy: Strategy) -> Strategy:
        s = strategy.copy()
        self._prune_nodes(s)
        if self._resource_spec is not None:
            resolver = DeviceResolver(self._resource_spec)
            s.graph_config.replicas = [resolver.resolve(r) for r in s.graph_config.replicas]
        return s

    def _prune_nodes(self, s):
        if self._model_item is None:
            return
        trainable = set(self._model_item.trainable_var_names)
        dropped = [n.var_name for n in s.node_config if n.var_name not in trainable]
        if dropped:
            logging.debug("Pruned %d node configs without trainable vars: %s",
                          len(dropped), dropped[:5])
        s.proto.node_config = [n for n in s.node_config if n.var_name in trainable]
