"""The strategy schema as plain dataclasses with JSON serialisation.

Mirror of ``autodist_tpu/proto/strategy.proto`` and
``synchronizers.proto``: the same message, field and enum names and enum
values, without protobuf (the port's machines need not have it).  Enum
values are also reachable as class attributes, as protobuf's generated
classes expose them (``AllReduceSynchronizer.NoneCompressor``).

:func:`dumps` writes a message as JSON (enums by name); :func:`loads` reads
it back into the given message class.
"""
import dataclasses
import enum
import json
from typing import List, Optional


@dataclasses.dataclass
class MeshConfig:
    axis_names: List[str] = dataclasses.field(default_factory=list)
    axis_sizes: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PSSynchronizer:
    reduction_destination: str = ""
    local_replication: bool = False
    sync: bool = False
    staleness: int = 0


class Spec(enum.IntEnum):
    AUTO = 0
    ICI = 1
    DCN_HIERARCHICAL = 2


class Compressor(enum.IntEnum):
    NoneCompressor = 0
    BF16Compressor = 1
    BF16CompressorEF = 2
    Int8Compressor = 3
    Int8CompressorEF = 4
    PowerSGDCompressor = 5
    EquarxInt8Compressor = 6


class Schedule(enum.IntEnum):
    BARRIER = 0
    OVERLAP = 1


class Hierarchy(enum.IntEnum):
    AUTO_HIERARCHY = 0
    FLAT = 1
    TWO_LEVEL = 2


class ShardedUpdate(enum.IntEnum):
    REPLICATED_UPDATE = 0
    SHARDED = 1


class Precision(enum.IntEnum):
    F32 = 0
    BF16_COMPUTE_F32_MASTER = 1


@dataclasses.dataclass
class AllReduceSynchronizer:
    spec: Spec = Spec.AUTO
    compressor: Compressor = Compressor.NoneCompressor
    group: int = 0
    schedule: Schedule = Schedule.BARRIER
    hierarchy: Hierarchy = Hierarchy.AUTO_HIERARCHY
    dcn_compressor: Compressor = Compressor.NoneCompressor
    sharded_update: ShardedUpdate = ShardedUpdate.REPLICATED_UPDATE
    schedule_ir: str = ""
    precision: Precision = Precision.F32


for _enum in (Spec, Compressor, Schedule, Hierarchy, ShardedUpdate, Precision):
    setattr(AllReduceSynchronizer, _enum.__name__, _enum)
    for _member in _enum:
        setattr(AllReduceSynchronizer, _member.name, _member)


@dataclasses.dataclass
class Node:
    """``Strategy.Node``: one variable's synchronizer (a oneof: at most one
    of ``PSSynchronizer`` / ``AllReduceSynchronizer`` is set)."""

    var_name: str = ""
    PSSynchronizer: Optional[PSSynchronizer] = None
    AllReduceSynchronizer: Optional[AllReduceSynchronizer] = None
    partition: List[int] = dataclasses.field(default_factory=list)
    part_config: List["Node"] = dataclasses.field(default_factory=list)
    sparse: bool = False

    def WhichOneof(self, group):
        """Name of the set member of oneof ``group`` (protobuf's API)."""
        if group != "synchronizer":
            raise ValueError(f"Strategy.Node has no oneof {group!r}")
        if self.PSSynchronizer is not None:
            return "PSSynchronizer"
        if self.AllReduceSynchronizer is not None:
            return "AllReduceSynchronizer"
        return None


@dataclasses.dataclass
class GraphConfig:
    replicas: List[str] = dataclasses.field(default_factory=list)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


@dataclasses.dataclass
class Strategy:
    id: str = ""
    path: str = ""
    node_config: List[Node] = dataclasses.field(default_factory=list)
    graph_config: GraphConfig = dataclasses.field(default_factory=GraphConfig)


Strategy.Node = Node
Strategy.GraphConfig = GraphConfig

# field -> how to read it back from JSON
_MESSAGES = {
    (Node, "PSSynchronizer"): PSSynchronizer,
    (Node, "AllReduceSynchronizer"): AllReduceSynchronizer,
    (Node, "part_config"): Node,
    (GraphConfig, "mesh"): MeshConfig,
    (Strategy, "node_config"): Node,
    (Strategy, "graph_config"): GraphConfig,
}
_ENUMS = {
    "spec": Spec, "compressor": Compressor, "schedule": Schedule,
    "hierarchy": Hierarchy, "dcn_compressor": Compressor,
    "sharded_update": ShardedUpdate, "precision": Precision,
}


def to_dict(msg):
    """A message as JSON-ready dicts and lists (enums by name)."""
    out = {}
    for f in dataclasses.fields(msg):
        val = getattr(msg, f.name)
        if dataclasses.is_dataclass(val):
            val = to_dict(val)
        elif isinstance(val, list):
            val = [to_dict(v) if dataclasses.is_dataclass(v) else v for v in val]
        elif isinstance(val, enum.IntEnum):
            val = val.name
        out[f.name] = val
    return out


def from_dict(cls, data):
    """Inverse of :func:`to_dict`; enums accept names or integer values."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise ValueError(f"{cls.__name__} has no field(s) {sorted(unknown)}")
    kwargs = {}
    for name, val in data.items():
        sub = _MESSAGES.get((cls, name))
        if sub is not None and val is not None:
            val = ([from_dict(sub, v) for v in val] if isinstance(val, list)
                   else from_dict(sub, val))
        elif name in _ENUMS and cls is AllReduceSynchronizer:
            val = _ENUMS[name][val] if isinstance(val, str) else _ENUMS[name](val)
        kwargs[name] = val
    return cls(**kwargs)


def dumps(msg):
    return json.dumps(to_dict(msg), sort_keys=True)


def loads(cls, text):
    return from_dict(cls, json.loads(text))
