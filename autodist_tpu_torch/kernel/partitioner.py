"""Variable placement planning: strategy nodes -> per-variable plans.

Counterpart of ``autodist_tpu/kernel/partitioner.py``.  This slice realises
the AllReduce family's pure data parallelism: every variable REPLICATED,
its gradient synchronised by the bucketed all-reduce.  Sharded, PS,
divergent and custom (tensor-parallel) placements are later slices and
raise ``NotImplementedError``.
"""
import dataclasses
import enum

from autodist_tpu_torch.utils import logging


class Placement(enum.Enum):
    REPLICATED = "replicated"
    SHARDED = "sharded"
    DIVERGENT = "divergent"
    CUSTOM = "custom"


class SyncKind(enum.Enum):
    ALL_REDUCE = "all_reduce"
    PS = "ps"


@dataclasses.dataclass
class VarPlan:
    """Everything the step needs to know about one variable."""

    name: str
    shape: tuple
    dtype: object
    placement: Placement
    sync: SyncKind
    sparse: bool = False
    # AllReduceSynchronizer fields (schema enums)
    group: int = 0
    compressor: int = 0
    spec: int = 0
    schedule: int = 0
    hierarchy: int = 0
    dcn_compressor: int = 0
    sharded_update: int = 0
    schedule_ir: str = ""
    precision: int = 0


def build_var_plans(strategy, model_item, num_replicas, param_specs=None):
    """A VarPlan for every trainable variable.  Variables without a node
    config default to AllReduce, as in the JAX package."""
    if param_specs:
        raise NotImplementedError("param_specs (CUSTOM placement) is a later slice "
                                  "of the port (ROADMAP, Queue A item 9)")
    plans = {}
    for v in model_item.var_infos:
        if not v.trainable:
            continue
        plan = VarPlan(name=v.name, shape=v.shape, dtype=v.dtype,
                       placement=Placement.REPLICATED, sync=SyncKind.ALL_REDUCE,
                       sparse=v.sparse)
        node = strategy.node_for(v.name)
        if node is None:
            logging.debug("Variable %s has no strategy node; defaulting to AllReduce", v.name)
            plans[v.name] = plan
            continue
        plan.sparse = plan.sparse or node.sparse
        which = node.WhichOneof("synchronizer")
        if any(k > 1 for k in node.partition) or node.part_config:
            raise NotImplementedError(
                f"{v.name!r}: partitioned variables are a later slice of the port "
                f"(ROADMAP, Queue A item 6)")
        if which == "PSSynchronizer":
            raise NotImplementedError(
                f"{v.name!r}: PSSynchronizer is a later slice of the port "
                f"(ROADMAP, Queue A item 2: the PS realisation)")
        if which == "AllReduceSynchronizer":
            ar = node.AllReduceSynchronizer
            plan.group = ar.group
            plan.compressor = ar.compressor
            plan.spec = ar.spec
            plan.schedule = ar.schedule
            plan.hierarchy = ar.hierarchy
            plan.dcn_compressor = ar.dcn_compressor
            plan.sharded_update = ar.sharded_update
            plan.schedule_ir = ar.schedule_ir
            plan.precision = ar.precision
        if plan.sparse:
            raise NotImplementedError(
                f"{v.name!r}: sparse gradients are a later slice of the port "
                f"(ROADMAP, Queue A item 6)")
        plans[v.name] = plan
    return plans
