"""Variable placement planning: strategy nodes -> per-variable plans.

Counterpart of ``autodist_tpu/kernel/partitioner.py``.  The port realises
these plans:

- AllReduce, unpartitioned: REPLICATED storage, the gradient synchronised
  by the bucketed all-reduce and every replica running the same full
  update;
- weight-update sharding (:func:`flat_shard_update`): the gradients are
  reduce-scattered, each replica updates its flat 1/R shard of the
  variable (the optimizer state lives on the shard,
  :func:`update_space_shape`), and the fresh shards are all-gathered.  The
  synchronous PS realises every unpartitioned variable so (over a subset
  of the data axes with ``ps_axes``: ``mesh:<axes>``); the AllReduce
  family does with ``sharded_update`` where its wire codec is elementwise
  (:func:`plan_sharded_update`), and with ``precision="bf16_master"`` the
  f32 master lives only as that shard (:func:`master_shard_storage`).  A
  scalar is always AllReduce with the replicated update, as in JAX;
- any partitioned variable (``partition`` with one entry > 1, the
  synchronizer on its ``part_config``): SHARDED storage, the partition
  axis padded to a multiple of R and split in R blocks, one a replica
  (:func:`storage_shape`); the loss sees the gathered variable (or, for a
  sparse table split on dim 0, the block itself,
  :class:`~autodist_tpu_torch.ops.sparse.ShardedTable`), the gradient is
  reduce-scattered along the axis and each replica updates its block;
- an unpartitioned PS variable with ``sync=False`` or ``staleness > 0``:
  DIVERGENT storage, each replica holding a full-shape copy of its own
  (JAX stacks the R copies as ``(R, *shape)`` over the replica axis),
  updated by the replica's own gradient and averaged over the replicas
  on every step that ends a period of :attr:`VarPlan.sync_period` =
  ``staleness + 1`` steps; the synchronous reading of bounded staleness.
  With ``sync=False`` the session is the asynchronous runtime instead
  (:mod:`autodist_tpu_torch.kernel.synchronization.async_ps`), which
  reads the same plans;
- a sparse variable (``sparse_vars``): its lookup's backward syncs the
  gradient (:func:`~autodist_tpu_torch.ops.sparse.embedding_lookup`), so
  no collective of the step touches it again.

Custom (tensor-parallel) placements are a later slice and raise
``NotImplementedError``.
"""
import dataclasses
import enum
import math
from typing import Optional

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
    # PSSynchronizer fields; local_replication and reduction_destination
    # are carried for the JSON's sake: the gathered copy is the proxy
    ps_sync: bool = True
    staleness: int = 0
    local_replication: bool = False
    reduction_destination: str = ""
    # "mesh:<axes>" destinations: the axes the PS scatter and gather span;
    # the shards cross the other data axes by a sum (None: every data axis)
    ps_axes: Optional[tuple] = None
    # SHARDED fields: the partitioned axis, its size padded to a multiple of
    # R, and the strategy's shard count (metadata, as in JAX)
    partition_axis: int = 0
    padded_dim: Optional[int] = None
    logical_shards: int = 1

    @property
    def sync_period(self) -> int:
        """Steps between the averaging rounds of a DIVERGENT variable."""
        return max(self.staleness, 0) + 1


def _partition_axis_of(node):
    """(axis, count) of a partition list like ``[1, 2, 1]``; ``(None, 1)``
    when unpartitioned.  More than one partitioned axis raises."""
    parts = list(node.partition)
    active = [i for i, k in enumerate(parts) if k > 1]
    if not active:
        return None, 1
    if len(active) > 1:
        raise ValueError(f"Variable {node.var_name!r}: only one partition axis is "
                         f"supported, got {parts}")
    return active[0], parts[active[0]]


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
        axis, k = _partition_axis_of(node)
        which = node.WhichOneof("synchronizer")
        # partitioned nodes carry the synchronizer on their part_config
        src = node if which else (node.part_config[0] if node.part_config else None)
        which = which or (src.WhichOneof("synchronizer") if src is not None else None)
        if which == "PSSynchronizer":
            ps = src.PSSynchronizer
            plan.sync = SyncKind.PS
            plan.ps_sync = ps.sync
            plan.staleness = ps.staleness
            plan.local_replication = ps.local_replication
            plan.reduction_destination = ps.reduction_destination
            if ps.reduction_destination.startswith("mesh:"):
                plan.ps_axes = tuple(a for a in ps.reduction_destination[5:].split(",")
                                     if a) or None
        elif which == "AllReduceSynchronizer":
            ar = src.AllReduceSynchronizer
            plan.group = ar.group
            plan.compressor = ar.compressor
            plan.spec = ar.spec
            plan.schedule = ar.schedule
            plan.hierarchy = ar.hierarchy
            plan.dcn_compressor = ar.dcn_compressor
            plan.sharded_update = ar.sharded_update
            plan.schedule_ir = ar.schedule_ir
            plan.precision = ar.precision
        if len(v.shape) == 0:
            # a scalar's flat shard would be one element padded R-way
            plan.sync = SyncKind.ALL_REDUCE
            plan.sharded_update = 0
        elif axis is not None:
            plan.placement = Placement.SHARDED
            plan.partition_axis = axis
            plan.logical_shards = k
            plan.padded_dim = -(-v.shape[axis] // num_replicas) * num_replicas
        elif plan.sync == SyncKind.PS and (not plan.ps_sync or plan.staleness > 0):
            plan.placement = Placement.DIVERGENT
        if plan.placement != Placement.REPLICATED:
            plan.ps_axes = None   # realised only for flat-shard PS variables
        plans[v.name] = plan
    return plans


def plan_sharded_update(plan):
    """Eligibility for the AllReduce family's sharded weight update: a
    dense, non-scalar, replicated AllReduce plan with ``sharded_update``
    set whose every wire transform is elementwise (``None``, ``BF16``,
    ``BF16EF``): the compressor, under TWO_LEVEL (or an unresolved AUTO)
    the effective DCN codec too, and for a ``schedule_ir`` a program
    canonical to FLAT or TWO_LEVEL with an elementwise core (JAX
    ``partitioner.py:254-290``).  A block codec re-blocked per shard would
    approximate differently, so those plans keep the replicated update."""
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
    from autodist_tpu_torch.kernel.synchronization.all_reduce import ELEMENTWISE_CODECS, _AR

    if not plan.sharded_update or plan.sync != SyncKind.ALL_REDUCE:
        return False
    if plan.placement != Placement.REPLICATED or plan.sparse or not plan.shape:
        return False
    if plan.compressor not in ELEMENTWISE_CODECS:
        return False
    if plan.schedule_ir:
        try:
            prog = sir.loads(plan.schedule_ir)
        except ValueError:
            return False
        return (sir.canonical_hierarchy(prog) is not None
                and sir.core_codec(prog) in ELEMENTWISE_CODECS)
    if plan.hierarchy != _AR.FLAT:
        return (plan.dcn_compressor or plan.compressor) in ELEMENTWISE_CODECS
    return True


def flat_shard_update(plan):
    """True when the plan's update space is the flat padded 1/R shard: the
    PS family's weight-update sharding, and the AllReduce family's
    sharded update (:func:`plan_sharded_update`)."""
    if plan.placement != Placement.REPLICATED:
        return False
    return plan.sync == SyncKind.PS or plan_sharded_update(plan)


def master_shard_storage(plan):
    """bf16-compute / f32-master precision
    (``Precision.BF16_COMPUTE_F32_MASTER``): the variable's storage is its
    flat padded f32 master shard, the update space, and the full-shape
    parameter the loss sees is a bf16 copy gathered at the top of each
    step.  Needs an f32 variable and a realised sharded update."""
    from autodist_tpu_torch.model_item import dtype_name

    if not plan.precision or dtype_name(plan.dtype) != "float32":
        return False
    return plan_sharded_update(plan)


def shard_len(plan, num_replicas):
    """Elements of one replica's flat shard: ``ceil(n / R)``."""
    return -(-math.prod(plan.shape) // num_replicas)


def storage_spec(plan, replica_axis="replica"):
    """The partition spec of the variable's storage, one entry per
    dimension as JAX's ``PartitionSpec`` (the mesh axis a dimension is
    split over, or None): the partition axis of a SHARDED plan, dim 0 of a
    bf16 master's flat shard, the leading replica axis of JAX's ``(R,
    *shape)`` stack of a DIVERGENT plan's copies, else nothing
    (replicated)."""
    if plan.placement == Placement.DIVERGENT:
        return (replica_axis,) + (None,) * len(plan.shape)
    if plan.placement == Placement.SHARDED:
        entries = [None] * len(plan.shape)
        entries[plan.partition_axis] = replica_axis
        return tuple(entries)
    if plan.placement == Placement.REPLICATED:
        return (replica_axis,) if master_shard_storage(plan) else ()
    raise ValueError(plan.placement)


def storage_shape(plan, num_replicas):
    """Global shape of the storage: a SHARDED plan's with its partition axis
    padded, a bf16 master's flat padded shard space, else the variable's.
    A DIVERGENT plan's is the variable's shape too: the one full copy a
    rank stores (JAX's global array stacks R of them, ``(R, *shape)``)."""
    if plan.placement == Placement.SHARDED:
        shape = list(plan.shape)
        shape[plan.partition_axis] = plan.padded_dim
        return tuple(shape)
    if master_shard_storage(plan):
        return update_space_shape(plan, num_replicas)
    return tuple(plan.shape)


def update_space_shape(plan, num_replicas):
    """Global shape of the update space: a SHARDED plan's storage, the flat
    ``ceil(n/R) * R`` padded elements of a flat-shard plan (R the replicas
    its PS axes span), else the variable's shape (a DIVERGENT plan's: the
    rank's own copy)."""
    if plan.placement == Placement.SHARDED:
        return storage_shape(plan, num_replicas)
    if flat_shard_update(plan):
        return (shard_len(plan, num_replicas) * num_replicas,)
    return tuple(plan.shape)
