"""Bucketed all-reduce gradient synchronisation.

Counterpart of ``autodist_tpu/kernel/synchronization/all_reduce.py``:
gradients of the same (strategy group, dtype, compressor, hierarchy, ...)
key are flattened into one buffer, reduced to the mean over the replicas,
and split back (:func:`sync_bucketed`, the barrier schedule).  Bucket keys
and sizes are the JAX package's, dtypes spelled as numpy spells them.

In this slice the step runs on one GPU, where the mean over one replica is
the buffer itself.  The collective for more replicas (NCCL), the codecs and
the hierarchical, sharded and schedule-IR variants are later slices
(ROADMAP, Queue A item 5) and raise ``NotImplementedError``.
"""
import dataclasses
import math
from typing import Dict, List

import torch

from autodist_tpu_torch.model_item import dtype_name
from autodist_tpu_torch.proto import schema

_AR = schema.AllReduceSynchronizer


@dataclasses.dataclass(frozen=True)
class Bucket:
    key: str
    var_names: tuple
    sizes: tuple          # flat element counts per var
    shapes: tuple
    compressor: int
    dtype: str


def plan_buckets(plans, var_shapes, var_dtypes) -> List[Bucket]:
    """Group AllReduce-replicated dense vars by (group, dtype, compressor,
    hierarchy, dcn_compressor, sharded_update, schedule_ir, precision).
    ``var_dtypes`` values are torch dtypes or numpy-style names."""
    from autodist_tpu_torch.kernel.partitioner import Placement, SyncKind

    groups: Dict[tuple, list] = {}
    for name, plan in plans.items():
        if plan.sync != SyncKind.ALL_REDUCE or plan.placement != Placement.REPLICATED:
            continue
        if plan.sparse:
            continue
        dt = var_dtypes[name]
        key = (int(plan.group), dt if isinstance(dt, str) else dtype_name(dt),
               int(plan.compressor), int(plan.hierarchy), int(plan.dcn_compressor),
               int(plan.sharded_update), plan.schedule_ir, int(plan.precision))
        groups.setdefault(key, []).append(name)
    buckets = []
    for (group, dtype, comp, hier, _, shup, ir, prec), names in sorted(groups.items()):
        if hier == _AR.TWO_LEVEL or shup or ir or prec:
            raise NotImplementedError(
                "two-level, sharded-update, schedule-IR and bf16-master buckets "
                "are a later slice of the port (ROADMAP, Queue A item 5)")
        buckets.append(Bucket(
            key=f"g{group}_{dtype}_c{comp}", var_names=tuple(names),
            sizes=tuple(math.prod(var_shapes[n]) for n in names),
            shapes=tuple(tuple(var_shapes[n]) for n in names), compressor=comp,
            dtype=dtype))
    return buckets


def init_compressor_states(buckets):
    """Per-bucket codec state: empty for the stateless NoneCompressor."""
    for b in buckets:
        if b.compressor != _AR.NoneCompressor:
            raise NotImplementedError(
                f"bucket {b.key}: compressor {b.compressor} is a later slice of "
                f"the port (ROADMAP, Queue A item 5)")
    return {b.key: () for b in buckets}


def _bucket_buf(grads_by_name, b):
    """Pack: the bucket's gradients flattened into one buffer (native dtype)."""
    flats = [grads_by_name[n].reshape(-1) for n in b.var_names]
    return torch.cat(flats) if len(flats) > 1 else flats[0]


def reduce_mean(buf, num_replicas):
    """Reduce, then mean over the replicas."""
    if num_replicas == 1:
        return buf
    raise NotImplementedError(
        "the all-reduce over more than one replica (NCCL) is the multi-GPU "
        "slice of the port (ROADMAP, Queue A item 2)")


def _unpack_bucket(b, reduced, grads_by_name, synced):
    off = 0
    for n, sz, shp in zip(b.var_names, b.sizes, b.shapes):
        synced[n] = reduced[off:off + sz].view(shp).to(grads_by_name[n].dtype)
        off += sz


def sync_bucketed(grads_by_name, buckets, comp_states, num_replicas=1):
    """All-reduce every bucket: pack -> reduce -> mean -> unpack.  Returns
    (synced grads by name, new compressor states)."""
    synced = {}
    for b in buckets:
        reduced = reduce_mean(_bucket_buf(grads_by_name, b), num_replicas)
        _unpack_bucket(b, reduced, grads_by_name, synced)
    return synced, dict(comp_states)
