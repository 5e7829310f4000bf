"""Bucketed all-reduce gradient synchronisation.

Counterpart of ``autodist_tpu/kernel/synchronization/all_reduce.py``:
gradients of the same (strategy group, dtype, compressor, hierarchy, ...)
key are flattened into one buffer, reduced to the mean over the replicas
by the bucket's codec (:mod:`.compressor`), and split back
(:func:`sync_bucketed`, the barrier schedule).  Bucket keys and sizes are
the JAX package's, dtypes spelled as numpy spells them.

The JAX package runs a FLAT bucket through ``run_schedule``'s canonical
program, whose only phase is the codec's ``all_reduce`` over the replica
axis; here that is the one call.  The replicas are the processes of a
``torch.distributed`` group (``group=None``: one replica).  The
hierarchical, sharded, overlapped and schedule-IR variants are later
slices (ROADMAP, Queue A item 5) and raise ``NotImplementedError``.
"""
import dataclasses
import math
from typing import Dict, List

import torch

from autodist_tpu_torch.kernel.synchronization.compressor import get_compressor
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

    @property
    def total(self):
        return sum(self.sizes)


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


def init_compressor_states(buckets, device="cpu"):
    """Per-bucket codec state: the flat f32 residual (zeros, one per element
    of the bucket) of an error-feedback codec, else an empty tuple."""
    states = {}
    for b in buckets:
        comp = get_compressor(b.compressor)
        states[b.key] = comp.init_state(b.total, device) if comp.stateful else ()
    return states


def _bucket_buf(grads_by_name, b):
    """Pack: the bucket's gradients flattened into one buffer (native dtype)."""
    flats = [grads_by_name[n].reshape(-1) for n in b.var_names]
    return torch.cat(flats) if len(flats) > 1 else flats[0]


def _unpack_bucket(b, reduced, grads_by_name, synced):
    off = 0
    for n, sz, shp in zip(b.var_names, b.sizes, b.shapes):
        synced[n] = reduced[off:off + sz].view(shp).to(grads_by_name[n].dtype)
        off += sz


def sync_bucketed(grads_by_name, buckets, comp_states, group=None, impl=None):
    """All-reduce every bucket through its codec: pack -> reduce -> mean ->
    unpack.  Returns (synced grads by name, new compressor states).
    ``impl="plain"`` runs the codecs' kernels as their plain versions."""
    synced = {}
    new_states = dict(comp_states)
    for b in buckets:
        comp = get_compressor(b.compressor, impl=impl)
        reduced, new_states[b.key] = comp.all_reduce(
            _bucket_buf(grads_by_name, b), comp_states[b.key], group)
        _unpack_bucket(b, reduced, grads_by_name, synced)
    return synced, new_states
