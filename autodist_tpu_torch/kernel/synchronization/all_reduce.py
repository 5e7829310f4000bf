"""Bucketed all-reduce gradient synchronisation, and the sharded update.

Counterpart of ``autodist_tpu/kernel/synchronization/all_reduce.py``:
gradients of the same (strategy group, dtype, compressor, hierarchy, ...)
key are flattened into one buffer, reduced to the mean over the replicas
by the bucket's codec (:mod:`.compressor`), and split back
(:func:`sync_bucketed`, the barrier schedule).  Bucket keys and sizes are
the JAX package's, dtypes spelled as numpy spells them.

The JAX package runs a FLAT bucket through ``run_schedule``'s canonical
program, whose only phase is the codec's ``all_reduce`` over the replica
axis; here that is the one call.  The replicas are the processes of a
``torch.distributed`` group (``group=None``: one replica).

A bucket with the ZeRO-style sharded update (``sharded_update=SHARDED``,
:func:`bucket_sharded`: every wire transform elementwise) reduce-scatters
instead (:func:`scatter_bucket`): each variable's flat gradient is padded
to ``num_shards * ss`` and laid out as an ``(R, ss)`` matrix, the
bucket's matrices side by side (:func:`_pack_rows`), so that rank r
receives row r, its flat shard of every variable, through the codec's
wire hop (:func:`fused_wire_hop`).  The optimizer updates the shards and
:func:`gather_bucket_params` all-gathers the fresh parameters in their
native dtype.  A ``precision=BF16_COMPUTE_F32_MASTER`` bucket keeps the
f32 master as those shards and gathers a bf16 compute copy at the top of
the step (:mod:`autodist_tpu_torch.kernel.graph_transformer`).

The two-level hierarchy, the overlap schedule and schedule-IR buckets are
later slices (ROADMAP, Queue A item 5) and raise ``NotImplementedError``.
"""
import dataclasses
import math
from typing import Dict, List

import torch

from autodist_tpu_torch.kernel.synchronization.compressor import get_compressor
from autodist_tpu_torch.model_item import dtype_name
from autodist_tpu_torch.parallel import collectives as coll
from autodist_tpu_torch.proto import schema

_AR = schema.AllReduceSynchronizer
# codecs that act element for element on the flat buffer: the only ones a
# sharded update may reduce-scatter (a block codec re-blocked per shard
# would approximate differently)
ELEMENTWISE_CODECS = frozenset(
    (_AR.NoneCompressor, _AR.BF16Compressor, _AR.BF16CompressorEF))


def wire_codec(bucket) -> int:
    """The codec whose state the bucket carries and whose wire it takes:
    its own compressor (a FLAT bucket; the two-level and schedule-IR
    buckets that carry another one are a later slice)."""
    return bucket.compressor


def elementwise(bucket) -> bool:
    """True when every wire transform of the bucket acts element for
    element on the flat buffer."""
    return wire_codec(bucket) in ELEMENTWISE_CODECS


@dataclasses.dataclass(frozen=True)
class Bucket:
    key: str
    var_names: tuple
    sizes: tuple          # flat element counts per var
    shapes: tuple
    compressor: int
    dtype: str
    # AllReduceSynchronizer.ShardedUpdate, and for SHARDED buckets the shard
    # plan: the replica count the update space shards over and each var's
    # flat shard length ceil(size / num_shards)
    sharded_update: int = 0
    num_shards: int = 1
    shard_sizes: tuple = ()
    # AllReduceSynchronizer.Precision: BF16_COMPUTE_F32_MASTER buckets keep
    # the f32 master as the flat shards (set on sharded buckets only)
    precision: int = 0

    @property
    def total(self):
        return sum(self.sizes)

    @property
    def shard_total(self):
        """Columns of the ``(num_shards, shard_total)`` update matrix: the
        flat elements each replica updates."""
        return sum(self.shard_sizes)

    @property
    def padded_total(self):
        """Elements of the full padded update matrix."""
        return self.shard_total * self.num_shards


def plan_buckets(plans, var_shapes, var_dtypes, num_replicas=1) -> List[Bucket]:
    """Group AllReduce-replicated dense vars by (group, dtype, compressor,
    hierarchy, dcn_compressor, sharded_update, schedule_ir, precision).
    ``var_dtypes`` values are torch dtypes or numpy-style names;
    ``num_replicas`` sizes the shard plan of SHARDED-update buckets."""
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
    R = max(1, int(num_replicas))
    for (group, dtype, comp, hier, _, shup, ir, prec), names in sorted(groups.items()):
        if hier == _AR.TWO_LEVEL or ir:
            raise NotImplementedError(
                "two-level and schedule-IR buckets are a later slice of the port "
                "(ROADMAP, Queue A item 5)")
        suffix = (f"_z{shup}" if shup else "") + (f"_p{prec}" if prec else "")
        sizes = tuple(math.prod(var_shapes[n]) for n in names)
        buckets.append(Bucket(
            key=f"g{group}_{dtype}_c{comp}{suffix}", var_names=tuple(names),
            sizes=sizes, shapes=tuple(tuple(var_shapes[n]) for n in names),
            compressor=comp, dtype=dtype, sharded_update=shup, num_shards=R if shup else 1,
            shard_sizes=tuple(-(-s // R) for s in sizes) if shup else (), precision=prec))
    return buckets


def bucket_sharded(bucket) -> bool:
    """True when the bucket realises the sharded weight update: the knob is
    set, a shard plan was computed, and every wire transform is
    elementwise (the transformer has already dropped the knob of the
    others, as JAX does)."""
    return bool(bucket.sharded_update) and bool(bucket.shard_sizes) and elementwise(bucket)


def init_compressor_states(buckets, device="cpu"):
    """Per-bucket codec state: the flat f32 residual (zeros, one per element
    of the bucket) of an error-feedback codec, else an empty tuple."""
    states = {}
    for b in buckets:
        comp = get_compressor(wire_codec(b))
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


def padded_rows(t, rows, ss):
    """``t``'s flat elements zero-padded to ``rows * ss``, as ``(rows, ss)``
    (a view when no padding is needed)."""
    flat = t.reshape(-1)
    pad = rows * ss - flat.numel()
    return (torch.nn.functional.pad(flat, (0, pad)) if pad else flat).view(rows, ss)


def _pack_rows(pieces, b):
    """The bucket's per-var flat pieces -> the ``(num_shards, S)`` update
    matrix: each var padded to ``num_shards * ss`` on its own, so that row
    r holds the r-th flat shard of every var."""
    mats = [padded_rows(p, b.num_shards, ss) for p, ss in zip(pieces, b.shard_sizes)]
    return torch.cat(mats, dim=1) if len(mats) > 1 else mats[0]


def unpack_shard(b, row, grads_by_name, synced):
    """A replica's ``(shard_total,)`` mean row -> its per-var flat shards
    (the update-space gradients)."""
    off = 0
    for n, ss in zip(b.var_names, b.shard_sizes):
        synced[n] = row[off:off + ss].to(grads_by_name[n].dtype)
        off += ss


def fused_wire_hop(collective, src, codec, state):
    """The codec's encode -> ``collective`` -> decode around one wire hop.
    The bf16 family casts a flat f32 view of ``src`` to bf16 (the
    error-feedback variant adds its flat f32 residual ``state`` first and
    returns the new residual), runs ``collective`` on the bf16 buffer of
    ``src``'s shape and decodes to f32; any other codec passes ``src``
    through at its dtype.  Returns (the collective's output, the new
    state)."""
    if codec not in (_AR.BF16Compressor, _AR.BF16CompressorEF):
        return collective(src), state
    flat = src.reshape(-1).float()
    stateful = codec == _AR.BF16CompressorEF
    corrected = flat + state if stateful else flat
    wire = corrected.to(torch.bfloat16)
    new_state = corrected - wire.float() if stateful else state
    return collective(wire.view(src.shape)).float(), new_state


def scatter_bucket(grads_by_name, b, state, group=None):
    """Reduce-scatter of one sharded-update bucket: ``((shard_total,) mean
    row, new_state)``, this replica's gradient shard, through the bucket's
    codec on the wire (the gradient leg only)."""
    R = b.num_shards
    codec = wire_codec(b)
    if codec == _AR.NoneCompressor:   # pack straight from the gradients
        row = coll.psum_scatter(
            _pack_rows([grads_by_name[n] for n in b.var_names], b), group)
        new_state = state
    else:
        row, new_state = fused_wire_hop(
            lambda w: coll.psum_scatter(_pack_rows(w.split(b.sizes), b), group),
            _bucket_buf(grads_by_name, b), codec, state)
    row = row.reshape(-1)
    return (row / R if R > 1 else row), new_state


def _unpack_rows(full, names, shard_sizes, out):
    """Write a gathered ``(R, S)`` update matrix into the full tensors
    ``out[name]``: a var's columns, read row-major, are its flat value (the
    whole rows copied by one multi-tensor copy, a last partial row
    apart)."""
    dsts, srcs = [], []
    off = 0
    for n, ss in zip(names, shard_sizes):
        flat = out[n].view(-1)
        rows, rem = divmod(flat.numel(), ss)
        dsts.append(flat[:rows * ss].view(rows, ss))
        srcs.append(full[:rows, off:off + ss])
        if rem:
            flat[rows * ss:].copy_(full[rows, off:off + rem])
        off += ss
    if dsts:
        torch._foreach_copy_(dsts, srcs)


def gather_bucket_params(shards_by_name, b, group=None, out=None, dtype=None):
    """All-gather one sharded-update bucket's updated flat shards into full
    variables, in the shards' dtype or ``dtype`` (the bf16 master's compute
    copy; a compressed parameter gather would hand the replicas drifting
    copies): written into ``out[name]`` when given, else into new tensors;
    returns them by name."""
    srcs = [shards_by_name[n].reshape(-1) for n in b.var_names]
    row = torch.empty(b.shard_total, dtype=dtype or srcs[0].dtype, device=srcs[0].device)
    torch._foreach_copy_(list(row.split(b.shard_sizes)), srcs)   # one launch, cast on the way
    full = coll.all_gather_into_tensor(row, group).view(b.num_shards, -1)
    if out is None:
        out = {n: torch.empty(shape, dtype=full.dtype, device=full.device)
               for n, shape in zip(b.var_names, b.shapes)}
    _unpack_rows(full, b.var_names, b.shard_sizes, out)
    return {n: out[n] for n in b.var_names}


def shard_index(b, group=None):
    """Row of the bucket's ``(num_shards, S)`` update matrix this replica
    owns: its rank in the group, the order of :func:`scatter_bucket`."""
    return 0 if group is None else torch.distributed.get_rank(group)


def sync_bucketed(grads_by_name, buckets, comp_states, group=None, impl=None):
    """All-reduce every bucket through its codec: pack -> reduce -> mean ->
    unpack.  Returns (synced grads by name, new compressor states).  A
    sharded-update bucket reduce-scatters instead: its entries are the
    per-var ``(ss,)`` update-space shards, not full gradients.
    ``impl="plain"`` runs the codecs' kernels as their plain versions."""
    synced = {}
    new_states = dict(comp_states)
    for b in buckets:
        if bucket_sharded(b):
            row, new_states[b.key] = scatter_bucket(grads_by_name, b, comp_states[b.key],
                                                    group)
            unpack_shard(b, row, grads_by_name, synced)
            continue
        comp = get_compressor(b.compressor, impl=impl)
        reduced, new_states[b.key] = comp.all_reduce(
            _bucket_buf(grads_by_name, b), comp_states[b.key], group)
        _unpack_bucket(b, reduced, grads_by_name, synced)
    return synced, new_states
