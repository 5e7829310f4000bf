"""Bucketed all-reduce gradient synchronisation: the issue schedules, the
hierarchy, the schedule-IR executor and the sharded update.

Counterpart of ``autodist_tpu/kernel/synchronization/all_reduce.py``:
gradients of the same (strategy group, dtype, compressor, hierarchy,
dcn_compressor, sharded_update, schedule_ir, precision) key are flattened
into one buffer, reduced to the mean over the replicas, and split back.
Bucket keys and sizes are the JAX package's, dtypes spelled as numpy
spells them.  The replicas are the processes of a ``torch.distributed``
group (``group=None``: one replica); a mesh axis or axis tuple resolves to
an :class:`~autodist_tpu_torch.parallel.collectives.AxisGroup` through
``axes`` (:meth:`ReplicaWorld.axis_group
<autodist_tpu_torch.parallel.mesh.ReplicaWorld.axis_group>`; ``None``: a
group of one for every axis).

Each bucket's collective is a program of the schedule IR
(:mod:`.schedule_ir`), run by :func:`run_schedule`: a reduce-scatter
prefix, an optional core (the codec's ``all_reduce`` or the explicit
``ppermute_ring``), and the mirrored all-gather suffix, each hop through
its wire codec (:func:`fused_wire_hop`).  A FLAT bucket's program is one
core over the data axes: the codec's ``all_reduce`` over ``group``, called
directly.  A TWO_LEVEL bucket on a ``replica_dcn x replica_ici`` mesh runs
the canonical two-level program (:func:`bucket_program`): reduce-scatter
within the node (ICI, native dtype), the all-reduce of the 1/R_ici shard
across nodes (DCN) through the DCN codec (:func:`dcn_codec`), and the
all-gather within the node; an error-feedback DCN codec keeps its residual
at bucket size, each rank reading and writing the region of the shard it
encodes (offset = ici index x shard).  A bucket with an explicit ``schedule_ir``
runs its program verbatim.

Two issue schedules:

- :func:`sync_bucketed` (barrier): every bucket after the backward pass,
  in bucket order;
- :func:`sync_overlapped` (overlap): buckets in reverse order, the order
  in which the backward pass completes their gradients, and buckets whose
  every wire transform is elementwise (:func:`elementwise`) split into
  ``DEFAULT_BUCKET_BYTES`` chunks, each reduced on its own; a chunk's
  reduce equals the fused reduce element for element, and an
  error-feedback residual slices at the same offsets.  Block codecs (int8,
  PowerSGD) reduce the whole bucket.  :class:`OverlapPass` issues the same
  per-bucket syncs from autograd hooks during the backward pass (the
  engine's ``schedule="overlap"``).

A bucket with the ZeRO-style sharded update (:func:`bucket_sharded`)
reduce-scatters instead (:func:`scatter_bucket`): each variable's flat
gradient is padded to ``num_shards * ss`` and laid out as an ``(R, ss)``
matrix, the bucket's matrices side by side (:func:`_pack_rows`), so that
the replica of row r receives its flat shard of every variable through
the codec's wire hop.  Under TWO_LEVEL the ICI reduce-scatter's rows feed
the DCN reduce-scatter directly, so rows are ici-major (row ``ici * R_dcn +
dcn``, :func:`shard_index`).  The optimizer updates the shards and
:func:`gather_bucket_params` all-gathers the fresh parameters in their
native dtype.  A ``precision=BF16_COMPUTE_F32_MASTER`` bucket keeps the
f32 master as those shards and gathers a bf16 compute copy at the top of
the step (:mod:`autodist_tpu_torch.kernel.graph_transformer`).
"""
import contextlib
import dataclasses
import functools
import hashlib
import math
from typing import Dict, List, Optional

import torch

from autodist_tpu_torch.const import DEFAULT_BUCKET_BYTES
from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
from autodist_tpu_torch.kernel.synchronization.compressor import get_compressor
from autodist_tpu_torch.model_item import dtype_name
from autodist_tpu_torch.parallel import collectives as coll
from autodist_tpu_torch.proto import schema

_AR = schema.AllReduceSynchronizer
# codecs that act element for element on the flat buffer: the only ones a
# sharded update may reduce-scatter and the overlap schedule may chunk (a
# block codec re-blocked per shard or chunk would approximate differently)
ELEMENTWISE_CODECS = frozenset(
    (_AR.NoneCompressor, _AR.BF16Compressor, _AR.BF16CompressorEF))
# codecs that may ride the cross-node (DCN) hop of a TWO_LEVEL bucket: the
# elementwise family and the int8 family; PowerSGD's factor exchange does
# not decompose into a shard hop
DCN_SAFE_CODECS = frozenset(
    (_AR.NoneCompressor, _AR.BF16Compressor, _AR.BF16CompressorEF,
     _AR.Int8Compressor, _AR.Int8CompressorEF, _AR.EquarxInt8Compressor))
_ONE = coll.AxisGroup(None, 1, 0, (0,))


def _one_rank(axes):
    return _ONE


@dataclasses.dataclass(frozen=True)
class HierAxes:
    """Axis split of a two-level sync: ``ici`` the within-node axis the
    scatter and gather ride, ``dcn`` the cross-node axes over which only
    the shard moves."""

    ici: str
    dcn: tuple


def dcn_codec(bucket) -> int:
    """The codec on a TWO_LEVEL bucket's cross-node hop: ``dcn_compressor``
    when set, else the bucket's own compressor."""
    return bucket.dcn_compressor or bucket.compressor


def wire_codec(bucket) -> int:
    """The codec whose state the bucket carries: a schedule-IR bucket's
    core codec (hop codecs are stateless by the grammar), a TWO_LEVEL
    bucket's DCN codec (its only wire transform), else its own compressor
    (PowerSGD always: it never decomposes)."""
    if bucket.schedule_ir:
        return sir.core_codec(sir.loads(bucket.schedule_ir))
    if bucket.hierarchy == _AR.TWO_LEVEL and bucket.compressor != _AR.PowerSGDCompressor:
        return dcn_codec(bucket)
    return bucket.compressor


def elementwise(bucket) -> bool:
    """True when every wire transform of the bucket acts element for
    element on the flat buffer: the buckets the overlap schedule may chunk
    and sync per microbatch.  A schedule-IR bucket is elementwise when
    every phase codec is."""
    if bucket.schedule_ir:
        prog = sir.loads(bucket.schedule_ir)
        return (all(ph.codec in ELEMENTWISE_CODECS for ph in prog.phases)
                and bucket.compressor in ELEMENTWISE_CODECS)
    return wire_codec(bucket) in ELEMENTWISE_CODECS and bucket.compressor in ELEMENTWISE_CODECS


@dataclasses.dataclass(frozen=True)
class Bucket:
    key: str
    var_names: tuple
    sizes: tuple          # flat element counts per var
    shapes: tuple
    compressor: int
    dtype: str
    # AllReduceSynchronizer.Hierarchy, resolved by the transformer (AUTO
    # never reaches a Bucket), and the cross-node hop's codec (0: follow
    # ``compressor``)
    hierarchy: int = 0
    dcn_compressor: int = 0
    # AllReduceSynchronizer.ShardedUpdate, and for SHARDED buckets the shard
    # plan: the replica count the update space shards over and each var's
    # flat shard length ceil(size / num_shards)
    sharded_update: int = 0
    num_shards: int = 1
    shard_sizes: tuple = ()
    # a serialised schedule-IR program, run verbatim (``hierarchy`` and
    # ``dcn_compressor`` are then FLAT and 0)
    schedule_ir: str = ""
    # AllReduceSynchronizer.Precision: BF16_COMPUTE_F32_MASTER buckets keep
    # the f32 master as the flat shards (set on sharded buckets only)
    precision: int = 0
    # a PS group confined to a subset of the data axes ("mesh:<axes>"): the
    # scatter and gather span ``ps_axes`` (num_shards is their size) and the
    # scattered shards are summed over ``other_axes``
    ps_axes: tuple = ()
    other_axes: tuple = ()

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
    hierarchy, dcn_compressor, sharded_update, schedule_ir, precision), with
    JAX's key suffixes (``_h{h}_d{d}`` two-level, ``_z`` sharded, ``_s`` and
    the program's md5 for schedule IR, ``_p`` precision).  ``var_dtypes``
    values are torch dtypes or numpy-style names; ``num_replicas`` sizes
    the shard plan of SHARDED-update buckets."""
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
    for (group, dtype, comp, hier, dcn, shup, ir, prec), names in sorted(groups.items()):
        suffix = f"_h{hier}_d{dcn}" if hier == _AR.TWO_LEVEL else ""
        if shup:
            suffix += f"_z{shup}"
        if ir:
            suffix += f"_s{hashlib.md5(ir.encode()).hexdigest()[:8]}"
        if prec:
            suffix += f"_p{prec}"
        sizes = tuple(math.prod(var_shapes[n]) for n in names)
        buckets.append(Bucket(
            key=f"g{group}_{dtype}_c{comp}{suffix}", var_names=tuple(names),
            sizes=sizes, shapes=tuple(tuple(var_shapes[n]) for n in names),
            compressor=comp, dtype=dtype, hierarchy=hier, dcn_compressor=dcn,
            sharded_update=shup, num_shards=R if shup else 1,
            shard_sizes=tuple(-(-s // R) for s in sizes) if shup else (),
            schedule_ir=ir, precision=prec))
    return buckets


def bucket_sharded(bucket) -> bool:
    """True when the bucket realises the sharded weight update: the knob is
    set, a shard plan was computed, it runs no explicit schedule IR, and
    every wire transform is elementwise (the transformer has already
    dropped the knob of the others, as JAX does)."""
    return (bool(bucket.sharded_update) and bool(bucket.shard_sizes)
            and not bucket.schedule_ir and elementwise(bucket))


def init_compressor_states(buckets, device="cpu"):
    """Per-bucket codec state of the bucket's wire codec
    (:func:`wire_codec`): an error-feedback codec's flat f32 residual, one
    element per element of the bucket (of its padded update matrix for a
    TWO_LEVEL sharded bucket, the buffer its DCN hop compresses),
    PowerSGD's ``{"Q", "residual"}``, else an empty tuple."""
    states = {}
    for b in buckets:
        comp = get_compressor(wire_codec(b))
        if not comp.stateful:
            states[b.key] = ()
        elif bucket_sharded(b) and b.hierarchy == _AR.TWO_LEVEL:
            states[b.key] = comp.init_state(b.padded_total, device)
        else:
            states[b.key] = comp.init_state(b.total, device)
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


def fused_wire_hop(collective, src, codec, state, offset=0):
    """The codec's encode -> ``collective`` -> decode around one wire hop.
    The bf16 family casts a flat f32 view of ``src`` to bf16 (the
    error-feedback variant adds the region of its flat f32 residual
    ``state`` that starts at ``offset`` first, and writes the new residual
    back there), runs ``collective`` on the bf16 buffer of ``src``'s shape
    and decodes to f32; any other codec passes ``src`` through at its
    dtype.  Returns (the collective's output, the new state)."""
    if codec not in (_AR.BF16Compressor, _AR.BF16CompressorEF):
        return collective(src), state
    flat = src.reshape(-1).float()
    stateful = codec == _AR.BF16CompressorEF
    n = flat.shape[0]
    corrected = flat + state[offset:offset + n] if stateful else flat
    wire = corrected.to(torch.bfloat16)
    new_state = state
    if stateful:
        residual = corrected - wire.float()
        if n == state.shape[0]:
            new_state = residual
        else:
            new_state = state.clone()
            new_state[offset:offset + n] = residual
    return collective(wire.view(src.shape)).float(), new_state


def _ppermute_ring_sum(buf, axis, codec):
    """Ring all-reduce (sum) over one mesh axis (an ``AxisGroup``) as
    explicit point-to-point steps: ``g - 1`` reduce-scatter steps, each
    sending a 1/g chunk to the next rank, then ``g - 1`` all-gather steps
    forwarding the completed chunks.  The bf16 codec runs the ring on the
    bf16 cast and decodes after."""
    g = axis.size
    if g == 1:
        return buf
    native = buf.dtype
    work = buf.to(torch.bfloat16) if codec == _AR.BF16Compressor else buf
    n = work.shape[0]
    piece = -(-n // g)
    acc = work.new_zeros(piece * g)
    acc[:n] = work
    acc = acc.view(g, piece)
    idx = axis.index
    perm = coll.ring_perm(g)
    for s in range(g - 1):          # reduce-scatter phase
        recv = coll.ppermute(acc[(idx - s) % g], axis.group, perm)
        c_recv = (idx - s - 1) % g
        acc[c_recv] = acc[c_recv] + recv
    # rank idx now owns the fully reduced chunk (idx + 1) % g
    for s in range(g - 1):          # all-gather phase
        recv = coll.ppermute(acc[(idx + 1 - s) % g], axis.group, perm)
        acc[(idx - s) % g] = recv
    out = acc.reshape(-1)[:n]
    return out.to(native) if codec == _AR.BF16Compressor else out


def run_schedule(buf, state, bucket, program, axes=None, impl=None):
    """Run one schedule-IR program on a flat buffer; returns ``(full mean,
    new_state)``, as JAX's ``run_schedule``:

    1. each **reduce_scatter** phase pads the running buffer to a multiple
       of its group size and scatters it through the phase codec, shrinking
       it g-fold; a stateful core's residual is padded and sliced at the
       same offsets (offset = index along the phase's axes x shard), so
       each rank owns the region it will encode;
    2. the optional **core** runs the codec's own ``all_reduce`` over its
       axes (the mean over them) or the explicit ring
       (:func:`_ppermute_ring_sum`, divided by its size); dividing by the
       scattered group sizes then gives the full mean;
    3. each **all_gather** phase mirrors its scatter in reverse, rebuilding
       and unpadding the buffer, through its codec; the residual regions
       are written back outermost last.

    ``axes`` resolves an axis tuple to its ``AxisGroup``; ``impl="plain"``
    runs the codecs' kernels as their plain versions."""
    axes = axes or _one_rank
    scatter, core, gathers = program.split()
    comp = get_compressor(core.codec if core is not None else _AR.NoneCompressor, impl=impl)
    stateful = core is not None and comp.stateful
    cur, st = buf, state
    lens, st_stack, scatter_r = [], [], 1
    for ph in scatter:
        group = axes(ph.axes)
        g, m = group.size, cur.shape[0]
        shard = -(-m // g)
        padded = torch.nn.functional.pad(cur, (0, shard * g - m)) if shard * g > m else cur
        cur, _ = fused_wire_hop(lambda w, group=group: coll.psum_scatter(w, group), padded,
                                ph.codec, ())
        lens.append(m)
        scatter_r *= g
        if stateful:
            st_pad = torch.nn.functional.pad(st, (0, shard * g - st.shape[0]))
            st_stack.append((st_pad, group.index * shard, st.shape[0]))
            st = st_pad[group.index * shard:(group.index + 1) * shard]
    if core is not None:
        group = axes(core.axes)
        if core.op == "all_reduce":
            cur, st = comp.all_reduce(cur, st, group.group)
        else:
            cur = _ppermute_ring_sum(cur, group, core.codec) / group.size
    if scatter_r > 1:
        cur = cur / scatter_r
    for ph, m in zip(gathers, reversed(lens)):
        group = axes(ph.axes)
        out, _ = fused_wire_hop(lambda w, group=group: coll.all_gather_into_tensor(w, group),
                                cur, ph.codec, ())
        cur = out[:m]
    if not stateful:
        return cur, state
    new_state = st
    for st_pad, off, orig in reversed(st_stack):
        st_pad = st_pad.clone()
        st_pad[off:off + new_state.shape[0]] = new_state
        new_state = st_pad[:orig]
    return cur, new_state


def bucket_program(bucket, axis_name, hier: Optional[HierAxes]):
    """The bucket's collective program: an explicit ``schedule_ir`` runs
    verbatim; otherwise the hierarchy knob lowers to its canonical program
    (TWO_LEVEL: scatter, core, gather over the factored mesh; FLAT: one
    all_reduce core over the data axes ``axis_name``)."""
    if bucket.schedule_ir:
        return sir.loads(bucket.schedule_ir)
    if bucket.hierarchy == _AR.TWO_LEVEL:
        if hier is None:
            raise ValueError(f"bucket {bucket.key}: TWO_LEVEL hierarchy but no "
                             f"replica_dcn x replica_ici axes were supplied")
        return sir.two_level_program(hier.ici, hier.dcn, dcn_codec(bucket))
    names = tuple(axis_name) if isinstance(axis_name, (tuple, list)) else (axis_name,)
    return sir.flat_program(names, bucket.compressor)


def _bucket_reduce(buf, state, b, group=None, hier=None, axes=None, impl=None):
    """Reduce one flat buffer by the bucket's collective program: a FLAT
    bucket by its codec's ``all_reduce`` over ``group`` (the canonical
    program's one phase), the others through :func:`run_schedule` (JAX's
    ``_two_level_reduce``, which nothing calls there, is the TWO_LEVEL case
    of this)."""
    if not b.schedule_ir and b.hierarchy != _AR.TWO_LEVEL:
        return get_compressor(b.compressor, impl=impl).all_reduce(buf, state, group)
    return run_schedule(buf, state, b, bucket_program(b, (), hier), axes, impl)


def _scatter_two_level(grads_by_name, b, state, hier, axes):
    """Two-level reduce-scatter of a sharded bucket: the ICI reduce-scatter
    leaves ici index j the rows ``[j * R_dcn, (j + 1) * R_dcn)`` of the
    update matrix, which feed the DCN reduce-scatter directly through the
    DCN codec; dcn index d keeps row ``j * R_dcn + d``.  An error-feedback
    residual lives in the padded row layout; each rank reads and writes its
    ICI region."""
    codec = dcn_codec(b)
    mat = _pack_rows([grads_by_name[n] for n in b.var_names], b)       # (R, S)
    R, S = b.num_shards, mat.shape[1]
    ici, dcn = axes((hier.ici,)), axes(hier.dcn)
    r_dcn = max(1, R // ici.size)
    local = coll.psum_scatter(mat, ici)                                 # (R_dcn, S)
    offset = ici.index * r_dcn * S if get_compressor(codec).stateful else 0
    row, new_state = fused_wire_hop(lambda w: coll.psum_scatter(w, dcn), local, codec,
                                    state, offset=offset)
    row = row.reshape(-1)
    return (row / R if R > 1 else row), new_state


def scatter_bucket(grads_by_name, b, state, group=None, hier=None, axes=None):
    """Reduce-scatter of one sharded-update bucket: ``((shard_total,) mean
    row, new_state)``, this replica's gradient shard, through the bucket's
    codec on the wire (the gradient leg only: the whole bucket for FLAT,
    the DCN hop for TWO_LEVEL)."""
    if b.hierarchy == _AR.TWO_LEVEL:
        if hier is None:
            raise ValueError(f"bucket {b.key}: TWO_LEVEL sharded update but no "
                             f"replica_dcn x replica_ici axes were supplied")
        return _scatter_two_level(grads_by_name, b, state, hier, axes or _one_rank)
    R = b.num_shards
    if b.ps_axes:   # within the PS axes; the shards summed across the others
        axes = axes or _one_rank
        group, other = axes(b.ps_axes), axes(b.other_axes)
        R *= other.size
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
    if b.ps_axes:
        row = coll.psum(row, other)
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


def gather_bucket_params(shards_by_name, b, group=None, out=None, dtype=None, hier=None,
                         axes=None):
    """All-gather one sharded-update bucket's updated flat shards into full
    variables, in the shards' dtype or ``dtype`` (the bf16 master's compute
    copy; a compressed parameter gather would hand the replicas drifting
    copies): written into ``out[name]`` when given, else into new tensors;
    returns them by name.  Under TWO_LEVEL the hops retrace the scatter in
    reverse: the DCN gather of the shards, then the ICI gather of the
    node's rows."""
    srcs = [shards_by_name[n].reshape(-1) for n in b.var_names]
    row = torch.empty(b.shard_total, dtype=dtype or srcs[0].dtype, device=srcs[0].device)
    torch._foreach_copy_(list(row.split(b.shard_sizes)), srcs)   # one launch, cast on the way
    if b.hierarchy == _AR.TWO_LEVEL:
        if hier is None:
            raise ValueError(f"bucket {b.key}: TWO_LEVEL sharded update but no "
                             f"replica_dcn x replica_ici axes were supplied")
        axes = axes or _one_rank
        block = coll.all_gather_into_tensor(row, axes(hier.dcn))
        full = coll.all_gather_into_tensor(block, axes((hier.ici,)))
    else:
        full = coll.all_gather_into_tensor(row, (axes or _one_rank)(b.ps_axes) if b.ps_axes
                                           else group)
    full = full.view(b.num_shards, -1)
    if out is None:
        out = {n: torch.empty(shape, dtype=full.dtype, device=full.device)
               for n, shape in zip(b.var_names, b.shapes)}
    _unpack_rows(full, b.var_names, b.shard_sizes, out)
    return {n: out[n] for n in b.var_names}


def shard_index(b, group=None, hier=None, axes=None):
    """Row of the bucket's ``(num_shards, S)`` update matrix this replica
    owns, in :func:`scatter_bucket`'s order: its rank in the group, or
    under TWO_LEVEL (ICI scatter first, rows ici-major) ``ici * R_dcn +
    dcn``."""
    if b.hierarchy == _AR.TWO_LEVEL:
        if hier is None:
            raise ValueError(f"bucket {b.key}: TWO_LEVEL sharded update but no "
                             f"replica_dcn x replica_ici axes were supplied")
        axes = axes or _one_rank
        ici = axes((hier.ici,))
        return ici.index * max(1, b.num_shards // ici.size) + axes(hier.dcn).index
    if b.ps_axes:
        return (axes or _one_rank)(b.ps_axes).index
    return coll.axis_index(group)


def sync_bucketed(grads_by_name, buckets, comp_states, group=None, impl=None, hier=None,
                  axes=None):
    """All-reduce every bucket through its program (the barrier schedule):
    pack -> reduce -> mean -> unpack.  Returns (synced grads by name, new
    compressor states).  A sharded-update bucket reduce-scatters instead:
    its entries are the per-var ``(ss,)`` update-space shards, not full
    gradients.  ``hier`` realises the TWO_LEVEL buckets; ``impl="plain"``
    runs the codecs' kernels as their plain versions."""
    synced = {}
    new_states = dict(comp_states)
    for b in buckets:
        if bucket_sharded(b):
            row, new_states[b.key] = scatter_bucket(grads_by_name, b, comp_states[b.key],
                                                    group, hier, axes)
            unpack_shard(b, row, grads_by_name, synced)
            continue
        reduced, new_states[b.key] = _bucket_reduce(
            _bucket_buf(grads_by_name, b), comp_states[b.key], b, group, hier, axes, impl)
        _unpack_bucket(b, reduced, grads_by_name, synced)
    return synced, new_states


def sync_hierarchical(grads_by_name, buckets, comp_states, group, hier, axes=None, impl=None):
    """The barrier schedule on a two-level mesh: every TWO_LEVEL bucket runs
    ICI reduce-scatter -> DCN shard all-reduce -> ICI all-gather; FLAT
    buckets (PowerSGD's among them) keep their one collective."""
    if hier is None:
        raise ValueError("sync_hierarchical requires HierAxes (a mesh factored into "
                         "replica_dcn x replica_ici)")
    return sync_bucketed(grads_by_name, buckets, comp_states, group, impl, hier, axes)


def _chunk_sizes(total_elems, dtype, max_bytes):
    """Split ``total_elems`` into contiguous chunks of <= ``max_bytes``."""
    itemsize = getattr(torch, dtype).itemsize
    per_chunk = max(1, int(max_bytes) // itemsize)
    n_chunks = -(-total_elems // per_chunk)
    base = total_elems // n_chunks
    rem = total_elems - base * n_chunks
    return [base + (1 if i < rem else 0) for i in range(n_chunks)]


def bucket_chunks(b, max_chunk_bytes=DEFAULT_BUCKET_BYTES):
    """The element counts the overlap schedule reduces ``b`` in: chunks of
    at most ``max_chunk_bytes`` for an elementwise replicated bucket larger
    than that, else the whole bucket."""
    if (not bucket_sharded(b) and elementwise(b)
            and b.total * getattr(torch, b.dtype).itemsize > max_chunk_bytes):
        return _chunk_sizes(b.total, b.dtype, max_chunk_bytes)
    return [b.total]


def overlap_bucket(grads_by_name, b, state, group=None, max_chunk_bytes=DEFAULT_BUCKET_BYTES,
                   impl=None, hier=None, axes=None):
    """One bucket's sync under the overlap schedule: the sharded update's
    one reduce-scatter (the bucket is the granularity: a chunked scatter
    would break the shard layout), an elementwise bucket chunk by chunk
    (:func:`bucket_chunks`, the residual sliced at the chunks' offsets), a
    block codec's whole-bucket reduce.  Returns (synced entries by name,
    new state)."""
    synced = {}
    if bucket_sharded(b):
        row, new_state = scatter_bucket(grads_by_name, b, state, group, hier, axes)
        unpack_shard(b, row, grads_by_name, synced)
        return synced, new_state
    buf = _bucket_buf(grads_by_name, b)
    sizes = bucket_chunks(b, max_chunk_bytes)
    if len(sizes) == 1:
        reduced, new_state = _bucket_reduce(buf, state, b, group, hier, axes, impl)
    else:
        stateful = get_compressor(wire_codec(b)).stateful
        pieces, state_pieces, off = [], [], 0
        for sz in sizes:
            red, nst = _bucket_reduce(buf[off:off + sz], state[off:off + sz] if stateful
                                      else state, b, group, hier, axes, impl)
            pieces.append(red)
            state_pieces.append(nst)
            off += sz
        reduced = torch.cat(pieces)
        new_state = torch.cat(state_pieces) if stateful else state
    _unpack_bucket(b, reduced, grads_by_name, synced)
    return synced, new_state


def sync_overlapped(grads_by_name, buckets, comp_states, group=None,
                    max_chunk_bytes=DEFAULT_BUCKET_BYTES, impl=None, hier=None, axes=None):
    """The overlap schedule after the backward pass: every bucket in reverse
    order through :func:`overlap_bucket`.  Numerically equal to
    :func:`sync_bucketed` (the chunks of an elementwise codec reduce element
    for element as the fused buffer does)."""
    synced = {}
    new_states = dict(comp_states)
    for b in reversed(buckets):
        out, new_states[b.key] = overlap_bucket(grads_by_name, b, comp_states[b.key], group,
                                                max_chunk_bytes, impl, hier, axes)
        synced.update(out)
    return synced, new_states


class OverlapPass:
    """The overlap schedule inside one backward pass: a hook on every
    parameter of ``buckets`` (:meth:`attached`) records its gradient (cast to
    f32 for the names in ``upcast``, the bf16 master's compute copies),
    and once all of a bucket's gradients are in, the bucket's sync
    (:func:`overlap_bucket`) is issued, in reverse bucket order: bucket k
    only after every bucket before it in that order, as DDP does, so that
    every rank issues the same collectives in the same order whatever
    order its backward completes them in.  :meth:`finish` issues what no
    hook did, waits, and returns the synced entries and the new codec
    states.

    On CUDA a hook runs on the autograd engine's device thread, between
    the backward's kernels.  A bucket's sync is a chain (the two-level
    program's three hops, the int8 codec's exchange, hop and gather), and
    a collective's ``wait`` makes the current stream wait: on the compute
    stream that would stall the backward behind each hop.  So the sync
    runs on a stream of its own (``stream``), ordered after the kernels
    that produced the gradients (``wait_stream`` at issue), its
    collectives ordered by that stream; the compute stream waits for it
    once, in :meth:`finish`, before the clip and the update.  The
    gradients stay referenced until then, so their memory is not reused
    while the sync stream still reads it."""

    def __init__(self, buckets, comp_states, group=None, hier=None, axes=None, impl=None,
                 max_chunk_bytes=DEFAULT_BUCKET_BYTES, upcast=frozenset(), stream=None):
        self.order = list(reversed(buckets))
        self.states = dict(comp_states)
        self.synced = {}
        self.grads = {}
        self.issued = []      # (bucket key, chunks) in issue order
        self.issued_in_backward = 0
        self._args = dict(group=group, max_chunk_bytes=max_chunk_bytes, impl=impl, hier=hier,
                          axes=axes)
        self._upcast = upcast
        self._stream = stream
        self._next = 0
        self._waiting = {b.key: set(b.var_names) for b in self.order}
        self._bucket_of = {n: b.key for b in self.order for n in b.var_names}

    @contextlib.contextmanager
    def attached(self, params_by_name):
        """While open, a hook on every bucket parameter among
        ``params_by_name`` (the leaf tensors the backward pass
        differentiates)."""
        hooks = [params_by_name[name].register_hook(functools.partial(self._on_grad, name))
                 for name in self._bucket_of]
        try:
            yield self
        finally:
            for h in hooks:
                h.remove()

    def _on_grad(self, name, grad):
        self.grads[name] = grad.float() if name in self._upcast else grad
        self._waiting[self._bucket_of[name]].discard(name)
        while self._next < len(self.order) and not self._waiting[self.order[self._next].key]:
            self._issue(self.order[self._next])
        # returns None: the gradient itself is unchanged

    def _issue(self, b):
        stream = self._stream
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            out, self.states[b.key] = overlap_bucket(self.grads, b, self.states[b.key],
                                                     **self._args)
        self.synced.update(out)
        self.issued.append((b.key, len(bucket_chunks(b, self._args["max_chunk_bytes"]))))
        self._next += 1

    def finish(self, grads_by_name):
        """After the backward pass: issue the buckets no hook issued, from
        ``grads_by_name`` (f32 for ``upcast`` names), and make the current
        stream wait for the sync; returns (synced entries by name, new codec
        states)."""
        self.issued_in_backward = self._next
        for name, g in grads_by_name.items():
            self.grads.setdefault(name, g)
        while self._next < len(self.order):
            self._issue(self.order[self._next])
        if self._stream is not None:
            torch.cuda.current_stream().wait_stream(self._stream)
        self.grads = {}
        return self.synced, self.states


def schedule_mode(plans):
    """Engine-level issue schedule: ``"overlap"`` when any dense
    AllReduce-replicated plan asks for ``Schedule.OVERLAP``, else
    ``"barrier"``."""
    from autodist_tpu_torch.kernel.partitioner import Placement, SyncKind

    for plan in plans.values():
        if (plan.sync == SyncKind.ALL_REDUCE and plan.placement == Placement.REPLICATED
                and not plan.sparse and plan.schedule == _AR.OVERLAP):
            return "overlap"
    return "barrier"
