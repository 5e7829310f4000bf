"""GraphTransformer: the compiled strategy -> state and the training step.

Counterpart of ``autodist_tpu/kernel/graph_transformer.py`` (``init_state``
and the train step of ``_spmd_step``) for the plans the port realises
(:mod:`autodist_tpu_torch.kernel.partitioner`): REPLICATED storage
synchronised by the bucketed all-reduce; weight-update sharding, the
synchronous PS's (over every data axis, or a subset of them) and the
AllReduce family's ``sharded_update`` (with or without
``precision="bf16_master"``); SHARDED storage of partitioned variables;
DIVERGENT copies (a PS with ``staleness > 0``); sparse variables synced in
their lookups.  Each process runs one replica
on its slice of the global batch; the replicas meet in the collectives of
``world.group`` and of its axis groups
(:mod:`autodist_tpu_torch.parallel.mesh`).  One step is

1. materialise (:meth:`GraphTransformer.materialize`): the stored
   full-shape parameters are what the loss sees.  A bf16-master bucket
   stores its f32 master only as the flat shards (``state["shards"]``);
   its full-shape parameters in ``state["params"]`` are a bf16 compute
   copy, all-gathered per bucket from the bf16 cast of the shards here,
   at the top of the step (:meth:`GraphTransformer.gather_compute_copies`).
   A SHARDED variable stores this replica's block of its partition axis,
   padded to a multiple of R; the loss sees the blocks all-gathered and
   cut to the variable's shape, or, for a sparse table split on dim 0,
   the block itself as a :class:`~autodist_tpu_torch.ops.sparse.ShardedTable`;
2. value and gradient (:meth:`GraphTransformer.gradients`):
   ``loss_fn(params, batch[, generator])``, then ``torch.autograd.grad``
   with respect to the parameters.  With ``accum_steps = A > 1`` the
   replica's batch splits into A microbatches along dim 0, each taking
   its own value and gradient, and the loss, gradients and aux are their
   means; the mutable state threads through them.  With ``has_rng`` the
   generator is folded from (seed, step), over more than one replica the
   rank, and at A > 1 the microbatch index
   (:func:`autodist_tpu_torch.utils.rng.step_generator`).  The gradients
   of a bf16 compute copy are cast to f32 at once, so the accumulation,
   the sync and the update run at the master's precision.  With mutable
   state the call is ``loss_fn(params, mutable, batch[, generator]) ->
   (loss, new_mutable)``; the new state is stored detached, after the
   cross-replica mean of its float leaves (:func:`replica_mean_state`).
   With ``has_aux`` the loss comes with a dict of aux values (``(loss,
   aux)``, or ``(loss, (new_mutable, aux))``).  A batch with a
   ``BATCH_MASK_KEY`` leaf (an uneven global batch, padded by the session)
   scales each microbatch's loss by ``sum(mask) * R * A / max(S, 1)``, S
   the real rows over all replicas, so that the means below are the
   weighted mean over the real examples;
3. sync: every bucket through its program and codec, whose state rides in
   ``state["comp"]`` (:meth:`GraphTransformer.sync`): the schedule
   ``"barrier"`` syncs every bucket after the backward pass
   (:func:`sync_bucketed`); ``"overlap"`` issues each AllReduce bucket's
   sync from autograd hooks during the backward pass, in reverse bucket
   order, the elementwise codecs in ``DEFAULT_BUCKET_BYTES`` chunks
   (:class:`~autodist_tpu_torch.kernel.synchronization.all_reduce.OverlapPass`),
   and waits for them before the clip and the update.  With ``accum_steps
   > 1`` the overlap schedule syncs the elementwise buckets in every
   microbatch's backward pass and accumulates the mean of their partial
   means; the block-codec buckets accumulate the gradients and sync once
   after the microbatches, as JAX's in-scan overlap does.  On a
   ``{replica_dcn, replica_ici}`` mesh the hierarchy resolves as JAX's
   (AUTO is TWO_LEVEL when ``replica_dcn > 1``; a DCN codec that is not
   DCN-safe raises; PowerSGD stays FLAT; a ``schedule_ir`` canonical to
   FLAT or TWO_LEVEL is pinned back to those knobs, any other runs
   verbatim), and a TWO_LEVEL bucket runs ICI reduce-scatter -> DCN shard
   all-reduce -> ICI all-gather.
   The loss runs inside :func:`~autodist_tpu_torch.ops.sparse.
   replica_axis_context`, so a sparse variable's lookup syncs its rows in
   the backward pass and no bucket holds it.
   The dense PS variables form one bucket per dtype (and PS axes), without
   a codec; a PS over a subset of the data axes scatters within them and
   sums the shards over the others.  A
   sharded bucket (a PS group, or AllReduce's ``sharded_update``)
   reduce-scatters: each variable's zero-padded flat gradient as an
   ``(R, ceil(n/R))`` matrix, the bucket's matrices side by side, so that
   replica r receives row r, its shard of every variable, summed over the
   replicas and divided by R, the codec on this gradient leg only;
   :meth:`GraphTransformer.update` runs this step and the next two.  A
   DIVERGENT variable's gradient joins no bucket: the replica's own (a
   sparse one's comes synced from its lookup, as in JAX);
4. with ``clip_global_norm``, the true global norm over the update spaces
   (a PS shard's squared sum summed over the replicas, an AllReduce
   gradient counted once, a DIVERGENT one's squared sum averaged over the
   replicas) scales every gradient by ``min(1, max_norm /
   max(norm, 1e-12))`` and is reported as ``grad_norm``;
5. optimizer update: the replicated AllReduce variables in place in
   storage; a SHARDED variable on its block, its gradient reduce-scattered
   along the partition axis (a sparse one's sliced from the synced
   gradient, or the row exchange's block gradient); a sparse PS
   variable on its flat shard of the synced gradient, gathered back by a
   bucket of its own; the PS and sharded-update variables on their flat shards
   (``state["shards"]``, separate leaf tensors, so the optimizer state
   lives sharded too), whose updated values come back by one all-gather
   per sharded bucket, in the shards' dtype
   (:meth:`GraphTransformer.gather_buckets`), and are written into
   storage.  A bf16-master bucket has no gather here: its fresh f32
   shards are the new storage, and the next step's top gather rebuilds
   its compute copy.  A DIVERGENT variable updates its own copy in
   place; on a step that ends its period (``(step + 1) % sync_period ==
   0``, the step counted before this one, so every rank agrees) the
   copies are averaged over the replicas, one all-reduce per period and
   dtype (none at R = 1).  Its optimizer state stays the rank's own and
   is never averaged.

On a mesh with a ``seq`` axis and more than one axis (``{"replica": R_d,
"seq": R_s}``, even at ``seq: 1``, as in JAX) sequence parallelism is on:
each rank holds one sequence block of its data slice, the loss runs inside
:func:`~autodist_tpu_torch.parallel.context.seq_axis_context` (so GPT's
attention takes the ring over the rank's seq row and its positions start
at the block's global offset), and the gradients and the loss are still
averaged over every rank.

It returns the metrics ``{"loss", "step"}``, the loss the mean over the
replicas (the JAX step's ``pmean(loss)``), with ``grad_norm`` when
clipping and every aux value's mean over the replicas.
"""
import contextlib
import dataclasses
import functools
import math
from collections import OrderedDict

import torch

from autodist_tpu_torch.const import (AXIS_REPLICA_DCN, AXIS_REPLICA_ICI, BATCH_MASK_KEY,
                                      DEFAULT_BUCKET_BYTES)
from autodist_tpu_torch.kernel import partitioner as part
from autodist_tpu_torch.kernel.synchronization import all_reduce as ar_sync
from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
from autodist_tpu_torch.model_item import dtype_name
from autodist_tpu_torch.ops.sparse import ShardedTable, replica_axis_context
from autodist_tpu_torch.parallel import collectives as coll
from autodist_tpu_torch.parallel.context import seq_axis_context
from autodist_tpu_torch.parallel.mesh import ReplicaWorld, check_replicas
from autodist_tpu_torch.kernel.synchronization.all_reduce import padded_rows
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.rng import step_generator
from autodist_tpu_torch.utils.tree import map_batch

_AR = ar_sync._AR


def _pad_axis(x, axis, size):
    """``x`` zero-padded at the end of ``axis`` to ``size`` (JAX
    ``_pad_axis``)."""
    pad = size - x.shape[axis]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def replica_mean_state(new_state, group=None):
    """The stored new mutable state: every leaf detached, float leaves (batch
    statistics) averaged over the replicas as the JAX step's ``pmean``
    (``kernel/graph_transformer.py:1226-1231``); integer leaves as they are."""
    return OrderedDict(
        (n, coll.pmean(t.detach(), group) if t.is_floating_point()
         else t.detach()) for n, t in new_state.items())


def microbatches(batch, count):
    """``count`` microbatches of a replica's batch: row block i of every
    leaf's dim 0, in the batch's structure.  A leaf with fewer rows than
    ``count``, or a row count ``count`` does not divide, raises."""
    def check(leaf, path):
        n = leaf.shape[0] if leaf.dim() else 0
        if n < count or n % count:
            raise ValueError(f"{path} of shape {tuple(leaf.shape)}: the per-replica "
                             f"batch ({n} rows) must divide by accum_steps={count}")

    map_batch(check, batch)
    return [map_batch(lambda leaf, _, i=i: leaf.chunk(count)[i], batch)
            for i in range(count)]


def load_slots(optimizer, slots):
    """Load per-parameter ``slots`` (a ``state_dict()["state"]``) into a
    ``torch.optim`` optimizer, its hyperparameters kept."""
    optimizer.load_state_dict({"state": slots,
                               "param_groups": optimizer.state_dict()["param_groups"]})


class GraphTransformer:
    """Builds the session state and the training step of one replica."""

    def __init__(self, strategy, model_item, device, world=None, accum_steps=1,
                 clip_global_norm=None, sync_schedule=None):
        self.strategy = strategy
        self.model_item = model_item
        self.device = torch.device(device)
        self.world = world or ReplicaWorld(rank=0, size=1)
        self.num_replicas = max(1, len(strategy.graph_config.replicas))
        check_replicas(self.num_replicas, self.world)
        self.group = self.world.group
        # an axis tuple -> its AxisGroup, resolved once
        self.axes = functools.lru_cache(maxsize=None)(self.world.axis_group)
        # sequence parallelism: set on the world by parallel.mesh.mesh_world
        self.seq_axis = self.world.seq
        if model_item.optimizer is None:
            raise ValueError("ModelItem has no optimizer")
        self.accum_steps = int(accum_steps)
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.clip_global_norm = clip_global_norm
        self.names = model_item.var_names
        self.plans = part.build_var_plans(strategy, model_item, self.num_replicas)
        for name in self.names:
            if name not in self.plans:
                raise ValueError(f"No plan for variable {name}")
        mesh = strategy.graph_config.mesh
        data_axes = tuple(mesh.axis_names)
        axis_sizes = dict(zip(data_axes, (int(x) for x in mesh.axis_sizes)))
        self.data_axes, self.axis_sizes = data_axes, axis_sizes
        self._normalise_ps_axes(data_axes)
        # the two-level split: the ICI sub-axis, and the cross-node hop over
        # every other data axis
        self.hier_spec = None
        if AXIS_REPLICA_DCN in data_axes and AXIS_REPLICA_ICI in data_axes:
            self.hier_spec = ar_sync.HierAxes(
                ici=AXIS_REPLICA_ICI, dcn=tuple(a for a in data_axes if a != AXIS_REPLICA_ICI))
        self._normalise_hierarchy(data_axes, axis_sizes)
        self._normalise_sharded_update()
        # fused PS groups: the dtype (and the PS axes of a subset, as
        # "float32_replica_ici") -> the names of its dense flat-shard vars
        self.ps_groups = OrderedDict()
        for name in self.names:
            plan = self.plans[name]
            if (plan.sync == part.SyncKind.PS and part.flat_shard_update(plan)
                    and not plan.sparse):
                key = "_".join((dtype_name(plan.dtype),) + (plan.ps_axes or ()))
                self.ps_groups.setdefault(key, []).append(name)
        # the AllReduce buckets, then each PS group as a sharded bucket
        # without a codec
        self.buckets = ar_sync.plan_buckets(
            self.plans, {n: self.plans[n].shape for n in self.names},
            {n: self.plans[n].dtype for n in self.names}, num_replicas=self.num_replicas)
        self.buckets += [self._ps_bucket(f"ps_{key}", names)
                         for key, names in self.ps_groups.items()]
        # a sparse PS variable's gradient comes synced from its lookup: its
        # flat shard is sliced from it, and a bucket of its own gathers the
        # updated shards (it takes no part in the sync)
        self.sparse_ps_buckets = [
            self._ps_bucket(f"ps_sparse_{n}", [n]) for n in self.names
            if self.plans[n].sync == part.SyncKind.PS and self.plans[n].sparse
            and part.flat_shard_update(self.plans[n])]
        # SHARDED storage: this replica's block of the padded partition axis
        self.sharded_names = [n for n in self.names
                              if self.plans[n].placement == part.Placement.SHARDED]
        self.sharded_buckets = [b for b in self.buckets if ar_sync.bucket_sharded(b)]
        # DIVERGENT copies, by (sync period, dtype): each group's copies are
        # averaged by one all-reduce on the steps that end its period
        self.divergent_names = [n for n in self.names
                                if self.plans[n].placement == part.Placement.DIVERGENT]
        self.divergent_groups = OrderedDict()
        for n in self.divergent_names:
            key = (self.plans[n].sync_period, dtype_name(self.plans[n].dtype))
            self.divergent_groups.setdefault(key, []).append(n)
        # bf16-master buckets: the f32 master lives only as the flat shards
        self.precision_buckets = [b for b in self.sharded_buckets if b.precision]
        self._prec_names = frozenset(n for b in self.precision_buckets for n in b.var_names)
        # every flat-shard var's ceil(n / R)
        self.shard_len = {n: ss for b in self.sharded_buckets + self.sparse_ps_buckets
                          for n, ss in zip(b.var_names, b.shard_sizes)}
        # the issue schedule: "overlap" syncs AllReduce buckets from hooks in
        # the backward pass (all of them, or at accum_steps > 1 the
        # elementwise ones), "barrier" every bucket after it
        if sync_schedule is None:
            sync_schedule = ar_sync.schedule_mode(self.plans)
        if sync_schedule not in ("overlap", "barrier"):
            raise ValueError(f"sync_schedule must be 'overlap' or 'barrier', got "
                             f"{sync_schedule!r}")
        self.sync_schedule = sync_schedule
        self.hook_buckets = []
        if sync_schedule == "overlap":
            self.hook_buckets = [b for b in self.buckets if not b.key.startswith("ps_")
                                 and (self.accum_steps == 1 or ar_sync.elementwise(b))]
        self.post_buckets = [b for b in self.buckets if b not in self.hook_buckets]
        self.max_chunk_bytes = DEFAULT_BUCKET_BYTES   # the overlap schedule's chunks
        self._sync_stream = (torch.cuda.Stream(self.device)
                             if self.hook_buckets and self.device.type == "cuda" else None)
        self.last_overlap = None   # the last backward pass's OverlapPass
        logging.info("Transform plan: %d vars, %d buckets (%s schedule, %s hierarchy, %d "
                     "sharded)", len(self.names), len(self.buckets), self.sync_schedule,
                     self.sync_hierarchy, len(self.sharded_buckets))

    def _normalise_hierarchy(self, data_axes, axis_sizes):
        """JAX's hierarchy resolution (``graph_transformer.py:124-189``): a
        ``schedule_ir`` is validated against the mesh, and a program
        canonical to FLAT or TWO_LEVEL is pinned back to those knobs (its
        core codec the compressor, or the DCN codec); any other keeps its
        program with FLAT knobs.  TWO_LEVEL needs the two-level axes; AUTO
        is TWO_LEVEL on them when ``replica_dcn > 1``, else FLAT; a DCN
        codec that is not DCN-safe raises, and PowerSGD stays FLAT."""
        hier = self.hier_spec
        for name in self.names:
            plan = self.plans[name]
            if (plan.sync != part.SyncKind.ALL_REDUCE
                    or plan.placement != part.Placement.REPLICATED or plan.sparse):
                continue
            if plan.schedule_ir:
                try:
                    prog = sir.loads(plan.schedule_ir)
                    sir.validate(prog, data_axes=data_axes, axis_sizes=axis_sizes)
                except ValueError as e:
                    raise ValueError(f"{name!r}: invalid schedule_ir: {e}") from None
                kind, core = sir.canonical_hierarchy(prog), sir.core_codec(prog)
                if kind == _AR.FLAT:
                    plan.schedule_ir, plan.hierarchy = "", _AR.FLAT
                    plan.compressor, plan.dcn_compressor = core, 0
                elif (kind == _AR.TWO_LEVEL and hier is not None
                      and prog.phases[0].axes == (hier.ici,)
                      and set(prog.phases[1].axes) == set(hier.dcn)
                      and (core or not plan.compressor)):
                    plan.schedule_ir, plan.hierarchy = "", _AR.TWO_LEVEL
                    plan.dcn_compressor = core
                else:   # runs verbatim: no two-level branch on these buckets
                    plan.hierarchy, plan.dcn_compressor = _AR.FLAT, 0
                    continue
            h = plan.hierarchy
            if h == _AR.TWO_LEVEL and hier is None:
                raise ValueError(
                    f"{name!r}: hierarchy=TWO_LEVEL needs a mesh factored into "
                    f"'{AXIS_REPLICA_DCN}' x '{AXIS_REPLICA_ICI}' data sub-axes (a `mesh:` "
                    f"request, or a spec of several hosts); mesh axes are {list(data_axes)}")
            if h == _AR.AUTO_HIERARCHY:
                h = (_AR.TWO_LEVEL if hier is not None
                     and axis_sizes[AXIS_REPLICA_DCN] > 1 else _AR.FLAT)
            if h == _AR.TWO_LEVEL:
                if plan.dcn_compressor not in (0, *ar_sync.DCN_SAFE_CODECS):
                    raise ValueError(
                        f"{name!r}: dcn_compressor {plan.dcn_compressor} is not DCN-hop "
                        f"safe; the cross-slice hop accepts only elementwise codecs "
                        f"(none/bf16/bf16-EF) and int8 — block codecs like PowerSGD do "
                        f"not decompose into a shard hop")
                if plan.compressor == _AR.PowerSGDCompressor:
                    h = _AR.FLAT   # its factor exchange never decomposes
            plan.hierarchy = h

    @property
    def sync_hierarchy(self):
        """``"searched"`` when a bucket runs an explicit schedule IR,
        ``"two_level"`` when one runs the two-level program, else
        ``"flat"``."""
        if any(b.schedule_ir for b in self.buckets):
            return "searched"
        return ("two_level" if any(b.hierarchy == _AR.TWO_LEVEL for b in self.buckets)
                else "flat")

    def _normalise_sharded_update(self):
        """JAX's eligibility pass: a plan that asks for the sharded update
        but cannot realise it (a block codec, a scalar) keeps the
        replicated update; a bf16-master plan that is not f32 or has no
        realised sharded update keeps F32.  Both are logged, never errors."""
        for name in self.names:
            plan = self.plans[name]
            if plan.sharded_update and not part.plan_sharded_update(plan):
                logging.debug("Variable %s: sharded_update requested but the wire codec "
                              "is not elementwise; realising the replicated update", name)
                plan.sharded_update = 0
        for name in self.names:
            plan = self.plans[name]
            if plan.precision and not part.master_shard_storage(plan):
                logging.debug("Variable %s: precision=bf16_master requested but the plan "
                              "is not eligible (needs f32 and a realised sharded update); "
                              "keeping F32", name)
                plan.precision = 0

    @property
    def sync_sharded_update(self):
        """True when any AllReduce bucket realises the sharded update."""
        return any(not b.key.startswith("ps_") for b in self.sharded_buckets)

    @property
    def sync_mixed_precision(self):
        """True when any AllReduce bucket runs bf16 compute / f32 master."""
        return bool(self.precision_buckets)

    def sharded_update_summary(self):
        """Static accounting of the sharded buckets, JAX's for AllReduce's
        sharded update (PS groups count too): the per-replica update-space
        bytes, the per-replica padding bytes, and the parameter all-gather's
        bytes (the bf16 compute copy's half for bf16-master buckets)."""
        out = {"enabled": self.sync_sharded_update,
               "buckets": len(self.sharded_buckets),
               "vars": sum(len(b.var_names) for b in self.sharded_buckets),
               "num_shards": (self.sharded_buckets[0].num_shards
                              if self.sharded_buckets else 1),
               "shard_bytes": 0.0, "padding_bytes": 0.0, "param_gather_bytes": 0.0,
               "bf16_master_buckets": len(self.precision_buckets),
               "bf16_master_vars": sum(len(b.var_names) for b in self.precision_buckets)}
        for b in self.sharded_buckets:
            item = getattr(torch, b.dtype).itemsize
            out["shard_bytes"] += b.shard_total * item
            out["padding_bytes"] += (b.padded_total - b.total) * item / b.num_shards
            out["param_gather_bytes"] += b.padded_total * item * (0.5 if b.precision else 1.0)
        return out

    def _normalise_ps_axes(self, data_axes):
        """A PS destination ``mesh:<axes>`` (JAX ``graph_transformer.py:
        284-298``): axes that are no data axes raise; every data axis is
        the default realisation; a subset is kept, in the mesh's order."""
        for name, plan in self.plans.items():
            if plan.sync != part.SyncKind.PS or not plan.ps_axes:
                continue
            bad = set(plan.ps_axes) - set(data_axes)
            if bad:
                raise ValueError(f"{name!r}: ps_axes {sorted(bad)} are not data axes "
                                 f"{data_axes} of the mesh")
            axes = tuple(a for a in data_axes if a in plan.ps_axes)
            plan.ps_axes = None if axes == data_axes else axes

    def _R_for(self, plan):
        """The replicas a flat-shard PS plan's update space shards over:
        its PS axes' size, else every replica."""
        if plan.ps_axes and plan.placement == part.Placement.REPLICATED:
            return math.prod(self.axis_sizes[a] for a in plan.ps_axes)
        return self.num_replicas

    def _ps_bucket(self, key, names):
        """A sharded bucket without a codec over the PS variables ``names``
        (one dtype and one ``ps_axes``)."""
        plan = self.plans[names[0]]
        r = self._R_for(plan)
        axes = plan.ps_axes or ()
        return ar_sync.Bucket(
            key=key, var_names=tuple(names),
            sizes=tuple(math.prod(self.plans[n].shape) for n in names),
            shapes=tuple(tuple(self.plans[n].shape) for n in names), compressor=0,
            dtype=dtype_name(plan.dtype), sharded_update=1, num_shards=r,
            shard_sizes=tuple(part.shard_len(self.plans[n], r) for n in names),
            ps_axes=axes, other_axes=tuple(a for a in self.data_axes if a not in axes)
            if axes else ())

    def _shard(self, param, name, b, row):
        """Row ``row`` of ``param``'s flat shards in bucket ``b``: elements
        ``[row * ss, (row + 1) * ss)`` of its flat form zero-padded to ``ss *
        R``, R the replicas the bucket shards over."""
        rows = padded_rows(param.detach(), b.num_shards, self.shard_len[name])
        return rows[row].clone()

    def _block(self, t, plan):
        """This replica's block of ``t``, a SHARDED variable or a tensor of
        its shape: rows ``[i * blk, (i + 1) * blk)`` of the partition axis,
        zero-padded to ``blk = padded_dim / R``, copied to the device from
        that slice alone (the full variable is never copied)."""
        axis, blk = plan.partition_axis, plan.padded_dim // self.num_replicas
        start = min(self.world.rank * blk, plan.shape[axis])
        piece = t.detach().narrow(axis, start, min(blk, plan.shape[axis] - start))
        return _pad_axis(piece.to(self.device, copy=True), axis, blk)

    def _gather_block(self, block, plan):
        """The full variable from every replica's block: the all-gather of
        the partition axis, its padding cut off."""
        axis = plan.partition_axis
        full = coll.all_gather_into_tensor(block.detach().movedim(axis, 0), self.group)
        return full[:plan.shape[axis]].movedim(0, axis)

    def _scatter_block(self, grad, plan):
        """This replica's block of the replicas' mean of a full gradient:
        the partition axis zero-padded, reduce-scattered, divided by R."""
        axis = plan.partition_axis
        g = _pad_axis(grad, axis, plan.padded_dim).movedim(axis, 0)
        out = coll.psum_scatter(g, self.group).movedim(0, axis)
        return out / self.num_replicas if self.num_replicas > 1 else out

    def _flat_bucket(self, name):
        """The sharded bucket of flat-shard variable ``name``, narrowed to it."""
        b = next(b for b in self.sharded_buckets + self.sparse_ps_buckets
                 if name in b.var_names)
        i = b.var_names.index(name)
        return dataclasses.replace(b, var_names=(name,), sizes=(b.sizes[i],),
                                   shapes=(b.shapes[i],), shard_sizes=(b.shard_sizes[i],))

    def shard_row(self, name):
        """The row of flat-shard variable ``name``'s ``(R, ceil(n/R))``
        padded matrix that this replica holds
        (:func:`~autodist_tpu_torch.kernel.synchronization.all_reduce.shard_index`)."""
        return ar_sync.shard_index(self._flat_bucket(name), self.group, self.hier_spec,
                                   self.axes)

    def canonical_leaf(self, leaf, name):
        """Variable ``name``'s update-space tensor on this replica (its
        stored block, its flat shard, or an optimizer moment of that shape)
        -> the variable's full, unpadded shape, as the single-device program
        holds it (JAX ``_canon_leaf``): blocks and flat shards gathered over
        the replicas, a DIVERGENT copy (or moment) averaged over them; each
        is a collective, which every rank calls.  A tensor of another shape
        (a scalar statistic) comes back as it is."""
        plan = self.plans[name]
        with torch.no_grad():
            if plan.placement == part.Placement.DIVERGENT:
                return (coll.pmean(leaf.detach(), self.group)
                        if tuple(leaf.shape) == tuple(plan.shape) else leaf)
            if plan.placement == part.Placement.SHARDED:
                blk = list(plan.shape)
                blk[plan.partition_axis] = plan.padded_dim // self.num_replicas
                return self._gather_block(leaf, plan) if list(leaf.shape) == blk else leaf
            if name in self.shard_len and tuple(leaf.shape) == (self.shard_len[name],):
                return ar_sync.gather_bucket_params({name: leaf}, self._flat_bucket(name),
                                                    self.group, hier=self.hier_spec,
                                                    axes=self.axes)[name]
        return leaf

    def uncanonical_leaf(self, full, name):
        """The inverse of :meth:`canonical_leaf` (JAX ``_uncanon_leaf``): a
        tensor of variable ``name``'s shape -> this replica's piece of its
        update space (its block, its flat shard, or for a DIVERGENT
        variable a copy of it); another shape as it is."""
        plan = self.plans[name]
        if tuple(full.shape) != tuple(plan.shape):
            return full
        if plan.placement == part.Placement.DIVERGENT:
            return full.detach().clone()
        if plan.placement == part.Placement.SHARDED:
            return self._block(full, plan)
        if name in self.shard_len:
            rows = padded_rows(full.detach(), self._flat_bucket(name).num_shards,
                               self.shard_len[name])
            return rows[self.shard_row(name)].clone()
        return full

    def init_state(self, seed=0):
        """The session state: stored parameters (fresh copies on the device,
        never aliasing the caller's tensors; a bf16-master variable's is
        its bf16 compute copy, a SHARDED variable's this replica's block),
        the flat shards of the PS and
        sharded-update variables (a bf16-master variable's f32 master),
        the optimizer over the update spaces (the shards where there are,
        else the stored tensors), codec state, the step counter and the
        rng seed."""
        params = self.model_item.params
        full = OrderedDict(
            (n, self._block(params[n], self.plans[n]) if n in self.sharded_names
             else params[n].detach().to(self.device, copy=True)) for n in self.names)
        shards = {}
        for b in self.sharded_buckets + self.sparse_ps_buckets:
            row = ar_sync.shard_index(b, self.group, self.hier_spec, self.axes)
            shards.update((n, self._shard(full[n], n, b, row)) for n in b.var_names)
        shards = OrderedDict((n, shards[n]) for n in self.names if n in shards)
        storage = OrderedDict(
            (n, (t.to(torch.bfloat16) if n in self._prec_names else t).requires_grad_(True))
            for n, t in full.items())
        del full
        update_space = [shards.get(n, storage[n]) for n in self.names]
        return {
            "params": storage,
            "shards": shards,
            "opt_state": self.model_item.optimizer.create(update_space),
            "comp": ar_sync.init_compressor_states(self.buckets, self.device),
            "step": 0,
            "rng": int(seed),
            "mutable": None if self.model_item.mutable_state is None else OrderedDict(
                (n, t.detach().to(self.device, copy=True))
                for n, t in self.model_item.mutable_state.items()),
        }

    def _call_loss(self, storage, mutable, batch, generator):
        """``loss_fn`` on one (micro)batch -> (loss, new_mutable, aux)."""
        item = self.model_item
        args = (storage, batch) if mutable is None else (storage, mutable, batch)
        if generator is not None:
            args += (generator,)
        out = item.loss_fn(*args)
        new_mutable, aux = None, {}
        if mutable is not None:
            loss, rest = out
            new_mutable, aux = rest if item.has_aux else (rest, {})
        elif item.has_aux:
            loss, aux = out
        else:
            loss = out
        return loss, new_mutable, aux

    def materialize(self, state):
        """(what the loss sees by name, the tensors its gradients are taken
        of, in name order): a stored tensor as it is; a SHARDED variable
        gathered and cut to its shape, as a new leaf (its gradient is
        reduce-scattered in :meth:`update`), or for a sparse table split on
        dim 0 its block as a :class:`ShardedTable` (the gradient is the
        block's)."""
        seen, leaves = OrderedDict(), []
        for name, t in state["params"].items():
            plan = self.plans[name]
            if plan.placement != part.Placement.SHARDED:
                seen[name] = t
            elif plan.sparse and plan.partition_axis == 0:
                seen[name] = ShardedTable(t, self.group, plan.shape)
            else:
                with torch.no_grad():
                    t = self._gather_block(t, plan)
                seen[name] = t.requires_grad_(True)
            leaves.append(t)
        return seen, leaves

    def gradients(self, state, batch):
        """This replica's loss, new mutable state (None without one),
        gradients by name and aux values at ``state``, on its batch slice
        (every microbatch's, averaged); changes nothing."""
        loss, mutable, grads, aux, _ = self._gradients(state, batch, ())
        return loss, mutable, grads, aux

    def _gradients(self, state, batch, hook_buckets):
        """:meth:`gradients`, with the syncs of ``hook_buckets`` issued from
        hooks in each microbatch's backward pass (the overlap schedule):
        their variables' entries come back synced, averaged over the
        microbatches (the mean of partial means), as the fifth value, and
        their codec states are updated in ``state["comp"]``; the gradients
        returned are the other variables'."""
        item = self.model_item
        storage, params = self.materialize(state)
        mutable = state["mutable"]
        A = self.accum_steps
        real = None
        if isinstance(batch, dict) and BATCH_MASK_KEY in batch:
            real = coll.psum(batch[BATCH_MASK_KEY].float().sum(), self.group)
        replica = self.world.rank if self.num_replicas > 1 else None
        hooked = frozenset(n for b in hook_buckets for n in b.var_names)
        comp = {b.key: state["comp"][b.key] for b in hook_buckets}
        loss = grads = synced = None
        auxs = []
        with seq_axis_context(self.seq_axis), replica_axis_context(self.group):
            for i, mb in enumerate([batch] if A == 1 else microbatches(batch, A)):
                generator = None
                if item.has_rng:
                    generator = step_generator(state["rng"], state["step"], self.device,
                                               replica, micro=i if A > 1 else None)
                mb_loss, new_mutable, aux = self._call_loss(storage, mutable, mb, generator)
                if real is not None:
                    mb_loss = mb_loss * (mb[BATCH_MASK_KEY].float().sum()
                                         * (self.num_replicas * A)
                                         / torch.clamp(real, min=1.0))
                overlap = None
                if hook_buckets:
                    overlap = ar_sync.OverlapPass(
                        hook_buckets, comp, self.group, self.hier_spec, self.axes,
                        max_chunk_bytes=self.max_chunk_bytes, upcast=self._prec_names,
                        stream=self._sync_stream)
                with overlap.attached(storage) if overlap else contextlib.nullcontext():
                    mb_grads = torch.autograd.grad(mb_loss, params)
                if self._prec_names:   # bf16 compute copies: f32 from here on
                    mb_grads = [g.float() if n in self._prec_names else g
                                for n, g in zip(self.names, mb_grads)]
                mb_grads = dict(zip(self.names, mb_grads))
                if overlap is not None:   # the mean of the microbatches' synced means
                    mb_synced, comp = overlap.finish(mb_grads)
                    self.last_overlap = overlap
                    if A == 1:
                        synced = mb_synced
                    else:
                        synced = {n: (0 if synced is None else synced[n]) + g / A
                                  for n, g in mb_synced.items()}
                    mb_grads = {n: g for n, g in mb_grads.items() if n not in hooked}
                auxs.append({k: torch.as_tensor(v, device=self.device).detach()
                             for k, v in aux.items()} if isinstance(aux, dict) else {})
                if mutable is not None:
                    mutable = OrderedDict((n, t.detach()) for n, t in new_mutable.items())
                if A == 1:
                    loss, grads = mb_loss.detach(), mb_grads
                elif grads is None:
                    loss = mb_loss.detach() / A
                    grads = {n: g / A for n, g in mb_grads.items()}
                else:
                    loss = loss + mb_loss.detach() / A
                    grads = {n: grads[n] + g / A for n, g in mb_grads.items()}
        aux = auxs[0] if A == 1 else {k: torch.stack([a[k] for a in auxs]).mean(0)
                                      for k in auxs[0]}
        if hook_buckets:
            state["comp"] = {**state["comp"], **comp}
        return loss, mutable, grads, aux, synced

    def sync(self, grads, comp_states, impl=None, buckets=None):
        """The synced gradients (a sharded bucket's as this replica's flat
        shards, each the replica mean of its flat ``[r * ss, (r + 1) * ss)``
        slice) and the new codec states, of ``buckets`` (default: all)
        after the backward pass: :func:`sync_overlapped` under the overlap
        schedule (reverse order, chunks), else :func:`sync_bucketed`, over
        this world's replicas and axis groups."""
        buckets = self.buckets if buckets is None else buckets
        kw = dict(impl=impl, hier=self.hier_spec, axes=self.axes)
        if self.sync_schedule == "overlap":
            return ar_sync.sync_overlapped(grads, buckets, comp_states, self.group,
                                           max_chunk_bytes=self.max_chunk_bytes, **kw)
        return ar_sync.sync_bucketed(grads, buckets, comp_states, self.group, **kw)

    def gather_buckets(self, state):
        """Write the updated shards of the sharded buckets without bf16
        master back into storage: one all-gather per bucket of the shards
        laid end to end, in their dtype, whose columns, read row-major, are
        each variable's new value
        (:func:`~autodist_tpu_torch.kernel.synchronization.all_reduce.gather_bucket_params`)."""
        with torch.no_grad():
            for b in self.sharded_buckets + self.sparse_ps_buckets:
                if not b.precision:
                    ar_sync.gather_bucket_params(state["shards"], b, self.group,
                                                 out=state["params"], hier=self.hier_spec,
                                                 axes=self.axes)

    def gather_compute_copies(self, state):
        """The top of the step for the bf16-master buckets: one all-gather
        per bucket of the bf16 cast of the f32 master shards, written into
        the stored bf16 compute copies."""
        if not self.precision_buckets:
            return
        with torch.no_grad():
            for b in self.precision_buckets:
                ar_sync.gather_bucket_params(state["shards"], b, self.group, out=state["params"],
                                             dtype=torch.bfloat16, hier=self.hier_spec,
                                             axes=self.axes)

    def canonical_params(self, state):
        """The full, unpadded parameters by name, as the single-device
        program sees them: the stored tensors, for the bf16-master
        variables the f32 masters all-gathered from the shards (no full f32
        copy lives in the state), the SHARDED variables gathered from
        their blocks, and the DIVERGENT ones averaged over the replicas
        (collectives: every rank calls this)."""
        out = OrderedDict(state["params"])
        with torch.no_grad():
            for b in self.precision_buckets:
                out.update(ar_sync.gather_bucket_params(state["shards"], b, self.group,
                                                        hier=self.hier_spec, axes=self.axes))
            for n in self.sharded_names + self.divergent_names:
                out[n] = self.canonical_leaf(out[n], n)
        return out

    def uncanonical_params(self, state, params):
        """The inverse of :meth:`canonical_params` (JAX
        ``uncanonicalize_params``): full, unpadded parameters by name are
        written into ``state`` in place, each flat shard taking its row and
        each stored tensor its piece (:meth:`uncanonical_leaf`: a SHARDED
        variable's block, else the full value, cast to a bf16 compute
        copy's dtype), so that the optimizer keeps its tensors."""
        storage, shards = state["params"], state["shards"]
        with torch.no_grad():
            for n in self.names:
                full = params[n].detach()
                piece = self.uncanonical_leaf(full, n)
                if n in shards:
                    shards[n].copy_(piece)
                storage[n].copy_(piece if n in self.sharded_names else full)

    def canonical_opt_state(self, state):
        """The optimizer state in the single-device form (JAX
        ``canonicalize_opt_state``): the ``torch.optim`` ``state_dict()`` of
        the session's optimizer, whose parameter ``i`` is variable
        ``names[i]``, with every per-parameter tensor in its variable's
        full, unpadded shape (:meth:`canonical_leaf`: flat shards and blocks
        gathered, DIVERGENT slots averaged over the replicas; a scalar such
        as ``step`` as it is).  A vanilla ``torch.optim`` optimizer of the
        same kind over the full parameters in name order loads it.  A
        collective, which every rank calls."""
        sd = state["opt_state"].state_dict()
        slots = OrderedDict(
            (i, OrderedDict((k, self.canonical_leaf(v, self.names[i])
                             if isinstance(v, torch.Tensor) else v) for k, v in s.items()))
            for i, s in sd["state"].items())
        return {"state": slots, "param_groups": sd["param_groups"]}

    def uncanonical_opt_state(self, state, canonical):
        """The inverse of :meth:`canonical_opt_state` (JAX
        ``uncanonicalize_opt_state``): each per-parameter tensor of the
        single-device ``state_dict`` cut to this replica's piece of its
        variable's update space (:meth:`uncanonical_leaf`), then loaded
        into the session's optimizer (``load_state_dict`` moves the slots
        to the parameters' device).  The session keeps its own
        hyperparameters, as an optax state carries none."""
        slots = {int(i): {k: self.uncanonical_leaf(v, self.names[int(i)])
                          if isinstance(v, torch.Tensor) else v for k, v in s.items()}
                 for i, s in canonical["state"].items()}
        load_slots(state["opt_state"], slots)

    def global_norm(self, update_grads):
        """The global norm of the update-space gradients: flat shards (PS
        and sharded-update) and SHARDED blocks summed over the replicas (a
        shard of a PS confined to a subset of the data axes divided by its
        copies across the others), a DIVERGENT variable's local gradient
        averaged over them (JAX ``graph_transformer.py:1422-1426``),
        replicated gradients counted once."""
        sq = torch.zeros((), device=self.device)
        sq_sharded = torch.zeros((), device=self.device)
        for name, g in update_grads.items():
            s = g.float().square().sum()
            plan = self.plans[name]
            if plan.placement == part.Placement.DIVERGENT:
                sq_sharded = sq_sharded + s / self.num_replicas
            elif plan.placement == part.Placement.SHARDED or part.flat_shard_update(plan):
                copies = self.num_replicas // self._R_for(plan)
                sq_sharded = sq_sharded + (s / copies if copies > 1 else s)
            else:
                sq = sq + s
        return torch.sqrt(sq + coll.psum(sq_sharded, self.group))

    def _update_grad(self, name, grads, synced, state):
        """Variable ``name``'s gradient in its update space: a bucket's
        synced entry; a SHARDED variable's block (reduce-scattered, or
        sliced from a sparse gradient the lookup synced, or the row
        exchange's block gradient as it is); a sparse PS variable's flat
        shard of its synced gradient; a sparse AllReduce variable's synced
        gradient as it is."""
        if name in synced:
            return synced[name]
        plan, g = self.plans[name], grads[name]
        if plan.placement == part.Placement.SHARDED:
            if not plan.sparse:
                return self._scatter_block(g, plan)
            return g if plan.partition_axis == 0 else self._block(g, plan)
        if name in self.shard_len:   # a sparse PS variable: its row of the synced mean
            return self.uncanonical_leaf(g, name)
        return g

    def update(self, state, grads, presynced=None):
        """Sync ``grads`` (this replica's, by name), clip them, step the
        optimizer, write the sharded buckets' shards back into storage and
        average the DIVERGENT copies whose period ends at this step;
        returns the extra metrics (``grad_norm`` when clipping).  With
        ``presynced`` (the entries the overlap schedule's hooks synced) only
        the other buckets sync here."""
        synced, state["comp"] = self.sync(
            grads, state["comp"], buckets=None if presynced is None else self.post_buckets)
        if presynced:
            synced.update(presynced)
        update_grads = OrderedDict((n, self._update_grad(n, grads, synced, state))
                                   for n in self.names)
        metrics = {}
        if self.clip_global_norm is not None:
            norm = self.global_norm(update_grads)
            scale = torch.clamp(self.clip_global_norm / torch.clamp(norm, min=1e-12), max=1.0)
            update_grads = OrderedDict((n, g * scale.to(g.dtype))
                                       for n, g in update_grads.items())
            metrics["grad_norm"] = norm
        storage, shards = state["params"], state["shards"]
        with torch.no_grad():
            for name, g in update_grads.items():
                shards.get(name, storage[name]).grad = g
            state["opt_state"].step()
            for name in self.names:
                shards.get(name, storage[name]).grad = None
        self.gather_buckets(state)
        self.average_divergent(state)
        return metrics

    def average_divergent(self, state):
        """JAX's DIVERGENT write-back (``graph_transformer.py:1500-1515``):
        each group whose period ends at this step, ``(state["step"] + 1) %
        sync_period == 0`` with the step not yet counted (the same on every
        rank, so every rank takes the same collectives), has its copies
        replaced by their mean over the replicas: the group's copies laid
        end to end, one all-reduce, divided by R.  At R = 1 the mean is the
        copy itself, and nothing runs."""
        if self.group is None or self.num_replicas == 1:
            return
        step, params = state["step"], state["params"]
        with torch.no_grad():
            for (period, _), names in self.divergent_groups.items():
                if (step + 1) % period:
                    continue
                flat = coll.pmean(torch.cat([params[n].reshape(-1) for n in names]),
                                  self.group)
                for n, piece in zip(names, flat.split([params[n].numel() for n in names])):
                    params[n].copy_(piece.view_as(params[n]))

    def plan_summary(self):
        """The transform plan, one line a variable (JAX ``plan_summary``):
        its shape, placement and sync, ``sparse``, a SHARDED variable's
        axis and padded size, the PS axes of a subset, ``staleness=``, a
        flat shard's length and ``precision=bf16_master``."""
        lines = [f"replicas: {self.num_replicas}  accum_steps: {self.accum_steps}  "
                 f"clip_global_norm: {self.clip_global_norm}",
                 f"AR buckets: {len(self.buckets) - len(self.ps_groups)}  fused PS groups: "
                 f"{len(self.ps_groups)}  sync_schedule: {self.sync_schedule}  "
                 f"sync_hierarchy: {self.sync_hierarchy}  sharded_update_buckets: "
                 f"{len(self.sharded_buckets)}  divergent groups: "
                 f"{len(self.divergent_groups)}", ""]
        for name in self.names:
            p = self.plans[name]
            extra = ""
            if p.placement == part.Placement.SHARDED:
                extra = f" axis={p.partition_axis} padded={p.padded_dim}"
            if p.sync == part.SyncKind.PS and p.ps_axes:
                extra += f" ps_axes={p.ps_axes}"
            if p.staleness:
                extra += f" staleness={p.staleness}"
            if name in self.shard_len:
                extra += f" sharded_update(ss={self.shard_len[name]})"
            if name in self._prec_names:
                extra += " precision=bf16_master"
            lines.append(f"{name}: shape={tuple(p.shape)} {p.placement.value}/"
                         f"{p.sync.value}{' sparse' if p.sparse else ''}{extra}")
        return "\n".join(lines) + "\n"

    def step(self, state, batch):
        """One training step on this replica's batch slice, already on the
        device; returns (state, metrics)."""
        self.gather_compute_copies(state)
        loss, new_mutable, grads, aux, synced = self._gradients(state, batch, self.hook_buckets)
        if new_mutable is not None:
            state["mutable"] = replica_mean_state(new_mutable, self.group)
        extra = self.update(state, grads, synced if self.hook_buckets else None)
        state["step"] += 1
        metrics = {"loss": coll.pmean(loss, self.group), "step": state["step"], **extra}
        for k, v in aux.items():
            metrics[k] = coll.pmean(v, self.group)
        return state, metrics
