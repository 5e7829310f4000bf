"""GraphTransformer: the compiled strategy -> state and the training step.

Counterpart of ``autodist_tpu/kernel/graph_transformer.py`` (``init_state``
and the train step of ``_spmd_step``) for the two plans the port realises
(:mod:`autodist_tpu_torch.kernel.partitioner`): REPLICATED storage
synchronised by the bucketed all-reduce, and the synchronous PS's
weight-update sharding.  Each process runs one replica on its slice of the
global batch; the replicas meet in the collectives of ``world.group``
(:mod:`autodist_tpu_torch.parallel.mesh`).  One step is

1. materialise: the stored full-shape parameters are what the loss sees;
2. value and gradient (:meth:`GraphTransformer.gradients`):
   ``loss_fn(params, batch[, generator])``, then ``torch.autograd.grad``
   with respect to the parameters.  With ``accum_steps = A > 1`` the
   replica's batch splits into A microbatches along dim 0, each taking
   its own value and gradient, and the loss, gradients and aux are their
   means; the mutable state threads through them.  With ``has_rng`` the
   generator is folded from (seed, step), over more than one replica the
   rank, and at A > 1 the microbatch index
   (:func:`autodist_tpu_torch.utils.rng.step_generator`).  With mutable
   state the call is ``loss_fn(params, mutable, batch[, generator]) ->
   (loss, new_mutable)``; the new state is stored detached, after the
   cross-replica mean of its float leaves (:func:`replica_mean_state`).
   With ``has_aux`` the loss comes with a dict of aux values (``(loss,
   aux)``, or ``(loss, (new_mutable, aux))``).  A batch with a
   ``BATCH_MASK_KEY`` leaf (an uneven global batch, padded by the session)
   scales each microbatch's loss by ``sum(mask) * R * A / max(S, 1)``, S
   the real rows over all replicas, so that the means below are the
   weighted mean over the real examples;
3. sync: the AllReduce variables' buckets through each bucket's codec,
   whose state rides in ``state["comp"]`` (:meth:`GraphTransformer.sync`,
   :func:`sync_bucketed`); the PS variables by one reduce-scatter per
   dtype group (:meth:`GraphTransformer.ps_scatter`): each variable's
   zero-padded flat gradient as an ``(R, ceil(n/R))`` matrix, the group's
   matrices side by side, so that replica r receives row r, its shard of
   every variable, summed over the replicas and divided by R;
   :meth:`GraphTransformer.update` runs this step and the next two;
4. with ``clip_global_norm``, the true global norm over the update spaces
   (a PS shard's squared sum summed over the replicas, an AllReduce
   gradient counted once) scales every gradient by ``min(1, max_norm /
   max(norm, 1e-12))`` and is reported as ``grad_norm``;
5. optimizer update: the AllReduce variables in place in storage; the PS
   variables on their flat shards (``state["shards"]``, separate leaf
   tensors, so the optimizer state lives sharded too), whose updated
   values come back by one all-gather per group and are written into
   storage (:meth:`GraphTransformer.ps_gather`).

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
from collections import OrderedDict

import torch

from autodist_tpu_torch.const import BATCH_MASK_KEY
from autodist_tpu_torch.kernel import partitioner as part
from autodist_tpu_torch.kernel.synchronization import all_reduce as ar_sync
from autodist_tpu_torch.model_item import dtype_name
from autodist_tpu_torch.parallel import collectives as coll
from autodist_tpu_torch.parallel.context import seq_axis_context
from autodist_tpu_torch.parallel.mesh import ReplicaWorld, check_replicas
from autodist_tpu_torch.utils.rng import step_generator
from autodist_tpu_torch.utils.tree import map_batch


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


def padded_rows(t, rows, ss):
    """``t``'s flat elements zero-padded to ``rows * ss``, as ``(rows, ss)``
    (a view when no padding is needed)."""
    flat = t.reshape(-1)
    pad = rows * ss - flat.numel()
    return (torch.nn.functional.pad(flat, (0, pad)) if pad else flat).view(rows, ss)


class GraphTransformer:
    """Builds the session state and the training step of one replica."""

    def __init__(self, strategy, model_item, device, world=None, accum_steps=1,
                 clip_global_norm=None):
        self.strategy = strategy
        self.model_item = model_item
        self.device = torch.device(device)
        self.world = world or ReplicaWorld(rank=0, size=1)
        self.num_replicas = max(1, len(strategy.graph_config.replicas))
        check_replicas(self.num_replicas, self.world)
        self.group = self.world.group
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
        self._normalise_ps_axes(tuple(strategy.graph_config.mesh.axis_names))
        infos = {v.name: v for v in model_item.var_infos}
        self.buckets = ar_sync.plan_buckets(
            self.plans, {n: infos[n].shape for n in self.names},
            {n: infos[n].dtype for n in self.names})
        # fused PS groups: dtype -> the names of its flat-shard vars, in order
        self.ps_groups = OrderedDict()
        self.shard_len = {}
        for name in self.names:
            plan = self.plans[name]
            if part.flat_shard_update(plan):
                self.ps_groups.setdefault(dtype_name(plan.dtype), []).append(name)
                self.shard_len[name] = part.shard_len(plan, self.num_replicas)

    def _normalise_ps_axes(self, data_axes):
        """A PS destination ``mesh:<axes>`` naming every data axis is the
        default realisation (JAX ``graph_transformer.py:297``); axes that
        are no data axes raise, as in JAX, and a subset is a later slice."""
        for name, plan in self.plans.items():
            if not plan.ps_axes:
                continue
            bad = set(plan.ps_axes) - set(data_axes)
            if bad:
                raise ValueError(f"{name!r}: ps_axes {sorted(bad)} are not data axes "
                                 f"{data_axes} of the mesh")
            if tuple(plan.ps_axes) != data_axes:
                raise NotImplementedError(
                    f"{name!r}: ps_axes {plan.ps_axes}, a subset of the data axes "
                    f"{data_axes}, is a later slice of the port (ROADMAP, Queue A item 5)")
            plan.ps_axes = None

    def _shard(self, param, name):
        """This replica's flat shard of ``param``: elements ``[r * ss, (r + 1)
        * ss)`` of its flat form zero-padded to ``ss * R``."""
        rows = padded_rows(param.detach(), self.num_replicas, self.shard_len[name])
        return rows[self.world.rank].clone()

    def init_state(self, seed=0):
        """The session state: stored parameters (fresh copies on the device,
        never aliasing the caller's tensors), the PS variables' flat shards,
        the optimizer over the update spaces (shards for PS variables, the
        stored tensors for the others), codec state, the step counter and
        the rng seed."""
        params = self.model_item.params
        storage = OrderedDict(
            (n, params[n].detach().to(self.device, copy=True).requires_grad_(True))
            for n in self.names)
        shards = OrderedDict((n, self._shard(storage[n], n)) for n in self.names
                             if n in self.shard_len)
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

    def gradients(self, state, batch):
        """This replica's loss, new mutable state (None without one),
        gradients by name and aux values at ``state``, on its batch slice
        (every microbatch's, averaged); changes nothing."""
        item = self.model_item
        storage = state["params"]
        params = list(storage.values())
        mutable = state["mutable"]
        A = self.accum_steps
        real = None
        if isinstance(batch, dict) and BATCH_MASK_KEY in batch:
            real = coll.psum(batch[BATCH_MASK_KEY].float().sum(), self.group)
        replica = self.world.rank if self.num_replicas > 1 else None
        loss = grads = None
        auxs = []
        with seq_axis_context(self.seq_axis):
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
                mb_grads = torch.autograd.grad(mb_loss, params)
                auxs.append({k: torch.as_tensor(v, device=self.device).detach()
                             for k, v in aux.items()} if isinstance(aux, dict) else {})
                if mutable is not None:
                    mutable = OrderedDict((n, t.detach()) for n, t in new_mutable.items())
                if A == 1:
                    loss, grads = mb_loss.detach(), mb_grads
                elif grads is None:
                    loss = mb_loss.detach() / A
                    grads = [g / A for g in mb_grads]
                else:
                    loss = loss + mb_loss.detach() / A
                    grads = [a + g / A for a, g in zip(grads, mb_grads)]
        aux = auxs[0] if A == 1 else {k: torch.stack([a[k] for a in auxs]).mean(0)
                                      for k in auxs[0]}
        return loss, mutable, dict(zip(self.names, grads)), aux

    def sync(self, grads, comp_states, impl=None):
        """The synced gradients of the AllReduce variables and the new codec
        states (:func:`sync_bucketed` over this world's replicas)."""
        return ar_sync.sync_bucketed(grads, self.buckets, comp_states, self.group,
                                     impl=impl)

    def ps_scatter(self, grads):
        """Each PS variable's gradient shard, the replica mean of its flat
        ``[r * ss, (r + 1) * ss)`` slice: one reduce-scatter per dtype group
        of the variables' ``(R, ss)`` matrices side by side."""
        R = self.num_replicas
        shards = {}
        for names in self.ps_groups.values():
            mats = [padded_rows(grads[n], R, self.shard_len[n]) for n in names]
            row = coll.psum_scatter(torch.cat(mats, dim=1), self.group).reshape(-1)
            if R > 1:
                row = row / R
            off = 0
            for n in names:
                shards[n] = row[off:off + self.shard_len[n]]
                off += self.shard_len[n]
        return shards

    def ps_gather(self, state):
        """Write the updated PS shards back into storage: one all-gather per
        dtype group of the shards laid end to end; variable v's columns of
        the gathered ``(R, S)`` matrix, read row-major, are its new value
        (the full rows copied by one multi-tensor copy, the last partial
        row, where there is one, apart)."""
        R = self.num_replicas
        storage, shards = state["params"], state["shards"]
        dsts, srcs = [], []
        with torch.no_grad():
            for names in self.ps_groups.values():
                cat = torch.cat([shards[n] for n in names])
                full = coll.all_gather_into_tensor(cat, self.group).view(R, -1)
                off = 0
                for n in names:
                    ss = self.shard_len[n]
                    flat = storage[n].view(-1)
                    rows, rem = divmod(flat.numel(), ss)
                    dsts.append(flat[:rows * ss].view(rows, ss))
                    srcs.append(full[:rows, off:off + ss])
                    if rem:
                        flat[rows * ss:].copy_(full[rows, off:off + rem])
                    off += ss
            if dsts:
                torch._foreach_copy_(dsts, srcs)

    def global_norm(self, update_grads):
        """The global norm of the update-space gradients: PS shards summed
        over the replicas, replicated gradients counted once."""
        sq = torch.zeros((), device=self.device)
        sq_sharded = torch.zeros((), device=self.device)
        for name, g in update_grads.items():
            s = g.float().square().sum()
            if part.flat_shard_update(self.plans[name]):
                sq_sharded = sq_sharded + s
            else:
                sq = sq + s
        return torch.sqrt(sq + coll.psum(sq_sharded, self.group))

    def update(self, state, grads):
        """Sync ``grads`` (this replica's, by name), clip them, step the
        optimizer and write the PS shards back into storage; returns the
        extra metrics (``grad_norm`` when clipping)."""
        synced, state["comp"] = self.sync(grads, state["comp"])
        synced.update(self.ps_scatter(grads))
        update_grads = OrderedDict((n, synced[n]) for n in self.names)
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
        self.ps_gather(state)
        return metrics

    def step(self, state, batch):
        """One training step on this replica's batch slice, already on the
        device; returns (state, metrics)."""
        loss, new_mutable, grads, aux = self.gradients(state, batch)
        if new_mutable is not None:
            state["mutable"] = replica_mean_state(new_mutable, self.group)
        extra = self.update(state, grads)
        state["step"] += 1
        metrics = {"loss": coll.pmean(loss, self.group), "step": state["step"], **extra}
        for k, v in aux.items():
            metrics[k] = coll.pmean(v, self.group)
        return state, metrics
