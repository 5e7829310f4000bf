"""GraphTransformer: the compiled strategy -> state and the training step.

Counterpart of ``autodist_tpu/kernel/graph_transformer.py``
(``init_state`` and the train step of ``_spmd_step``) for the plan the
port realises: every variable REPLICATED and synchronised by the bucketed
all-reduce.  Each process runs one replica on its slice of the global
batch; the replicas meet in the collectives of ``world.group``
(:mod:`autodist_tpu_torch.parallel.mesh`).  One step is

1. materialise: the stored parameters are what the loss sees;
2. value and gradient (:meth:`GraphTransformer.gradients`):
   ``loss_fn(params, batch[, generator])``, then ``torch.autograd.grad``
   with respect to the parameters; with ``has_rng`` the generator is
   folded from (seed, step) and, over more than one replica, the rank
   (:func:`autodist_tpu_torch.utils.rng.step_generator`).  With mutable
   state the call is ``loss_fn(params, mutable, batch[, generator]) ->
   (loss, new_mutable)``; the new state is stored detached, after the
   cross-replica mean of its float leaves (:func:`replica_mean_state`);
3. bucket sync through each bucket's codec, whose state rides in
   ``state["comp"]`` (:meth:`GraphTransformer.sync`, :func:`sync_bucketed`);
4. optimizer update, which writes the new values back into the stored
   tensors in place.

On a mesh with a ``seq`` axis and more than one axis (``{"replica": R_d,
"seq": R_s}``, even at ``seq: 1``, as in JAX) sequence parallelism is on:
each rank holds one sequence block of its data slice, the loss runs inside
:func:`~autodist_tpu_torch.parallel.context.seq_axis_context` (so GPT's
attention takes the ring over the rank's seq row and its positions start
at the block's global offset), and the gradients and the loss are still
averaged over every rank.

It returns the metrics ``{"loss", "step"}``, the loss the mean over the
replicas (the JAX step's ``pmean(loss)``).  Gradient accumulation,
clipping and batch masks are later slices (ROADMAP, Queue A item 2) and
raise.
"""
from collections import OrderedDict

import torch

from autodist_tpu_torch.kernel import partitioner as part
from autodist_tpu_torch.kernel.synchronization import all_reduce as ar_sync
from autodist_tpu_torch.parallel import collectives as coll
from autodist_tpu_torch.parallel.context import seq_axis_context
from autodist_tpu_torch.parallel.mesh import ReplicaWorld, check_replicas
from autodist_tpu_torch.utils.rng import step_generator


def replica_mean_state(new_state, group=None):
    """The stored new mutable state: every leaf detached, float leaves (batch
    statistics) averaged over the replicas as the JAX step's ``pmean``
    (``kernel/graph_transformer.py:1226-1231``); integer leaves as they are."""
    return OrderedDict(
        (n, coll.pmean(t.detach(), group) if t.is_floating_point()
         else t.detach()) for n, t in new_state.items())


class GraphTransformer:
    """Builds the session state and the training step of one replica."""

    def __init__(self, strategy, model_item, device, world=None):
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
        if model_item.has_aux:
            raise NotImplementedError("has_aux is a later slice of the port")
        self.names = model_item.var_names
        self.plans = part.build_var_plans(strategy, model_item, self.num_replicas)
        for name in self.names:
            if name not in self.plans:
                raise ValueError(f"No plan for variable {name}")
        infos = {v.name: v for v in model_item.var_infos}
        self.buckets = ar_sync.plan_buckets(
            self.plans, {n: infos[n].shape for n in self.names},
            {n: infos[n].dtype for n in self.names})

    def init_state(self, seed=0):
        """The session state: stored parameters (fresh copies on the device,
        never aliasing the caller's tensors), the optimizer, codec state,
        the step counter and the rng seed."""
        params = self.model_item.params
        storage = OrderedDict(
            (n, params[n].detach().to(self.device, copy=True).requires_grad_(True))
            for n in self.names)
        return {
            "params": storage,
            "opt_state": self.model_item.optimizer.create(storage.values()),
            "comp": ar_sync.init_compressor_states(self.buckets, self.device),
            "step": 0,
            "rng": int(seed),
            "mutable": None if self.model_item.mutable_state is None else OrderedDict(
                (n, t.detach().to(self.device, copy=True))
                for n, t in self.model_item.mutable_state.items()),
        }

    def gradients(self, state, batch):
        """This replica's loss, new mutable state (None without one) and
        gradients by name at ``state``, on its batch slice; changes nothing."""
        item = self.model_item
        storage = state["params"]
        mutable = state["mutable"]
        args = (storage, batch) if mutable is None else (storage, mutable, batch)
        if item.has_rng:
            replica = self.world.rank if self.num_replicas > 1 else None
            args += (step_generator(state["rng"], state["step"], self.device, replica),)
        with seq_axis_context(self.seq_axis):
            loss = item.loss_fn(*args)
            new_mutable = None
            if mutable is not None:
                loss, new_mutable = loss
            grads = torch.autograd.grad(loss, list(storage.values()))
        return loss, new_mutable, dict(zip(self.names, grads))

    def sync(self, grads, comp_states, impl=None):
        """The synced gradients and the new codec states (:func:`sync_bucketed`
        over this world's replicas)."""
        return ar_sync.sync_bucketed(grads, self.buckets, comp_states, self.group,
                                     impl=impl)

    def step(self, state, batch):
        """One training step on this replica's batch slice, already on the
        device; returns (state, metrics)."""
        storage = state["params"]
        loss, new_mutable, grads = self.gradients(state, batch)
        if new_mutable is not None:
            state["mutable"] = replica_mean_state(new_mutable, self.group)
        synced, state["comp"] = self.sync(grads, state["comp"])
        with torch.no_grad():
            for name, p in storage.items():
                p.grad = synced[name]
            state["opt_state"].step()
            for p in storage.values():
                p.grad = None
        state["step"] += 1
        return state, {"loss": coll.pmean(loss.detach(), self.group),
                       "step": state["step"]}
