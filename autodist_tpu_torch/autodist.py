"""AutoDist: the user entry point (counterpart of ``autodist_tpu/autodist.py``)::

    ad = AutoDist(resource_spec=spec)      # the default builder, PSLoadBalancing()
    sess = ad.distribute(loss_fn, params, optim.adamw(3e-4))
    for batch in data:
        metrics = sess.run(batch)

``loss_fn(params, batch[, generator]) -> loss`` is single-device code over
a dict of tensors; with ``mutable_state`` (e.g. a ResNet's batch
statistics) it is ``loss_fn(params, state, batch[, generator]) -> (loss,
new_state)``.  ``has_aux`` adds a dict of aux values to the loss
(``(loss, aux)``, or ``(loss, (new_state, aux))``), averaged over the
replicas into the metrics.  The options ``remat``, ``accum_steps``,
``clip_global_norm``, ``batch_mask`` and ``sync_schedule`` (``"overlap"``
or ``"barrier"``, over the strategy's schedule knob)
(:mod:`autodist_tpu_torch.kernel.graph_transformer`,
:mod:`autodist_tpu_torch.runner`) and ``eval_fn`` (the default forward of
``predict``) are the JAX engine's.

One process runs each replica, as ``torchrun --nproc-per-node R script.py``
launches them: every rank runs the same script, ``distribute`` joins the
ranks in a process group (:func:`autodist_tpu_torch.parallel.mesh.replica_world`,
NCCL on CUDA, gloo on the CPU) and a spec of R replicas needs exactly R
ranks.  Rank 0 is the chief: it builds the strategy and serialises it (a
worker with ``AUTODIST_WORKER`` set loads it by ``AUTODIST_STRATEGY_ID``
instead), and every other rank runs the strategy rank 0 holds, whose JSON
it receives by broadcast.  A spec whose ``mesh:`` asks for ``{"replica":
R_d, "seq": R_s}`` lays the ranks out on that mesh
(:func:`autodist_tpu_torch.parallel.mesh.mesh_world`): GPT's attention then
runs the ring over each seq row and ``run`` hands rank (d, s) its block of
the global batch.  ``{"replica_dcn": R_dcn, "replica_ici": R_ici}`` (asked
for, or factored from a spec of several hosts by
``AllReduce(hierarchy="two_level")``) gives the two-level sync its node
groups.  A rank runs on ``cuda:LOCAL_RANK``; a
one-process run on the spec's first GPU; ``device="cpu"`` runs on the
CPU.  Without a GPU and without that request it raises.  ``sparse_vars``
names the variables used only through
:func:`~autodist_tpu_torch.ops.sparse.embedding_lookup`, whose backward
syncs their rows.  ``donate`` is taken and has no effect: the port
updates the parameters in place, which is what donation buys JAX.

A PS with ``staleness > 0`` and ``sync=True`` runs on the synchronous
engine with DIVERGENT copies, averaged every ``staleness + 1`` steps
(:mod:`autodist_tpu_torch.kernel.partitioner`).  A strategy with any PS
node of ``sync=False`` (on the node or on a partition's ``part_config``)
selects the asynchronous runtime instead, as in JAX: in one process, an
:class:`~autodist_tpu_torch.kernel.synchronization.async_ps.AsyncPSEngineSession`
with one worker thread per GPU of the spec (per spec device, all on the
CPU, with ``device="cpu"``); across processes (a spec of several nodes,
``AUTODIST_NUM_PROCESSES > 1`` or a launched world of several ranks), an
:class:`~autodist_tpu_torch.kernel.synchronization.async_service.AsyncPSClusterSession`
whose chief serves the parameters over TCP and whose every process drives
one worker.  The options only the synchronous engine implements
(``batch_mask``, ``rng``, ``accum_steps`` other than 1,
``clip_global_norm``, ``sync_schedule``) raise ``NotImplementedError``
there.  ``serve``, ``aot_compile`` and the options ``data_axes``,
``batch_spec``, ``param_specs`` and ``verify`` are later slices of the
port (ROADMAP, Queue A); they raise ``NotImplementedError``.

``launch`` is the multi-process entry without a launcher: the chief builds
and serialises the strategy, starts one process for every other device of
the spec (:class:`~autodist_tpu_torch.cluster.Cluster`: locally on its own
node, through ``ssh`` on the others), each re-executing the user's script,
and every process joins the process group and builds the same session;
the workers load the strategy by id.  A spec of one device, or ranks a
launcher such as ``torchrun`` started already, degrade to ``distribute``.
On the async path no group is joined: the chief binds the parameter
service first and hands its address and a fresh authkey to the workers
through the launch's environment.

``rebind(spec)`` swaps in the surviving topology of a membership change
(``ResourceSpec.shrink``; the elastic trainer's): the next ``distribute``
plans on it, in the survivors' subgroup of the launch's process group
(``parallel/mesh.py``).  The launch's ranks map onto the spec's devices in
:func:`~autodist_tpu_torch.cluster.rank_devices` order; a rank whose
device the new spec lacks is not a member (``in_world`` is False) and must
not call ``distribute``.  After a rebind the world's rank 0 builds the
strategy, whatever its ``AUTODIST_WORKER``: a strategy id in a worker's
environment belongs to the epoch it was launched in.
"""
import functools
from typing import Any, Callable, Optional, Sequence

from autodist_tpu_torch import const
from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.kernel.device.resolver import resolve_device, torch_device
from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.parallel.mesh import (broadcast_text, launched_world_size,
                                              mesh_world, replica_world)
from autodist_tpu_torch.proto import schema
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.base import Strategy, StrategyCompiler
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.remat import checkpoint

_DEFAULT_AUTODIST = {}


def _strategy_requests_async(proto):
    """True when any node, or any partition's ``part_config``, carries an
    async ``PSSynchronizer`` (``sync=False``): the switch into the host-PS
    async runtime."""
    for n in proto.node_config:
        for src in (n, *n.part_config):
            if (src.WhichOneof("synchronizer") == "PSSynchronizer"
                    and not src.PSSynchronizer.sync):
                return True
    return False


# distribute() options of the JAX engine that later slices realise: the
# value that means "off", and the ROADMAP Queue A item that ports it
_LATER_OPTIONS = {
    "data_axes": (None, 9), "batch_spec": (None, 9), "param_specs": (None, 9),
    "verify": (False, 11),
}


def set_default_autodist(o):
    """One AutoDist per process, unless ``AUTODIST_IS_TESTING``."""
    if _DEFAULT_AUTODIST and ENV.AUTODIST_IS_TESTING.val is False:
        raise NotImplementedError("Only one AutoDist instance is supported per process")
    _DEFAULT_AUTODIST["instance"] = o


class AutoDist:
    def __init__(self, resource_spec_file=None, strategy_builder=None, *,
                 resource_spec: Optional[ResourceSpec] = None, device=None):
        if device is not None:
            device = resolve_device(device)
        set_default_autodist(self)
        self._resource_spec = resource_spec or ResourceSpec(
            resource_spec_file, device=None if device is None else device.type)
        if device is None and launched_world_size() > 1:
            device = resolve_device(f"cuda:{ENV.LOCAL_RANK.val}")   # one GPU per rank
        elif device is None and self._resource_spec.gpu_devices:
            device = torch_device(self._resource_spec.gpu_devices[0][0])
        self._device = resolve_device(device)
        self._world = None
        self._mesh_worlds = {}
        self._members = None        # global ranks of the world after a rebind
        self._launch_names = None   # the launch's device name of each global rank
        self._rebound = False
        self._launching = None      # the Cluster of a launch() in progress
        self._coordinator = None
        if strategy_builder is None:
            from autodist_tpu_torch.strategy import PSLoadBalancing

            strategy_builder = PSLoadBalancing()  # the JAX package's default
        self._strategy_builder = strategy_builder

    @property
    def resource_spec(self):
        return self._resource_spec

    @property
    def world(self):
        """This process's :class:`ReplicaWorld`, joined at the first
        ``distribute``."""
        if self._world is None:
            self._world = replica_world(self._device, self._members)
        return self._world

    @property
    def in_world(self):
        """Whether this process is a member of the spec's world: False for
        a rank whose device a rebind's spec dropped."""
        import torch.distributed as dist

        return (self._members is None or not dist.is_initialized()
                or dist.get_rank() in self._members)

    def rebind(self, resource_spec):
        """Swap in the SURVIVING topology's spec (usually
        ``old_spec.shrink(...)``) and drop the cached world and mesh
        worlds, so the next :meth:`distribute` plans on what is alive, in
        the survivors' subgroup.  Sessions built before keep their world;
        the elastic trainer builds a new session and reshards its
        checkpoint onto it."""
        import torch.distributed as dist

        from autodist_tpu_torch.cluster import rank_devices

        if self._launch_names is None and dist.is_initialized():
            names = [d.name_string() for _, d in rank_devices(self._resource_spec)]
            if len(names) == dist.get_world_size():
                self._launch_names = names
        self._resource_spec = resource_spec
        self._world = None
        self._mesh_worlds = {}
        self._rebound = True
        if self._launch_names is not None:
            alive = {n for n, _ in resource_spec.devices}
            self._members = tuple(r for r, n in enumerate(self._launch_names) if n in alive)
        return self

    def _mesh_world(self, mesh):
        """:attr:`world` placed on a compiled strategy's mesh, built once per
        mesh (every rank builds the same meshes in the same order)."""
        key = (tuple(mesh.axis_names), tuple(int(x) for x in mesh.axis_sizes))
        if key not in self._mesh_worlds:
            self._mesh_worlds[key] = mesh_world(self.world, *key)
        return self._mesh_worlds[key]

    @property
    def is_chief(self):
        return (const.IS_AUTODIST_CHIEF or self._rebound) and self.world.rank == 0

    def _build_or_load_strategy(self, model_item) -> Strategy:
        if self._launching is not None:   # launch(): the workers load it by id
            raw = self._chief_or_worker_strategy(model_item)
            if not _strategy_requests_async(raw.proto):
                self._coordinator.setup(raw, device=self._device)
                self._world, self._mesh_worlds = None, {}   # the group just joined
            return raw
        if self.world.rank == 0:
            strategy = self._chief_or_worker_strategy(model_item)
            text = schema.dumps(strategy.proto)
        else:
            text = None
        text = broadcast_text(text, self.world)
        if self.world.rank == 0:
            return strategy
        strategy = Strategy(schema.loads(schema.Strategy, text))
        logging.info("Rank %d received strategy %s", self.world.rank, strategy.id)
        return strategy

    def _chief_or_worker_strategy(self, model_item) -> Strategy:
        if const.IS_AUTODIST_CHIEF or self._rebound:
            strategy = self._strategy_builder.build(model_item, self._resource_spec)
            strategy.serialize()
            logging.info("Chief built strategy %s", strategy.id)
        else:
            sid = ENV.AUTODIST_STRATEGY_ID.val
            if not sid:
                raise RuntimeError("Worker process missing AUTODIST_STRATEGY_ID")
            strategy = Strategy.deserialize(sid)
            logging.info("Worker loaded strategy %s", strategy.id)
        return strategy

    def distribute(self, loss_fn: Callable, params: Any, optimizer: Any, *,
                   sparse_vars: Optional[Sequence[str]] = None, has_aux: bool = False,
                   has_rng: bool = False, rng: Optional[int] = None, name: str = "",
                   mutable_state: Any = None, eval_fn: Optional[Callable] = None,
                   accum_steps: int = 1, clip_global_norm: Optional[float] = None,
                   batch_mask: bool = False, remat: bool = False,
                   sync_schedule: Optional[str] = None, donate: bool = True, **options):
        """Capture single-device code and return a :class:`DistributedSession`.

        ``rng`` is the integer seed of the step generators (``has_rng``).
        ``remat=True`` runs the loss under
        :func:`autodist_tpu_torch.utils.remat.checkpoint` (JAX's
        ``jax.checkpoint(loss_fn)``): the backward recomputes its
        activations, dropout masks included.
        ``accum_steps`` splits each replica's batch into that many
        microbatches, synchronised once a step; ``clip_global_norm`` clips
        the update by the global gradient norm (reported as
        ``grad_norm``); ``batch_mask=True`` takes uneven dict batches,
        padded and masked, with a loss that ignores the masked rows (the
        ``train_lib`` losses do); ``eval_fn`` is ``predict``'s default;
        ``sync_schedule`` (``"overlap"`` or ``"barrier"``) overrides the
        strategy's issue schedule.  ``donate`` is ignored: the port
        updates the stored tensors in place, so there is no buffer to
        donate.  An async strategy returns an async session (see the
        module's docstring).
        """
        from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
        from autodist_tpu_torch.runner import DistributedSession

        unknown = set(options) - set(_LATER_OPTIONS)
        if unknown:
            raise TypeError(f"distribute() got unexpected options {sorted(unknown)}")
        later = {k: _LATER_OPTIONS[k][1] for k, v in options.items()
                 if v != _LATER_OPTIONS[k][0]}
        if later:
            raise NotImplementedError(
                "distribute options are later slices of the port: " + ", ".join(
                    f"{k} (ROADMAP, Queue A item {item})" for k, item in sorted(later.items())))
        if remat:
            loss_fn = functools.partial(checkpoint, loss_fn)
        item = ModelItem(loss_fn, params, optimizer, sparse_vars=sparse_vars,
                         has_aux=has_aux, has_rng=has_rng, mutable_state=mutable_state,
                         eval_fn=eval_fn, name=name)
        del donate   # the port updates in place
        raw = self._build_or_load_strategy(item)
        strategy = StrategyCompiler(item, self._resource_spec).compile(raw)
        if _strategy_requests_async(strategy.proto):
            return self._async_session(
                item, strategy, raw.id, batch_mask=batch_mask or None, rng=rng,
                accum_steps=None if accum_steps == 1 else accum_steps,
                clip_global_norm=clip_global_norm, sync_schedule=sync_schedule)
        world = self._mesh_world(strategy.graph_config.mesh)
        transformer = GraphTransformer(strategy, item, self._device, world,
                                       accum_steps=accum_steps,
                                       clip_global_norm=clip_global_norm,
                                       sync_schedule=sync_schedule)
        return DistributedSession(transformer, rng=rng, strategy_id=raw.id,
                                  batch_mask=batch_mask)

    def _async_session(self, item, strategy, run_id, **engine_options):
        """The async runtime's session (JAX ``_assemble_session``'s async
        branch); ``engine_options`` are the options only the synchronous
        engine implements, None where unset, and any set one raises."""
        from autodist_tpu_torch.kernel.synchronization.async_ps import AsyncPSEngineSession
        from autodist_tpu_torch.kernel.synchronization.async_service import (
            AsyncPSClusterSession)

        unsupported = sorted(k for k, v in engine_options.items() if v is not None)
        if unsupported:
            raise NotImplementedError(
                f"async PS runtime (sync=False) does not support {unsupported}; use the "
                f"synchronous engine or drop these options")
        spec = self._resource_spec
        if self._launching is not None:
            return self._launched_async_session(item, strategy, run_id)
        world = self.world
        n_nodes = len(spec.node_addresses)
        if world.size > 1 or n_nodes > 1 or ENV.AUTODIST_NUM_PROCESSES.val > 1:
            # one worker a process; the chief serves the parameters
            if world.size > 1:
                num, worker_id = world.size, world.rank
            else:
                num = n_nodes if n_nodes > 1 else ENV.AUTODIST_NUM_PROCESSES.val
                worker_id = None
            return AsyncPSClusterSession(strategy, item, run_id=run_id, num_workers=num,
                                         worker_id=worker_id, chief_host=spec.chief,
                                         device=self._device, world=world)
        if self._device.type == "cpu":
            devices = [self._device] * max(1, len(list(spec.devices)))
        else:
            devices = [torch_device(name) for name, _ in spec.gpu_devices] or [self._device]
        return AsyncPSEngineSession(strategy, item, devices=devices)

    def _launched_async_session(self, item, strategy, run_id):
        """``launch``'s async path: no process group; the chief binds the
        service, then launches the workers with its bound address and a
        fresh 256-bit authkey in their environment (never in its own)."""
        import secrets

        from autodist_tpu_torch.kernel.synchronization.async_service import (
            AsyncPSClusterSession)

        cl = self._launching
        authkey = secrets.token_bytes(32) if cl.is_chief else None
        sess = AsyncPSClusterSession(strategy, item, run_id=run_id,
                                     num_workers=cl.num_processes, worker_id=cl.process_id,
                                     chief_host=self._resource_spec.chief, authkey=authkey,
                                     device=self._device)
        if cl.is_chief:
            cl.launch_workers(run_id, extra_env={"AUTODIST_ASYNC_PS_AUTHKEY": authkey.hex(),
                                                 "AUTODIST_ASYNC_PS_ADDR": sess.address})
        return sess

    def launch(self, loss_fn, params, optimizer, *, coordinator_port=None, **kwargs):
        """The multi-process entry without a launcher (see the module's
        docstring): on the chief, build and serialise the strategy, launch
        a process for every other device of the spec (re-executing this
        script with the worker env contract) and join the process group;
        on a worker, join the group and load the strategy by id.  Every
        process returns the same session as :meth:`distribute` would;
        ``kwargs`` are ``distribute``'s.  The strategy's serialisation
        directory must be visible to the workers (a shared filesystem, as
        the reference's strategy hand-off assumes).  One process degrades
        to :meth:`distribute`."""
        from autodist_tpu_torch.cluster import Coordinator

        kw = {} if coordinator_port is None else {"coordinator_port": coordinator_port}
        self._coordinator = Coordinator(self._resource_spec, **kw)
        cl = self._coordinator.cluster
        if cl.num_processes <= 1 or (const.IS_AUTODIST_CHIEF and launched_world_size() > 1):
            return self.distribute(loss_fn, params, optimizer, **kwargs)
        self._launching = cl
        try:
            return self.distribute(loss_fn, params, optimizer, **kwargs)
        finally:
            self._launching = None
