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
CPU.  Without a GPU and without that request it raises.  ``launch``,
``serve``, ``aot_compile``, the async and stale PS (``PS(sync=False)``,
``staleness > 0``) and the options ``data_axes``, ``batch_spec``,
``param_specs``, ``verify`` and ``sparse_vars`` are
later slices of the port (ROADMAP, Queue A); they raise
``NotImplementedError``.
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
            self._world = replica_world(self._device)
        return self._world

    def _mesh_world(self, mesh):
        """:attr:`world` placed on a compiled strategy's mesh, built once per
        mesh (every rank builds the same meshes in the same order)."""
        key = (tuple(mesh.axis_names), tuple(int(x) for x in mesh.axis_sizes))
        if key not in self._mesh_worlds:
            self._mesh_worlds[key] = mesh_world(self.world, *key)
        return self._mesh_worlds[key]

    @property
    def is_chief(self):
        return const.IS_AUTODIST_CHIEF and self.world.rank == 0

    def _build_or_load_strategy(self, model_item) -> Strategy:
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
        if const.IS_AUTODIST_CHIEF:
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
                   sync_schedule: Optional[str] = None, **options):
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
        strategy's issue schedule.
        """
        from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
        from autodist_tpu_torch.runner import DistributedSession

        unknown = set(options) - set(_LATER_OPTIONS)
        if unknown:
            raise TypeError(f"distribute() got unexpected options {sorted(unknown)}")
        later = {k: _LATER_OPTIONS[k][1] for k, v in options.items()
                 if v != _LATER_OPTIONS[k][0]}
        if sparse_vars:
            later["sparse_vars"] = 6
        if later:
            raise NotImplementedError(
                "distribute options are later slices of the port: " + ", ".join(
                    f"{k} (ROADMAP, Queue A item {item})" for k, item in sorted(later.items())))
        if remat:
            loss_fn = functools.partial(checkpoint, loss_fn)
        item = ModelItem(loss_fn, params, optimizer, sparse_vars=sparse_vars,
                         has_aux=has_aux, has_rng=has_rng, mutable_state=mutable_state,
                         eval_fn=eval_fn, name=name)
        raw = self._build_or_load_strategy(item)
        strategy = StrategyCompiler(item, self._resource_spec).compile(raw)
        world = self._mesh_world(strategy.graph_config.mesh)
        transformer = GraphTransformer(strategy, item, self._device, world,
                                       accum_steps=accum_steps,
                                       clip_global_norm=clip_global_norm,
                                       sync_schedule=sync_schedule)
        return DistributedSession(transformer, rng=rng, strategy_id=raw.id,
                                  batch_mask=batch_mask)
