"""Checkpointing with the single-device contract (counterpart of
``autodist_tpu/checkpoint/saver.py``).

:meth:`Saver.save` writes the state in its canonical form, the shapes the
single-device program holds: flat shards and SHARDED blocks gathered and
unpadded, DIVERGENT copies averaged, the optimizer state as the
``state_dict()`` of a ``torch.optim`` optimizer over the full parameters
in name order.  Such a checkpoint restores into a plain single-device
PyTorch program (:meth:`Saver.restore_single_device`, which needs no
process group, no session and no CUDA), or into a session under any
strategy and any number of replicas.  :meth:`Saver.save_sharded` writes
the live state as it lies on the replicas, with no gather: it restores
bitwise onto the same geometry, and through
:func:`autodist_tpu_torch.checkpoint.reshard.reshard_restore` onto another.

Storage is ``torch.distributed.checkpoint`` (DCP), one tensor per entry,
the tree's structure beside them as a pickled ``uint8`` tensor
(``<writer>__tree__``).  A canonical checkpoint has one writer, rank 0,
after the collectives that canonicalise.  An update-space checkpoint has
one writer per rank (``rank<r>/``: its SHARDED blocks, DIVERGENT copies
and bf16 masters, and the optimizer slots of its pieces) and rank 0
writes what every replica holds alike once (``shared/``), all in one
collective DCP save.  Every
checkpoint is written into ``<path>.tmp`` and renamed into place once
complete, so that an interrupted save leaves the previous checkpoint
readable (what ``fit``'s crash resume relies on).  The codecs' state
(error-feedback residuals, PowerSGD's ``Q`` and ``residual``), one per
rank, goes to a ``<path>.comp`` checkpoint of its own, so that the main
one keeps the single-device structure; a manifest
(:mod:`autodist_tpu_torch.checkpoint.manifest`) goes beside both.

Paths are local: a ``://`` path raises, as the JAX package's does where
``etils`` is not installed.  Each tree is pickled, as DCP pickles its own
plans: restore only checkpoints that this program wrote.
"""
import os
import pickle
import shutil
import warnings
from collections import OrderedDict

import torch

from autodist_tpu_torch.checkpoint import manifest as ckpt_manifest
from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.kernel.graph_transformer import load_slots
from autodist_tpu_torch.kernel.synchronization import all_reduce as ar_sync
from autodist_tpu_torch.utils import logging

TREE_KEY = "__tree__"
SHARED = "shared/"
_TENSOR = "\x00tensor:"   # a tensor's place in a pickled tree: its entry's key


_SINGLE_PROCESS = "torch.distributed is disabled"   # DCP's note that no_dist is meant


def rank_prefix(rank):
    return f"rank{rank}/"


def flatten(tree, prefix):
    """The DCP entries of ``tree``: each tensor (detached) under ``prefix``
    and its path, and the tree with every tensor replaced by a reference
    to its entry, pickled into a ``uint8`` tensor under ``prefix +
    TREE_KEY``."""
    tensors = {}

    def walk(x, path):
        if isinstance(x, torch.Tensor):
            key = prefix + "/".join(path)
            tensors[key] = x.detach()
            return _TENSOR + key
        if isinstance(x, dict):
            return type(x)((k, walk(v, path + (str(k),))) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, path + (str(i),)) for i, v in enumerate(x))
        return x

    skeleton = walk(tree, ())
    tensors[prefix + TREE_KEY] = torch.frombuffer(bytearray(pickle.dumps(skeleton)),
                                                  dtype=torch.uint8)
    return tensors


def _rebuild(x, tensors):
    if isinstance(x, str) and x.startswith(_TENSOR):
        return tensors[x[len(_TENSOR):]]
    if isinstance(x, dict):
        return type(x)((k, _rebuild(v, tensors)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return type(x)(_rebuild(v, tensors) for v in x)
    return x


def writers(path):
    """The writer prefixes of the DCP checkpoint at ``path`` (``""`` for a
    canonical one, ``"shared/"`` and ``"rank<r>/"`` for an update-space
    one)."""
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    return sorted(k[:-len(TREE_KEY)] for k in meta if k.endswith(TREE_KEY))


def read(path, prefixes=None):
    """``{prefix: tree}`` of the writers ``prefixes`` (default: every
    writer) of the DCP checkpoint at ``path``, as CPU tensors, read in this
    process alone (no collective); a prefix the checkpoint lacks raises
    ``KeyError``."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    prefixes = writers(path) if prefixes is None else list(prefixes)
    for p in prefixes:
        if p + TREE_KEY not in meta:
            raise KeyError(f"checkpoint {path} has no writer {p!r}")
    want = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
            for k, m in meta.items() if isinstance(m, TensorStorageMetadata)
            and any(k.startswith(p) for p in prefixes)}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_SINGLE_PROCESS)
        dcp.load(want, checkpoint_id=path, no_dist=True)
    return {p: _rebuild(pickle.loads(want[p + TREE_KEY].numpy().tobytes()), want)
            for p in prefixes}


def _barrier(world):
    if world.group is not None:
        torch.distributed.barrier(group=world.group)


def write(path, tensors, world, collective):
    """Write ``tensors`` as the DCP checkpoint at ``path``: into
    ``<path>.tmp`` (every rank's entries in one collective save when
    ``collective``, else rank 0's alone), renamed into place by rank 0
    once complete; every rank returns after the rename."""
    import torch.distributed.checkpoint as dcp

    tmp = path + ".tmp"
    if world.rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
    _barrier(world)
    if collective and world.group is not None:
        dcp.save(tensors, checkpoint_id=tmp, process_group=world.group)
    elif world.rank == 0:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=_SINGLE_PROCESS)
            dcp.save(tensors, checkpoint_id=tmp, no_dist=True)
    if world.rank == 0:
        old = path + ".old"
        shutil.rmtree(old, ignore_errors=True)
        if os.path.exists(path):
            os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    _barrier(world)


def _stateful(comp):
    """The buckets whose codec keeps state (a residual, PowerSGD's
    factors); a stateless bucket's is ``()``."""
    return OrderedDict((k, v) for k, v in comp.items()
                       if isinstance(v, torch.Tensor) or (isinstance(v, dict) and v))


def _layout(tree):
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    return {k: _layout(v) for k, v in tree.items()}


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return type(tree)((k, _to(v, device)) for k, v in tree.items())


class Saver:
    """Save and restore a :class:`DistributedSession`.  Every save writes a
    manifest beside the checkpoint: the strategy id, the mesh, the padding
    plan and the membership epoch it was written under, which the
    resharding restore reads."""

    def __init__(self, session=None):
        self._sess = session

    def _canonical_state(self):
        sess = self._sess
        t, state = sess.transformer, sess.state
        return {"params": t.canonical_params(state), "opt_state": t.canonical_opt_state(state),
                "mutable": state["mutable"], "step": int(state["step"]),
                "rng": int(state["rng"])}

    @staticmethod
    def _comp_sidecar(path):
        return path + ".comp"

    @staticmethod
    def _norm(path):
        """An absolute path for a local store; a remote URL as it is."""
        path = str(path)
        return path if "://" in path else os.path.abspath(path)

    @staticmethod
    def exists(path):
        """Whether a checkpoint exists at ``path``, without restoring it:
        ``fit`` decides "start fresh" from this, never from a restore's
        exception.  Remote stores (``gs://``, ...) raise ``ValueError``:
        probing them needs ``etils``, which the port does not use."""
        path = str(path)
        if "://" in path:
            raise ValueError(f"Cannot probe remote checkpoint path {path!r}: etils is "
                             f"unavailable")
        return os.path.exists(os.path.abspath(path))

    def save(self, path, epoch=None):
        """Write a canonical (single-device-shaped) checkpoint.  The
        codecs' state goes to ``<path>.comp``, so that the checkpoint keeps
        the single-device structure; the manifest records provenance (the
        membership ``epoch`` defaults to ``AUTODIST_EPOCH``).  Every rank
        calls it (the canonical form is gathered by collectives); rank 0
        writes."""
        path = self._norm(path)
        world = self._sess.transformer.world
        canonical = self._canonical_state()
        write(path, flatten(canonical, "") if world.rank == 0 else {}, world,
              collective=False)
        self._finish(path, ckpt_manifest.LAYOUT_CANONICAL, canonical["step"], epoch)
        logging.info("Saved checkpoint to %s (step %d)", path, canonical["step"])
        return path

    def save_sharded(self, path, epoch=None):
        """The preemption-fast checkpoint: the live state as laid out, no
        gather.  Each rank writes its SHARDED blocks, DIVERGENT copies and
        bf16 masters, the optimizer slots of those and of its flat shards,
        and the row of each flat shard; rank 0 writes once what every
        replica holds alike (a flat shard is a slice of it).  The
        manifest records the geometry: a restore onto the same one is
        bitwise, onto another it goes through
        :func:`~autodist_tpu_torch.checkpoint.reshard.reshard_restore` (a
        plain :meth:`restore` refuses it)."""
        path = self._norm(path)
        sess = self._sess
        t, state = sess.transformer, sess.state
        own = set(state["shards"]) | set(t.sharded_names) | set(t.divergent_names)
        sd = state["opt_state"].state_dict()
        slots = sd["state"]
        masters = {n for b in t.precision_buckets for n in b.var_names}
        mine = {"params": OrderedDict((n, state["params"][n]) for n in t.names
                                      if n in t.sharded_names or n in t.divergent_names),
                # a flat shard is a slice of the stored parameter, but for a bf16
                # master's: the only f32 copy
                "shards": OrderedDict((n, v) for n, v in state["shards"].items()
                                      if n in masters),
                "opt_state": OrderedDict((i, s) for i, s in slots.items() if t.names[i] in own),
                "rows": {n: t.shard_row(n) for n in state["shards"]}}
        tensors = flatten(mine, rank_prefix(t.world.rank))
        if t.world.rank == 0:
            shared = {"params": OrderedDict((n, v) for n, v in state["params"].items()
                                            if n not in t.sharded_names
                                            and n not in t.divergent_names),
                      "opt_state": {"state": OrderedDict((i, s) for i, s in slots.items()
                                                         if t.names[i] not in own),
                                    "param_groups": sd["param_groups"]},
                      "mutable": state["mutable"], "step": int(state["step"]),
                      "rng": int(state["rng"]), "names": list(t.names)}
            tensors.update(flatten(shared, SHARED))
        write(path, tensors, t.world, collective=True)
        self._finish(path, ckpt_manifest.LAYOUT_UPDATE_SPACE, int(state["step"]), epoch)
        logging.info("Saved sharded (update-space) checkpoint to %s (step %d)", path,
                     int(state["step"]))
        return path

    def _finish(self, path, layout, step, epoch):
        """The codec sidecar and the manifest of a written checkpoint; every
        rank returns once both are in place."""
        t = self._sess.transformer
        self._save_comp_sidecar(path)
        if epoch is None:
            epoch = ENV.AUTODIST_EPOCH.val
        ckpt_manifest.write_manifest(path, ckpt_manifest.build_manifest(
            t, step=step, layout=layout, epoch=epoch, strategy_id=self._sess.strategy_id),
            t.world)
        _barrier(t.world)

    def _save_comp_sidecar(self, path):
        t = self._sess.transformer
        sidecar = self._comp_sidecar(path)
        comp = _stateful(self._sess.state["comp"])
        if comp:
            write(sidecar, flatten(comp, rank_prefix(t.world.rank)), t.world, collective=True)
        elif t.world.rank == 0 and os.path.exists(sidecar):
            # never leave a stale sidecar at this path: a later restore would
            # pair these parameters with old residuals
            try:
                shutil.rmtree(sidecar)
            except OSError:
                logging.warning("Could not remove stale sidecar %s", sidecar)

    def restore(self, path):
        """Load a checkpoint into the session.  A canonical checkpoint
        restores under any strategy and any number of replicas; an
        update-space one restores bitwise when the session's geometry is
        the manifest's and raises ``ValueError`` otherwise (use
        :func:`~autodist_tpu_torch.checkpoint.reshard.reshard_restore`).
        The codecs' state comes from the sidecar when its layout is this
        session's, else it starts at zero, with a warning."""
        sess = self._sess
        path = self._norm(path)
        m = ckpt_manifest.load_manifest(path)
        if m is not None and m.get("layout") == ckpt_manifest.LAYOUT_UPDATE_SPACE:
            return self._restore_update_space(path, m)
        self.load_canonical(read(path, [""])[""])
        sess.state["comp"] = self._restore_comp(path)
        logging.info("Restored checkpoint %s (step %d)", path, sess.step)
        return sess.state

    def load_canonical(self, canonical):
        """Write a canonical state (parameters, optimizer state, mutable
        state, step and seed) into the session, each replica taking its
        piece of every update space."""
        sess = self._sess
        t, state = sess.transformer, sess.state
        t.uncanonical_params(state, canonical["params"])
        t.uncanonical_opt_state(state, canonical["opt_state"])
        self._load_counters(canonical)

    def _load_counters(self, tree):
        """The mutable state (on the device), step and seed of a saved tree."""
        state, mutable = self._sess.state, tree["mutable"]
        state["mutable"] = None if mutable is None else _to(mutable, self._sess.device)
        state["step"], state["rng"] = int(tree["step"]), int(tree["rng"])

    def _restore_update_space(self, path, m):
        """Bitwise restore of a :meth:`save_sharded` checkpoint: the
        manifest's geometry must be the session's."""
        sess = self._sess
        t, state = sess.transformer, sess.state
        ok, reasons = ckpt_manifest.geometry_matches(t, m)
        if not ok:
            raise ValueError(
                f"Checkpoint {path} was saved in the update-space layout for a different "
                f"geometry ({'; '.join(reasons[:4])}). A direct restore would silently "
                f"train on scrambled shards; use autodist_tpu_torch.checkpoint.reshard."
                f"reshard_restore(session, path) to re-lay it out for this mesh.")
        mine_key = rank_prefix(t.world.rank)
        trees = read(path, [SHARED, mine_key])
        shared, mine = trees[SHARED], trees[mine_key]
        with torch.no_grad():
            for n, v in list(shared["params"].items()) + list(mine["params"].items()):
                state["params"][n].copy_(v)
            for n, v in state["shards"].items():
                v.copy_(mine["shards"][n] if n in mine["shards"]
                        else t.uncanonical_leaf(state["params"][n], n))
        slots = dict(shared["opt_state"]["state"])
        slots.update(mine["opt_state"])
        load_slots(state["opt_state"], slots)
        self._load_counters(shared)
        state["comp"] = self._restore_comp(path)
        logging.info("Restored sharded (update-space) checkpoint %s (step %d, epoch %d)", path,
                     int(m["step"]), int(m.get("epoch", 0)))
        return state

    def _restore_comp(self, path):
        """The codecs' state for a restore at ``path``: this rank's entries
        of the sidecar when their layout is this session's, else a fresh
        start."""
        t = self._sess.transformer
        fresh = ar_sync.init_compressor_states(t.buckets, t.device)
        fresh_stateful = _stateful(fresh)
        sidecar = self._comp_sidecar(path)
        if fresh_stateful and os.path.exists(sidecar):
            key = rank_prefix(t.world.rank)
            try:
                saved = read(sidecar, [key])[key]
            except KeyError:   # written by fewer ranks
                saved = None
            if saved is not None and _layout(saved) == _layout(fresh_stateful):
                return OrderedDict(fresh, **_to(saved, t.device))
            logging.warning("Compressor sidecar %s does not match this strategy's bucket "
                            "layout; error-feedback residuals reset to zero (cross-strategy "
                            "resume)", sidecar)
        elif fresh_stateful:
            logging.warning("No compressor sidecar at %s; error-feedback residuals reset to "
                            "zero", sidecar)
        return fresh

    @staticmethod
    def restore_single_device(path, item=None):
        """A checkpoint as plain CPU tensors, for a single-device program
        with no session, no process group and no CUDA: a canonical one as
        ``{"params", "opt_state", "mutable", "step", "rng"}`` (``opt_state``
        loads into a vanilla ``torch.optim`` optimizer of the same kind over
        the parameters in name order), an update-space one as its writers'
        trees by name (``"shared"``, ``"rank0"``, ...).  With ``item`` (a
        tree of tensors and values), its tensors are filled in place and
        its other leaves replaced; the filled ``item`` is returned."""
        trees = read(Saver._norm(path))
        raw = trees[""] if list(trees) == [""] else {p.rstrip("/"): v for p, v in trees.items()}
        if item is None:
            return raw
        return _fill(item, raw)


def _fill(item, raw):
    if isinstance(item, torch.Tensor):
        with torch.no_grad():
            return item.copy_(raw)
    if isinstance(item, dict):
        for k in item:
            item[k] = _fill(item[k], raw[k])
        return item
    return raw


class SavedModelBuilder:
    """The serving export (JAX ``SavedModelBuilder``, built on
    ``jax.export``): its ``torch.export`` counterpart belongs with the
    ahead-of-time compilation of ROADMAP Queue A item 10."""

    def __init__(self, session):
        raise NotImplementedError(
            "SavedModelBuilder: the serving export is a later slice of the port (ROADMAP, "
            "Queue A item 10, with aot.py and torch.export)")


def load_serving(path):
    """The serving export's loader: a later slice, as
    :class:`SavedModelBuilder`."""
    raise NotImplementedError(
        "load_serving: the serving export is a later slice of the port (ROADMAP, Queue A "
        "item 10, with aot.py and torch.export)")
