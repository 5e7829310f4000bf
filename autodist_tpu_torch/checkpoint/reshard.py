"""The resharding restore: an R-way checkpoint onto R' replicas
(counterpart of ``autodist_tpu/checkpoint/reshard.py``).

A checkpoint that :meth:`Saver.save_sharded` wrote under one geometry (R,
the mesh's factorization, the hierarchy, the padding plan) is laid out
again for the restoring session in two steps:

1. saved layout -> canonical, by the manifest's record of the SAVED
   geometry: each rank's pieces of a variable are put together as the
   JAX package's global array (the flat shards' rows in row order, the
   SHARDED blocks along the partition axis, the DIVERGENT copies stacked on
   a leading replica axis), then brought to the variable's shape as JAX's
   ``_canon_saved_leaf`` does (``leaf[:n].reshape(shape)``, the padding
   sliced away, the copies' mean);
2. canonical -> this session's layout: the transformer's
   ``uncanonical_params`` / ``uncanonical_opt_state``, as a canonical
   restore.

Every rank of the restoring session reads the whole checkpoint to host
memory; the codecs' state, laid out for the saving topology, starts at
zero.  The JAX package then verifies the re-planned schedule before the
first step; that verifier is ROADMAP Queue A item 11, so ``verify=True``
raises, before the session's state is touched.
"""
import torch

from autodist_tpu_torch.checkpoint.manifest import (LAYOUT_UPDATE_SPACE, geometry_matches,
                                                    load_manifest)
from autodist_tpu_torch.kernel.synchronization import all_reduce as ar_sync
from autodist_tpu_torch.utils import logging


def _canon_saved_leaf(leaf, entry):
    """One saved tensor in the JAX package's global layout -> its canonical
    (variable-shaped) form, by the SAVED geometry; a tensor of no saved
    layout shape (a scalar slot such as ``step``) as it is."""
    shape = tuple(entry["shape"])
    got = tuple(leaf.shape)
    if entry["flat_update"] and got == tuple(entry["update_shape"]):
        n = 1
        for s in shape:
            n *= s
        return leaf[:n].reshape(shape)
    if entry["placement"] == "sharded" and got == tuple(entry["storage_shape"]):
        axis = int(entry["partition_axis"])
        return leaf.narrow(axis, 0, shape[axis])
    if entry["placement"] == "divergent" and got == tuple(entry["storage_shape"]):
        return leaf.mean(dim=0)
    return leaf


def _global(entry, pieces, rows):
    """The ranks' pieces of one variable (or one of its slots) as the
    global array: flat shards by ``rows`` (rank -> row), SHARDED blocks in
    rank order along the partition axis, DIVERGENT copies stacked."""
    first = pieces[0]
    if first.dim() == 0:   # a scalar slot: the same on every rank
        return first
    if entry["flat_update"]:
        by_row = dict(zip(rows, pieces))
        return torch.cat([by_row[r] for r in range(len(by_row))])
    if entry["placement"] == "sharded":
        return torch.cat(pieces, dim=int(entry["partition_axis"]))
    return torch.stack(pieces)


def _canonicalize_saved(transformer, manifest, trees):
    """Every writer's tree of an update-space checkpoint -> the canonical
    state, ordered by this transformer's variable names."""
    from autodist_tpu_torch.checkpoint.saver import SHARED, rank_prefix

    shared = trees[SHARED]
    ranks = [trees[rank_prefix(r)] for r in range(int(manifest["num_replicas"]))]
    names = shared["names"]
    entries = manifest["vars"]

    def canon(name, pieces):
        e = entries[name]
        rows = [tree["rows"].get(name) for tree in ranks]
        return _canon_saved_leaf(_global(e, pieces, rows), e)

    params = {}
    for name in names:
        e = entries[name]
        if name in ranks[0]["shards"]:   # a bf16 master: its flat f32 shards
            params[name] = canon(name, [tree["shards"][name] for tree in ranks])
        elif e["placement"] in ("sharded", "divergent"):
            params[name] = canon(name, [tree["params"][name] for tree in ranks])
        else:
            params[name] = shared["params"][name]
    index = {n: i for i, n in enumerate(transformer.names)}
    slots = {}
    for i, s in shared["opt_state"]["state"].items():
        slots[index[names[i]]] = s
    for i in ranks[0]["opt_state"]:
        name = names[i]
        slots[index[name]] = {k: canon(name, [tree["opt_state"][i][k] for tree in ranks])
                              if isinstance(v, torch.Tensor) else v
                              for k, v in ranks[0]["opt_state"][i].items()}
    opt_state = {"state": dict(sorted(slots.items())),
                 "param_groups": shared["opt_state"]["param_groups"]}
    return {"params": params, "opt_state": opt_state, "mutable": shared["mutable"],
            "step": shared["step"], "rng": shared["rng"]}


def reshard_restore(session, path, *, batch_shapes=None, verify=True, raise_on_error=True):
    """Restore a manifest checkpoint into ``session``, resharding when the
    saved geometry differs from the session's.

    A canonical checkpoint, or an update-space one of the session's own
    geometry, goes through :meth:`Saver.restore` (bitwise for the
    latter).  An update-space checkpoint of another geometry (R, mesh
    factorization, hierarchy or padding plan) is re-laid out (see the
    module's docstring); the codecs' state starts at zero.  ``verify=True``
    (the JAX default: the re-planned schedule's static and traced passes)
    needs the strategy verifier, ROADMAP Queue A item 11, and raises
    ``NotImplementedError`` before anything is read; pass ``verify=False``.
    Returns None, JAX's return without verification.  Every rank calls it.
    """
    if verify:
        raise NotImplementedError(
            "reshard_restore(verify=True): verifying the restored session's schedule is a "
            "later slice of the port (ROADMAP, Queue A item 11); pass verify=False")
    del batch_shapes, raise_on_error   # they tune the verification
    from autodist_tpu_torch.checkpoint.saver import Saver, read

    t = session.transformer
    path = Saver._norm(path)
    manifest = load_manifest(path, required=True)
    ok, reasons = geometry_matches(t, manifest)
    saver = Saver(session)
    if manifest.get("layout") != LAYOUT_UPDATE_SPACE or ok:
        # canonical checkpoints are R-independent; a matching update-space
        # geometry restores bitwise: both through the Saver
        saver.restore(path)
        return None
    logging.info("Resharding checkpoint %s: saved R=%d (%s, %s) -> this mesh R=%d (%s, %s); "
                 "%s", path, manifest["num_replicas"],
                 "x".join(str(s) for s in manifest["mesh"]["axis_sizes"]),
                 manifest.get("hierarchy", "flat"), t.num_replicas,
                 "x".join(str(t.axis_sizes[a]) for a in t.data_axes), t.sync_hierarchy,
                 "; ".join(reasons[:3]))
    canonical = _canonicalize_saved(t, manifest, read(path))
    fresh_comp = ar_sync.init_compressor_states(t.buckets, t.device)
    if any(isinstance(v, torch.Tensor) or v for v in fresh_comp.values()):
        logging.warning("Reshard restore: compressor state (error-feedback residuals) is "
                        "layout-bound to the saving topology; reinitialized to zero")
    saver.load_canonical(canonical)
    session.state["comp"] = fresh_comp
    logging.info("Resharded checkpoint %s restored at step %d (epoch %d)", path,
                 int(manifest["step"]), int(manifest.get("epoch", 0)))
    return None
