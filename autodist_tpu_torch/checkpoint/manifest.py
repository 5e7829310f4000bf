"""Checkpoint manifests: the layout a checkpoint was written under
(counterpart of ``autodist_tpu/checkpoint/manifest.py``, the same schema).

A manifest is a JSON file beside the checkpoint
(``<path>.manifest.json``) that records what another process, possibly
on another topology, needs to restore the state: the strategy id and the
membership epoch, the mesh (its axes and their sizes), the sync
hierarchy, and each variable's geometry: its storage shape (a partition
axis padded to a multiple of R), its update-space shape (the flat padded
``ceil(n/R) * R`` elements of the sharded weight update), its placement.
Shapes are global, as the JAX package lays its arrays out: a DIVERGENT
variable's storage is ``(R, *shape)``, the copies of the R replicas.

Two layouts exist.  ``"canonical"`` (:meth:`Saver.save`): every tensor
gathered and unpadded to the single-device shapes, R-independent; the
manifest is provenance.  ``"update_space"`` (:meth:`Saver.save_sharded`):
the state as it lies on the replicas, no gather; restoring it needs the
same geometry (bitwise) or the resharding path
(:mod:`autodist_tpu_torch.checkpoint.reshard`).

The schema is versioned; :func:`load_manifest` refuses a version newer
than this one.
"""
import json
import os
import time

from autodist_tpu_torch.kernel import partitioner as part
from autodist_tpu_torch.model_item import dtype_name
from autodist_tpu_torch.parallel.mesh import ReplicaWorld
from autodist_tpu_torch.utils import logging

SCHEMA_VERSION = 1
MANIFEST_SUFFIX = ".manifest.json"

LAYOUT_CANONICAL = "canonical"
LAYOUT_UPDATE_SPACE = "update_space"


def manifest_path(ckpt_path):
    return str(ckpt_path) + MANIFEST_SUFFIX


def _global(plan, shape, num_replicas):
    """A rank's shape as the JAX package's global array has it: a
    DIVERGENT variable's copies stacked on a leading replica axis."""
    shape = [int(s) for s in shape]
    return [num_replicas] + shape if plan.placement == part.Placement.DIVERGENT else shape


def var_geometry(transformer):
    """Per-variable layout records of a transformer's plans: the flat
    shards' padding plan, a SHARDED variable's padded storage, a DIVERGENT
    variable's stacked copies: what the reshard path needs to bring a
    saved tensor back to its canonical shape."""
    t, out = transformer, {}
    for name in t.names:
        plan = t.plans[name]
        out[name] = {
            "shape": [int(s) for s in plan.shape],
            "dtype": dtype_name(plan.dtype),
            "placement": plan.placement.value,
            "sync": plan.sync.value,
            "partition_axis": int(plan.partition_axis),
            "storage_shape": _global(plan, part.storage_shape(plan, t.num_replicas),
                                     t.num_replicas),
            "update_shape": _global(plan, part.update_space_shape(plan, t._R_for(plan)),
                                    t.num_replicas),
            "flat_update": bool(part.flat_shard_update(plan)),
            "sharded_update": bool(plan.sharded_update),
        }
    return out


def build_manifest(transformer, *, step, layout, epoch=0, strategy_id=None):
    """The manifest of a checkpoint about to be written."""
    if layout not in (LAYOUT_CANONICAL, LAYOUT_UPDATE_SPACE):
        raise ValueError(f"layout must be {LAYOUT_CANONICAL!r} or {LAYOUT_UPDATE_SPACE!r}, "
                         f"got {layout!r}")
    t = transformer
    return {
        "schema": SCHEMA_VERSION,
        "layout": layout,
        "strategy_id": strategy_id or getattr(t.strategy, "id", ""),
        "step": int(step),
        "epoch": int(epoch),
        "num_replicas": int(t.num_replicas),
        "mesh": {"axis_names": list(t.data_axes),
                 "axis_sizes": [int(t.axis_sizes[a]) for a in t.data_axes]},
        "data_axes": list(t.data_axes),
        "hierarchy": t.sync_hierarchy,
        "sharded_update": bool(t.sync_sharded_update),
        "sync_schedule": t.sync_schedule,
        "accum_steps": int(t.accum_steps),
        "vars": var_geometry(t),
        "wall_time": time.time(),
    }


def write_manifest(ckpt_path, manifest, world=None):
    """Write the manifest beside the checkpoint, on rank 0 of ``world``
    only (every rank would write the same bytes), through a temporary file
    renamed into place, so that an interrupted write leaves no truncated
    manifest; returns its path (None on the other ranks)."""
    if (world or ReplicaWorld(rank=0, size=1)).rank != 0:
        return None
    path = manifest_path(ckpt_path)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, path)
    logging.debug("Wrote checkpoint manifest %s (layout=%s step=%d epoch=%d R=%d)", path,
                  manifest["layout"], manifest["step"], manifest["epoch"],
                  manifest["num_replicas"])
    return path


def load_manifest(ckpt_path, required=False):
    """A checkpoint's manifest; None when it has none, unless ``required``."""
    path = manifest_path(ckpt_path)
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        if required:
            raise FileNotFoundError(
                f"No checkpoint manifest at {path}; only manifest checkpoints "
                f"(Saver.save / Saver.save_sharded) can be resharded") from None
        return None
    m = json.loads(text)
    if int(m.get("schema", 0)) > SCHEMA_VERSION:
        raise ValueError(f"Checkpoint manifest {path} has schema {m.get('schema')}; this "
                         f"build understands <= {SCHEMA_VERSION}")
    return m


def geometry_matches(transformer, manifest):
    """Whether a manifest's layout is the one this transformer's session
    holds, the gate between a direct (bitwise) restore of an update-space
    checkpoint and the resharding path.  Returns ``(ok, reasons)``,
    ``reasons`` naming every mismatch."""
    t, reasons = transformer, []
    if int(manifest["num_replicas"]) != t.num_replicas:
        reasons.append(f"num_replicas {manifest['num_replicas']} != {t.num_replicas}")
    if manifest.get("hierarchy") != t.sync_hierarchy:
        # a TWO_LEVEL bucket's shards and residuals are laid out ici-major:
        # a hierarchy change moves them even at equal R
        reasons.append(f"hierarchy {manifest.get('hierarchy')!r} != {t.sync_hierarchy!r}")
    here = var_geometry(t)
    saved = manifest.get("vars", {})
    if set(saved) != set(here):
        missing = sorted(set(saved) ^ set(here))
        reasons.append(f"variable set differs: {missing[:5]}")
    else:
        for name, e in saved.items():
            h = here[name]
            if e["placement"] != h["placement"]:
                reasons.append(f"{name}: placement {e['placement']} != {h['placement']}")
                continue
            for key in ("storage_shape", "update_shape"):
                if list(e[key]) != list(h[key]):
                    reasons.append(f"{name}: {key} {e[key]} != {h[key]}")
                    break
    return (not reasons), reasons
