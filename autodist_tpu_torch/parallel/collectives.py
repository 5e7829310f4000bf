"""Collectives over the replica group (counterpart of the parts of
``autodist_tpu/parallel/collectives.py`` that the sync codecs use).

The JAX package binds ``jax.lax`` collectives to a mesh axis name inside
``shard_map``; here one process runs each replica and the collectives run
over a ``torch.distributed`` process group (NCCL on CUDA, gloo on the
CPU).  ``group=None`` means one replica: every function is then the
identity and needs no process group.  A ``DeviceMesh`` of named axes
waits for the hierarchical slice (ROADMAP, Queue A item 5).

- :func:`axis_size` -- the number of replicas (``jax.lax.axis_size``);
- :func:`psum`, :func:`pmean` -- sum and mean over the replicas;
- :func:`all_to_all_single` -- tiled all-to-all over dim 0: replica d
  receives row block d of every peer, in peer order
  (``jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``);
- :func:`all_gather_into_tensor` -- tiled all-gather over dim 0
  (``jax.lax.all_gather(axis=0, tiled=True)``).

Each returns a new tensor and leaves its input as it was.
"""
import warnings

import torch
import torch.distributed as dist


def axis_size(group=None):
    """Replicas in ``group`` (1 for ``None``)."""
    return 1 if group is None else dist.get_world_size(group)


def psum(x, group=None):
    """Sum over the replicas."""
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def pmean(x, group=None):
    """Mean over the replicas: the sum, divided by their number."""
    if group is None:
        return x
    return psum(x, group) / axis_size(group)


def all_to_all_single(x, group=None):
    """Tiled all-to-all over dim 0: dim 0 splits into one row block per
    replica; replica d receives block d of every peer, in peer order."""
    if group is None:
        return x
    if x.shape[0] % axis_size(group):
        raise ValueError(f"dim 0 ({x.shape[0]}) does not split over "
                         f"{axis_size(group)} replicas")
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def all_gather_into_tensor(x, group=None):
    """Tiled all-gather over dim 0: every replica's ``x`` in replica order."""
    if group is None:
        return x
    out = x.new_empty((axis_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    with warnings.catch_warnings():
        # newer torch names it all_gather_single; older releases lack that name
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out
