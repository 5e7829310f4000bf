"""Collectives over a process group (counterpart of the parts of
``autodist_tpu/parallel/collectives.py`` and ``autodist_tpu/kernel/
collectives.py`` that the sync codecs and sequence parallelism use).

The JAX package binds ``jax.lax`` collectives to a mesh axis name inside
``shard_map``; here one process runs each replica and the collectives run
over a ``torch.distributed`` process group (NCCL on CUDA, gloo on the
CPU): the whole world for the gradient sync, a seq row for ring
attention, a node's ranks or one rank of each node for the two-level
sync.  ``group=None`` means a group of one: every function is then the
identity and needs no process group.

:func:`psum_scatter`, :func:`all_gather_into_tensor`, :func:`psum` and
:func:`axis_size` also take an :class:`AxisGroup`, a mesh axis tuple's
ranks (:meth:`ReplicaWorld.axis_group
<autodist_tpu_torch.parallel.mesh.ReplicaWorld.axis_group>`).  JAX's tiled
collectives over a tuple order the blocks by the index along the tuple;
a process group orders its ranks ascending, which differs for a tuple
such as ``(replica_ici, replica_dcn)``: the blocks are permuted on the way
in (scatter) or out (gather), so that each rank gets the block of its
tuple index, as in JAX.

- :func:`axis_size`, :func:`axis_index` -- the number of ranks and this
  rank's index (``jax.lax.axis_size``, ``jax.lax.axis_index``);
- :func:`psum`, :func:`pmean` -- sum and mean over the ranks;
- :func:`all_to_all_single` -- tiled all-to-all over dim 0: rank d
  receives row block d of every peer, in peer order
  (``jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``);
- :func:`all_to_all` -- the same over any split and concat dims,
  differentiable (Ulysses attention);
- :func:`psum_scatter` -- tiled reduce-scatter over dim 0: rank d
  receives the sum over the ranks of row block d
  (``jax.lax.psum_scatter(scatter_dimension=0, tiled=True)``);
- :func:`all_gather_into_tensor` -- tiled all-gather over dim 0
  (``jax.lax.all_gather(axis=0, tiled=True)``);
- :func:`ring_perm`, :func:`ppermute` -- a permutation of the group's
  ranks and the point-to-point exchange along it (``jax.lax.ppermute``);
  :func:`ppermute_ad` differentiates it as JAX does, by the inverse
  permutation.

Each returns new tensors and leaves its inputs as they were.
"""
import dataclasses
import warnings
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The ranks of a mesh axis tuple through this rank, as JAX's
    collectives over the tuple see them: ``size`` ranks, this rank at
    ``index`` along the tuple (``jax.lax.axis_index``: row-major over the
    tuple's axes in its order), ``group`` their process group (None for
    one rank), ``order[k]`` the tuple index of the group's k-th rank."""

    group: Any
    size: int
    index: int
    order: tuple

    @property
    def permuted(self):
        """True when the group's rank order is not the tuple's."""
        return self.order != tuple(range(self.size))


def _process_group(group):
    return group.group if isinstance(group, AxisGroup) else group


def axis_size(group=None):
    """Ranks in ``group`` (1 for ``None``)."""
    if isinstance(group, AxisGroup):
        return group.size
    return 1 if group is None else dist.get_world_size(group)


def axis_index(group=None):
    """This rank's index in ``group``: along the tuple for an
    :class:`AxisGroup` (``jax.lax.axis_index``), else its group rank."""
    if isinstance(group, AxisGroup):
        return group.index
    return 0 if group is None else dist.get_rank(group)


def psum(x, group=None):
    """Sum over the replicas."""
    group = _process_group(group)
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


def psum_scatter(x, group=None):
    """Tiled reduce-scatter over dim 0: dim 0 splits into one row block per
    replica; replica d receives the sum of block d over the replicas (d its
    index along the tuple of an :class:`AxisGroup`)."""
    if _process_group(group) is None:
        return x
    r = axis_size(group)
    if x.shape[0] % r:
        raise ValueError(f"dim 0 ({x.shape[0]}) does not split over {r} replicas")
    if isinstance(group, AxisGroup):
        if group.permuted:   # the group's k-th rank receives block order[k]
            x = x.unflatten(0, (r, -1))[list(group.order)].flatten(0, 1)
        group = group.group
    out = x.new_empty((x.shape[0] // r,) + tuple(x.shape[1:]))
    with warnings.catch_warnings():
        # newer torch names it reduce_scatter_single; older releases lack that name
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather_into_tensor(x, group=None):
    """Tiled all-gather over dim 0: every replica's ``x`` in replica order
    (the order along the tuple of an :class:`AxisGroup`)."""
    pg = _process_group(group)
    if pg is None:
        return x
    r = axis_size(group)
    out = x.new_empty((r * x.shape[0],) + tuple(x.shape[1:]))
    with warnings.catch_warnings():
        # newer torch names it all_gather_single; older releases lack that name
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x.contiguous(), group=pg)
    if isinstance(group, AxisGroup) and group.permuted:   # block k goes to order[k]
        inverse = sorted(range(r), key=lambda k: group.order[k])
        out = out.unflatten(0, (r, -1))[inverse].flatten(0, 1)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.config = (group, split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        group, split_axis, concat_axis = ctx.config
        return _all_to_all(grad, group, concat_axis, split_axis), None, None, None


def _all_to_all(x, group, split_axis, concat_axis):
    r = axis_size(group)
    if x.shape[split_axis] % r:
        raise ValueError(f"dim {split_axis} ({x.shape[split_axis]}) does not split over "
                         f"{r} ranks")
    blocks = all_to_all_single(torch.stack(x.chunk(r, dim=split_axis)), group)
    return torch.cat(blocks.unbind(0), dim=concat_axis)


def all_to_all(x, group, split_axis, concat_axis):
    """Tiled all-to-all: ``split_axis`` splits into one block per rank, rank
    d receives block d of every peer and concatenates them along
    ``concat_axis`` in peer order (``jax.lax.all_to_all(..., tiled=True)``).
    Differentiable: the gradient takes the inverse exchange."""
    if group is None:
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def ring_perm(size):
    """The closed rotation ring: index ``i`` sends to ``(i + 1) % size``."""
    return [(i, (i + 1) % size) for i in range(size)]


def _check_perm(perm, size):
    srcs = [int(a) for a, _ in perm]
    dsts = [int(b) for _, b in perm]
    if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
            or not all(0 <= i < size for i in srcs + dsts)):
        raise ValueError(f"ppermute: {perm} is not a permutation of indices in "
                         f"[0, {size})")


def ppermute(x, group, perm):
    """Send ``x`` along ``perm``, pairs ``(src, dst)`` of indices in
    ``group``; returns what this rank receives, zeros where no index sends
    to it (``jax.lax.ppermute``).  ``x`` may be a tensor or a tuple of
    tensors, all sent in one exchange.  Every rank posts its send and its
    receive together (``batch_isend_irecv``, peers by global rank).
    ``group=None``: the identity."""
    if group is None:
        return x
    many = isinstance(x, (tuple, list))
    xs = [t.contiguous() for t in (x if many else (x,))]
    size, me = axis_size(group), dist.get_rank(group)
    _check_perm(perm, size)
    dst = [int(b) for a, b in perm if int(a) == me]
    src = [int(a) for a, b in perm if int(b) == me]
    outs = [torch.empty_like(t) for t in xs]
    ops = []
    if dst:
        peer = dist.get_global_rank(group, dst[0])
        ops += [dist.P2POp(dist.isend, t, peer, group) for t in xs]
    if src:
        peer = dist.get_global_rank(group, src[0])
        ops += [dist.P2POp(dist.irecv, out, peer, group) for out in outs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if not src:
        for out in outs:
            out.zero_()
    return tuple(outs) if many else outs[0]


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.config = (group, perm)
        return ppermute(x, group, perm)

    @staticmethod
    def backward(ctx, grad):
        group, perm = ctx.config
        return ppermute(grad, group, [(b, a) for a, b in perm]), None, None


def ppermute_ad(x, group, perm):
    """:func:`ppermute` of one tensor, differentiable: the gradient travels
    the inverse permutation, as JAX differentiates ``ppermute``."""
    if group is None:
        return x
    return _PPermute.apply(x, group, tuple(tuple(p) for p in perm))
