"""Sparse (embedding) gradients (counterpart of ``autodist_tpu/ops/sparse.py``).

PyTorch's gradient of a row gather is a dense scatter-add, as JAX's is.
The sparse communication therefore lives in the lookup's backward pass:

- :func:`embedding_lookup` on a table gathers ``table[ids]``.  Inside the
  training step (the graph transformer enters :func:`replica_axis_context`
  with the replicas' group) its backward all-gathers only the touched rows
  and their ids across the replicas, O(batch x dim) on the wire and not
  O(vocab x dim), scatter-adds them into the dense gradient and divides by
  the replica count.  That gradient is already the replicas' mean, so the
  step syncs a ``sparse_vars`` variable no further.  Outside the step it is
  ``table[ids]`` with a local gradient.
- A table whose storage is split on dim 0 over the replicas (a sparse
  variable under :class:`~autodist_tpu_torch.strategy.PartitionedPS`)
  reaches the loss as a :class:`ShardedTable`, this replica's block of
  rows; the lookup exchanges rows (:class:`_ShardedLookup`) and no replica
  ever holds the ``(vocab, dim)`` table or its gradient.

Contract, as in JAX: a ``sparse_vars`` variable is used only through
synced lookups.  A tied use (``h @ table.T``) adds a local dense gradient
the step would not sync: pass ``sync=False`` and leave such a variable out
of ``sparse_vars``, so that the dense sync takes its whole gradient.
"""
import contextlib
import contextvars

import torch

from autodist_tpu_torch.parallel import collectives as coll

_REPLICA_GROUP = contextvars.ContextVar("autodist_tpu_torch_replica_group", default=None)


@contextlib.contextmanager
def replica_axis_context(group):
    """Run the body with ``group`` (a process group or an
    :class:`~autodist_tpu_torch.parallel.collectives.AxisGroup`; None for one
    replica) as the group the sparse backward passes sync over."""
    token = _REPLICA_GROUP.set(group)
    try:
        yield
    finally:
        _REPLICA_GROUP.reset(token)


def current_replica_axis():
    """The group of :func:`replica_axis_context`, or None."""
    return _REPLICA_GROUP.get()


def _rows(table, flat_ids):
    return table.index_select(0, flat_ids)


class _Lookup(torch.autograd.Function):
    """``table[ids]`` whose backward syncs the row gradients over ``group``."""

    @staticmethod
    def forward(ctx, table, ids, group):
        flat = ids.reshape(-1).long()
        ctx.save_for_backward(flat)
        ctx.group, ctx.shape = group, tuple(table.shape)
        return _rows(table, flat).reshape(tuple(ids.shape) + ctx.shape[1:])

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        rows = g.reshape((-1,) + ctx.shape[1:])
        if ctx.group is not None:   # the touched rows travel, not the table
            flat = coll.all_gather_into_tensor(flat, ctx.group)
            rows = coll.all_gather_into_tensor(rows.contiguous(), ctx.group)
        dense = rows.new_zeros(ctx.shape).index_add_(0, flat, rows)
        if ctx.group is not None:
            dense = dense / coll.axis_size(ctx.group)
        return dense, None, None


class ShardedTable:
    """This replica's block of a table whose rows are split over the
    replicas: rows ``[i * B, (i + 1) * B)`` of the padded vocabulary on
    replica i, B the block's rows.  The graph transformer hands it to the
    loss in place of the table; :func:`embedding_lookup` dispatches on it.
    ``shape`` and ``dtype`` are the logical full table's, so shape checks
    in model code see the original table."""

    __slots__ = ("block", "group", "full_shape")

    def __init__(self, block, group, full_shape=None):
        self.block = block
        self.group = group
        self.full_shape = tuple(full_shape) if full_shape is not None else tuple(block.shape)

    @property
    def shape(self):
        return self.full_shape

    @property
    def ndim(self):
        return len(self.full_shape)

    @property
    def dtype(self):
        return self.block.dtype

    @property
    def device(self):
        return self.block.device


class _ShardedLookup(torch.autograd.Function):
    """The row exchange over a block-split table.  Forward: all-gather the
    ids; every replica contributes the rows it owns for every request (0
    elsewhere), and one reduce-scatter hands each replica exactly the rows
    its ids asked for: O(global batch x dim) on the wire.  Backward:
    all-gather the row cotangents and scatter-add the owned rows into the
    block (the discard row B takes the others), divided by the replicas:
    the block's share of the replicas' mean gradient."""

    @staticmethod
    def forward(ctx, block, ids, group):
        B = block.shape[0]
        gids = coll.all_gather_into_tensor(ids.reshape(-1).long(), group) \
            - coll.axis_index(group) * B
        owned = (gids >= 0) & (gids < B)
        rows = _rows(block, gids.clamp(0, B - 1))
        mask = owned.reshape((-1,) + (1,) * (block.dim() - 1))
        mine = coll.psum_scatter(torch.where(mask, rows, torch.zeros_like(rows)), group)
        ctx.save_for_backward(torch.where(owned, gids, torch.full_like(gids, B)))
        ctx.group, ctx.shape = group, tuple(block.shape)
        return mine.reshape(tuple(ids.shape) + ctx.shape[1:])

    @staticmethod
    def backward(ctx, g):
        (slots,) = ctx.saved_tensors
        rows = coll.all_gather_into_tensor(g.reshape((-1,) + ctx.shape[1:]).contiguous(),
                                           ctx.group)
        grad = rows.new_zeros((ctx.shape[0] + 1,) + ctx.shape[1:]).index_add_(0, slots, rows)
        return grad[:ctx.shape[0]] / coll.axis_size(ctx.group), None, None


def embedding_lookup(table, ids, sync=True):
    """Rows of ``table`` by integer ``ids`` (any leading shape): ``ids.shape
    + table.shape[1:]``.  ``sync=True`` (for the variables of
    ``sparse_vars``) syncs the gradient in the backward pass inside the
    training step; a :class:`ShardedTable` takes the row exchange;
    ``sync=False`` is a plain gather with a local gradient (see the module
    docstring for the contract)."""
    if isinstance(table, ShardedTable):
        return _ShardedLookup.apply(table.block, ids, table.group)
    if not sync:
        flat = ids.reshape(-1).long()
        return _rows(table, flat).reshape(tuple(ids.shape) + tuple(table.shape[1:]))
    return _Lookup.apply(table, ids, current_replica_axis())
