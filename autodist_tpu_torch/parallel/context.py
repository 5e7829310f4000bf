"""Parallelism context (counterpart of ``autodist_tpu/parallel/context.py``).

The graph transformer enters :func:`seq_axis_context` around the loss, so
that library code (ring attention, the position offset of a sequence
block) finds the sequence axis without threading it through user code.
The JAX package keeps a mesh axis name there; the port keeps this rank's
:class:`SeqAxis`: the process group of its seq row, its index in that row
and the row's size (:func:`autodist_tpu_torch.parallel.mesh.mesh_world`
builds it).
"""
import contextlib
import contextvars
import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class SeqAxis:
    """This rank's place on the sequence axis: ``group`` holds the ranks of
    its seq row (None for a ring of one), ``index`` its position in the row,
    ``size`` the row's length.  Rank ``index`` holds sequence block
    ``index`` of every example of its data slice."""

    group: Optional[Any]
    index: int
    size: int


_SEQ_AXIS = contextvars.ContextVar("autodist_tpu_torch_seq_axis", default=None)


@contextlib.contextmanager
def seq_axis_context(axis):
    """Run the body with ``axis`` (a :class:`SeqAxis`, or None for no
    sequence parallelism) as the current sequence axis."""
    token = _SEQ_AXIS.set(axis)
    try:
        yield
    finally:
        _SEQ_AXIS.reset(token)


def current_seq_axis():
    """The :class:`SeqAxis` the sequence dimension is sharded over, or None."""
    return _SEQ_AXIS.get()


def seq_shard_info():
    """(index, size) of this rank along the sequence axis; (0, 1) when
    sequence parallelism is off."""
    axis = current_seq_axis()
    if axis is None:
        return 0, 1
    return axis.index, axis.size


def global_position_offset(local_len):
    """Global token position of this rank's first sequence position."""
    idx, _ = seq_shard_info()
    return idx * local_len
