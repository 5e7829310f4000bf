"""Rank bootstrap and the mesh: the port's counterpart of
``autodist_tpu/parallel/mesh.py::build_mesh`` for ``{"replica": R}`` and
``{"replica": R_d, "seq": R_s}``.

The JAX package runs every replica in one program over a device mesh.
The port runs one process per replica, as ``torchrun`` launches them, and
joins them in one ``torch.distributed`` process group.  :func:`replica_world`
reads the launcher's environment through :class:`const.ENV`: ``RANK``,
``WORLD_SIZE``, and either ``AUTODIST_INIT_METHOD`` (for example
``file:///path/to/store``) or ``MASTER_ADDR``/``MASTER_PORT`` (then
``env://``, which also joins the store a ``torchrun`` agent hosts);
``AutoDist`` puts each rank on ``cuda:LOCAL_RANK``.  It initialises the
process group once, with NCCL for CUDA devices and gloo for the CPU; a
group that the caller initialised already is taken as it is.
:func:`check_replicas` holds the world against the strategy: a spec of R
replicas runs in a world of exactly R processes, never silently as R = 1.

:func:`mesh_world` lays the ranks out on the strategy's mesh as
``build_mesh`` lays out devices, ``np.arange(R).reshape(sizes)``
row-major: on ``{"replica": R_d, "seq": R_s}`` rank r sits at ``(d, s) =
divmod(r, R_s)``.  Each seq row (the R_s ranks of one d) gets a process
group of its own for ring attention; the gradient sync stays on the whole
world.
"""
import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch.const import AXIS_REPLICA, AXIS_SEQUENCE, ENV
from autodist_tpu_torch.parallel.context import SeqAxis


@dataclasses.dataclass(frozen=True)
class ReplicaWorld:
    """This process's place among the replicas; ``group`` is None for a
    one-process world (every collective is then the identity).  Under
    sequence parallelism (:func:`mesh_world`), ``seq`` is this rank's
    :class:`SeqAxis` and ``data_index`` its seq row's index among the
    ``size // seq.size`` rows, which slice dim 0 of the batch."""

    rank: int
    size: int
    group: Optional[Any] = None
    seq: Optional[SeqAxis] = None
    data_index: int = 0

    @property
    def data_slice(self):
        """(index, count) of this rank's slice of the batch's dim 0."""
        if self.seq is None:
            return self.rank, self.size
        return self.data_index, self.size // self.seq.size


def factorize(n, sizes):
    """Resolve one -1 entry in ``sizes`` so the product equals n (the JAX
    package's ``parallel/mesh.py::_factorize``)."""
    sizes = list(sizes)
    neg = [i for i, s in enumerate(sizes) if s == -1]
    if len(neg) > 1:
        raise ValueError("At most one mesh axis may be -1")
    prod = math.prod(s for s in sizes if s != -1)
    if neg:
        if n % prod:
            raise ValueError(f"Cannot infer axis: {n} devices not divisible by {prod}")
        sizes[neg[0]] = n // prod
    elif prod != n:
        raise ValueError(f"Mesh axes {sizes} do not multiply to device count {n}")
    return sizes


MESH_AXES = (AXIS_REPLICA, AXIS_SEQUENCE)


def check_mesh_axes(names):
    """Raise unless every axis is one the port realises (replica, seq)."""
    other = [n for n in names if n not in MESH_AXES]
    if other or len(set(names)) != len(names):
        raise NotImplementedError(
            f"mesh axes {list(names)}: the port realises {list(MESH_AXES)}, each at most "
            f"once; the model-parallel axes are a later slice (ROADMAP, Queue A item 9)")


def mesh_world(world, names, sizes):
    """``world`` placed on the mesh ``names`` x ``sizes`` (replica and seq
    axes).  Sequence parallelism is on when the mesh has a seq axis beside
    another, even at ``seq: 1`` (``graph_transformer.py:78`` of the JAX
    package); then the result carries this rank's :class:`SeqAxis` and
    seq-row index.  Every rank must call it, in the same order: it creates
    one process group per seq row of more than one rank (``dist.new_group``
    for every row, on every rank).  Any other mesh, a 1-D ``{"seq": R}``
    among them (JAX shards dim 0 over it), returns ``world``."""
    names, sizes = tuple(names), [int(x) for x in sizes]
    check_mesh_axes(names)
    if AXIS_SEQUENCE not in names or len(names) == 1:
        return world
    check_replicas(math.prod(sizes), world)
    axis = names.index(AXIS_SEQUENCE)
    rows = np.moveaxis(np.arange(world.size).reshape(sizes), axis, -1).reshape(
        -1, sizes[axis])
    seq, data_index = None, 0
    for i, row in enumerate(rows.tolist()):
        group = dist.new_group(row) if len(row) > 1 else None
        if world.rank in row:
            seq, data_index = SeqAxis(group, row.index(world.rank), len(row)), i
    return dataclasses.replace(world, seq=seq, data_index=data_index)


def launched_world_size():
    """The process count the launcher asked for (``WORLD_SIZE``, else 1)."""
    return dist.get_world_size() if dist.is_initialized() else ENV.WORLD_SIZE.val


def _init_method():
    method = ENV.AUTODIST_INIT_METHOD.val
    if method:
        return method
    if not (ENV.MASTER_ADDR.val and ENV.MASTER_PORT.val):
        raise RuntimeError(
            f"WORLD_SIZE={ENV.WORLD_SIZE.val} but neither AUTODIST_INIT_METHOD nor "
            f"MASTER_ADDR and MASTER_PORT are set: launch with torchrun, or set them")
    return "env://"


def replica_world(device):
    """Join (or start) the process group of this launch; returns this
    process's :class:`ReplicaWorld`."""
    device = torch.device(device)
    if not dist.is_initialized():
        size = ENV.WORLD_SIZE.val
        if size == 1:
            return ReplicaWorld(rank=0, size=1)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=_init_method(), rank=ENV.RANK.val,
                                world_size=size)
    size = dist.get_world_size()
    return ReplicaWorld(rank=dist.get_rank(), size=size,
                        group=dist.group.WORLD if size > 1 else None)


def check_replicas(num_replicas, world):
    """A strategy of ``num_replicas`` replicas needs a world of as many
    processes; raises on a mismatch."""
    if num_replicas != world.size:
        raise ValueError(
            f"the strategy has {num_replicas} replicas but this launch has "
            f"WORLD_SIZE={world.size} process(es): run one process per replica "
            f"(torchrun --nproc-per-node {num_replicas}), or give a spec with "
            f"{world.size} device(s)")


def broadcast_text(text, world):
    """Rank 0's string on every rank of ``world``."""
    if world.group is None:
        return text
    box = [text]
    dist.broadcast_object_list(box, src=0, group=world.group)
    return box[0]
