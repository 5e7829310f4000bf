"""Rank bootstrap and the mesh: the port's counterpart of
``autodist_tpu/parallel/mesh.py`` (``build_mesh``, ``hierarchical_axes``)
for the data-parallel meshes ``{"replica": R}``, ``{"replica": R_d,
"seq": R_s}`` and ``{"replica_dcn": R_dcn, "replica_ici": R_ici}``.

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
row-major: on ``{"replica_dcn": R_dcn, "replica_ici": R_ici}`` rank r sits
at ``(dcn, ici) = divmod(r, R_ici)``.  For every proper subset of the
mesh's axes, each set of ranks that agree on the other axes gets a process
group (``dist.new_group``, called by every rank for every set in the same
order): on the two-level mesh the ICI groups (the ranks of one dcn index)
and the DCN groups (the ranks of one ici index).
:meth:`ReplicaWorld.axis_group` resolves an axis name or tuple, in any
order, to this rank's group and its place along the tuple, as JAX's
collectives over that axis see it.  On ``{"replica": R_d, "seq": R_s}``
the seq row (the R_s ranks of one d) also carries ring attention
(:class:`SeqAxis`); the gradient sync stays on the whole world.
"""
import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch.const import (AXIS_REPLICA, AXIS_REPLICA_DCN, AXIS_REPLICA_ICI,
                                      AXIS_SEQUENCE, ENV)
from autodist_tpu_torch.parallel.collectives import AxisGroup
from autodist_tpu_torch.parallel.context import SeqAxis


@dataclasses.dataclass(frozen=True)
class ReplicaWorld:
    """This process's place among the replicas; ``group`` is None for a
    one-process world (every collective is then the identity).  Under
    sequence parallelism (:func:`mesh_world`), ``seq`` is this rank's
    :class:`SeqAxis` and ``data_index`` its seq row's index among the
    ``size // seq.size`` rows, which slice dim 0 of the batch.  A world
    placed on a mesh knows its axes (``mesh_names``, ``mesh_sizes``) and
    the process group of each subset of them through this rank
    (``groups``, keyed by the axes in mesh order)."""

    rank: int
    size: int
    group: Optional[Any] = None
    seq: Optional[SeqAxis] = None
    data_index: int = 0
    mesh_names: tuple = ()
    mesh_sizes: tuple = ()
    groups: dict = dataclasses.field(default_factory=dict, compare=False, hash=False)

    @property
    def data_slice(self):
        """(index, count) of this rank's slice of the batch's dim 0."""
        if self.seq is None:
            return self.rank, self.size
        return self.data_index, self.size // self.seq.size

    def _axis_index(self, rank, axes):
        """``rank``'s index along ``axes``: its mesh coordinates on them,
        row-major in the tuple's order (``jax.lax.axis_index``)."""
        coords = dict(zip(self.mesh_names, np.unravel_index(rank, self.mesh_sizes)))
        sizes = dict(zip(self.mesh_names, self.mesh_sizes))
        index = 0
        for a in axes:
            index = index * sizes[a] + int(coords[a])
        return index

    def axis_group(self, axes):
        """The ranks of the mesh axis or axis tuple ``axes`` through this
        rank, as an :class:`AxisGroup`: their process group, this rank's
        index along the tuple, and the tuple index of each of the group's
        ranks in ascending order.  A one-process world answers any axes."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not self.mesh_names and self.size == 1:
            return AxisGroup(None, 1, 0, (0,))
        bad = [a for a in axes if a not in self.mesh_names]
        if bad or not axes or len(set(axes)) != len(axes):
            raise ValueError(f"axes {list(axes)} are not distinct axes of the mesh "
                             f"{list(self.mesh_names)}")
        key = tuple(a for a in self.mesh_names if a in axes)
        others = [i for i, a in enumerate(self.mesh_names) if a not in axes]
        mine = np.unravel_index(self.rank, self.mesh_sizes)
        members = [r for r in range(self.size)
                   if all(np.unravel_index(r, self.mesh_sizes)[i] == mine[i] for i in others)]
        return AxisGroup(self.groups[key], len(members), self._axis_index(self.rank, axes),
                         tuple(self._axis_index(r, axes) for r in members))


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


MESH_AXES = (AXIS_REPLICA, AXIS_SEQUENCE, AXIS_REPLICA_DCN, AXIS_REPLICA_ICI)


def check_mesh_axes(names):
    """Raise unless every axis is one the port realises (the data axes
    replica, replica_dcn, replica_ici and seq), each at most once, and seq
    does not meet the two-level axes."""
    other = [n for n in names if n not in MESH_AXES]
    if other or len(set(names)) != len(names):
        raise NotImplementedError(
            f"mesh axes {list(names)}: the port realises {list(MESH_AXES)}, each at most "
            f"once; the model-parallel axes are a later slice (ROADMAP, Queue A item 9)")
    if AXIS_SEQUENCE in names and {AXIS_REPLICA_DCN, AXIS_REPLICA_ICI} & set(names):
        raise NotImplementedError(
            f"mesh axes {list(names)}: sequence parallelism on a "
            f"{AXIS_REPLICA_DCN} x {AXIS_REPLICA_ICI} mesh is a later slice "
            f"(ROADMAP, Queue A item 9)")


def hierarchical_axes(resource_spec, n_devices):
    """``n_devices`` factored by the spec's hosts into ``{replica_dcn:
    hosts, replica_ici: devices per host}``; the flat ``{replica:
    n_devices}`` for one host or devices that do not split evenly (JAX
    ``parallel/mesh.py:35-50``)."""
    n_hosts = resource_spec.num_hosts if resource_spec is not None else 0
    if n_hosts > 1 and n_devices % n_hosts == 0:
        return {AXIS_REPLICA_DCN: n_hosts, AXIS_REPLICA_ICI: n_devices // n_hosts}
    return {AXIS_REPLICA: n_devices}


def mesh_world(world, names, sizes):
    """``world`` placed on the mesh ``names`` x ``sizes``.  Every rank must
    call it, in the same order: it creates the process groups of every
    proper subset of the axes (``dist.new_group`` for every set of ranks
    that agree on the other axes, on every rank; none for a set of one).
    Sequence parallelism is on when the mesh has a seq axis beside another,
    even at ``seq: 1`` (``graph_transformer.py:78`` of the JAX package);
    then the result carries this rank's :class:`SeqAxis` and seq-row index.
    A 1-D ``{"seq": R}`` is data parallel over its one axis, as in JAX."""
    names, sizes = tuple(names), tuple(int(x) for x in sizes)
    check_mesh_axes(names)
    check_replicas(math.prod(sizes), world)
    grid = np.arange(world.size).reshape(sizes)
    groups = {names: world.group}
    seq, data_index = None, 0
    for mask in range(1, (1 << len(names)) - 1):
        axes = [i for i in range(len(names)) if mask >> i & 1]
        rows = np.moveaxis(grid, axes, list(range(len(names) - len(axes), len(names))))
        rows = rows.reshape(-1, math.prod(sizes[i] for i in axes)).tolist()
        key = tuple(names[i] for i in axes)
        for i, row in enumerate(rows):
            group = dist.new_group(row) if len(row) > 1 else None
            if world.rank in row:
                groups[key] = group
                if key == (AXIS_SEQUENCE,):
                    seq, data_index = SeqAxis(group, row.index(world.rank), len(row)), i
    return dataclasses.replace(world, seq=seq, data_index=data_index, mesh_names=names,
                               mesh_sizes=sizes, groups=groups)


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
