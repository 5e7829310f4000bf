"""Rank bootstrap for the flat replica axis: the port's counterpart of
``autodist_tpu/parallel/mesh.py::build_mesh`` for ``{"replica": R}``.

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
"""
import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from autodist_tpu_torch.const import ENV


@dataclasses.dataclass(frozen=True)
class ReplicaWorld:
    """This process's place among the replicas; ``group`` is None for a
    one-process world (every collective is then the identity)."""

    rank: int
    size: int
    group: Optional[Any] = None


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
