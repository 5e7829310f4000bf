"""DistributedSession: the steady-state runtime (counterpart of
``autodist_tpu/runner.py``).

``run(global_batch)`` takes a global batch: a numpy array or tensor, or a
tuple, list or dict of them nested to any depth, as the reference's
``_shard_batch`` maps over any pytree.  Replica r of R gets rows ``[r *
B/R, (r + 1) * B/R)`` of every leaf (the Remapper contract) and, under
sequence parallelism on ``{"replica": R_d, "seq": R_s}``, rank (d, s)
rows ``[d * B/R_d, (d + 1) * B/R_d)`` and columns ``[s * S/R_s, (s + 1) *
S/R_s)`` of every leaf with a dim 1; the slices keep the batch's
structure.  ``run`` moves them to the device, runs one training step and
returns its metrics; the loss, the mean over the replicas, stays a 0-d
device tensor, so the host waits for the device only when the caller
reads it.  ``params()`` and ``mutable_state()`` copy the current values,
the same on every replica, to the host.  ``evaluate``, telemetry,
preemption, ``fit`` and checkpoints are later slices of the port
(ROADMAP, Queue A items 7 and 10).
"""
from collections import OrderedDict

import numpy as np
import torch


class DistributedSession:
    def __init__(self, transformer, rng=None, strategy_id=""):
        self._t = transformer
        self.strategy_id = strategy_id   # the id of the strategy the chief built
        self.device = transformer.device
        self.state = transformer.init_state(seed=0 if rng is None else rng)

    @property
    def transformer(self):
        """The :class:`GraphTransformer` whose step this session runs."""
        return self._t

    def shard_batch(self, batch):
        """This rank's slice of a global batch (dim 0, and dim 1 under
        sequence parallelism) of every array leaf, on the device, in the
        batch's structure.  A leaf that is not a numpy array or a tensor
        raises ``TypeError`` naming its path."""
        index, count = self._t.world.data_slice
        seq = self._t.seq_axis

        def shard(value, path):
            if isinstance(value, dict):
                return type(value)((k, shard(v, f"{path}[{k!r}]")) for k, v in value.items())
            if isinstance(value, (tuple, list)):
                leaves = [shard(v, f"{path}[{i}]") for i, v in enumerate(value)]
                return type(value)(*leaves) if hasattr(value, "_fields") else type(value)(leaves)
            if isinstance(value, torch.Tensor):
                t = value
            elif isinstance(value, np.ndarray):
                t = torch.from_numpy(np.ascontiguousarray(value))
            else:
                raise TypeError(f"{path}: batch leaves are numpy arrays or tensors, "
                                f"got {type(value).__name__}")
            if count > 1:
                if t.dim() == 0 or t.shape[0] % count:
                    raise ValueError(
                        f"{path} of shape {tuple(t.shape)}: dim 0 does not "
                        f"divide over {count} replicas")
                per = t.shape[0] // count
                t = t[index * per:(index + 1) * per]
            if seq is not None and seq.size > 1 and t.dim() > 1:
                if t.shape[1] % seq.size:
                    raise ValueError(
                        f"{path} of shape {tuple(t.shape)}: Batch dim 1 must be "
                        f"divisible by {seq.size} (sharded over the seq axis)")
                per = t.shape[1] // seq.size
                t = t[:, seq.index * per:(seq.index + 1) * per].contiguous()
            return t.to(self.device, non_blocking=True)

        return shard(batch, "batch")

    def run(self, batch):
        """One training step on a global batch; returns the metrics dict."""
        self.state, metrics = self._t.step(self.state, self.shard_batch(batch))
        return metrics

    def params(self):
        """The current parameters by '/'-joined name, copied to the host."""
        return OrderedDict((n, t.detach().cpu().clone())
                           for n, t in self.state["params"].items())

    def mutable_state(self):
        """The current mutable state (e.g. batch statistics) by '/'-joined
        name, copied to the host; None for a model without one."""
        mutable = self.state["mutable"]
        if mutable is None:
            return None
        return OrderedDict((n, t.cpu().clone()) for n, t in mutable.items())

    @property
    def step(self):
        return self.state["step"]
