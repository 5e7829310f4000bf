"""DistributedSession: the steady-state runtime (counterpart of
``autodist_tpu/runner.py``).

``run(global_batch)`` takes this replica's slice of dim 0 of a global
batch (a dict of numpy arrays or tensors; replica r of R gets rows
``[r * B/R, (r + 1) * B/R)``, the Remapper contract), moves it to the
device, runs one training step and returns its metrics; the loss, the
mean over the replicas, stays a 0-d device tensor, so the host waits for
the device only when the caller reads it.  ``params()`` and
``mutable_state()`` copy the current values, the same on every replica,
to the host.  ``evaluate``, telemetry, preemption, ``fit`` and checkpoints are
later slices of the port (ROADMAP, Queue A items 7 and 10).
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
        """This replica's slice of dim 0 of a global batch, on the device."""
        if not isinstance(batch, dict):
            raise TypeError(f"batches are dicts of arrays, got {type(batch).__name__}")
        world = self._t.world
        out = {}
        for key, value in batch.items():
            t = value if isinstance(value, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(value))
            if world.size > 1:
                if t.dim() == 0 or t.shape[0] % world.size:
                    raise ValueError(
                        f"batch[{key!r}] of shape {tuple(t.shape)}: dim 0 does not "
                        f"divide over {world.size} replicas")
                per = t.shape[0] // world.size
                t = t[world.rank * per:(world.rank + 1) * per]
            out[key] = t.to(self.device, non_blocking=True)
        return out

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
