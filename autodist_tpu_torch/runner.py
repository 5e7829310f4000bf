"""DistributedSession: the steady-state runtime (counterpart of
``autodist_tpu/runner.py``).

``run(batch)`` moves a host batch (a dict of numpy arrays or tensors) to
the device, runs one training step and returns its metrics; the loss stays
a 0-d device tensor, so the host waits for the device only when the caller
reads it.  ``params()`` and ``mutable_state()`` copy the current values to
the host.  ``evaluate``, telemetry, preemption, ``fit`` and checkpoints are
later slices of the port (ROADMAP, Queue A items 7 and 10).
"""
from collections import OrderedDict

import numpy as np
import torch


class DistributedSession:
    def __init__(self, transformer, rng=None):
        self._t = transformer
        self.device = transformer.device
        self.state = transformer.init_state(seed=0 if rng is None else rng)

    def _to_device(self, batch):
        if not isinstance(batch, dict):
            raise TypeError(f"batches are dicts of arrays, got {type(batch).__name__}")
        out = {}
        for key, value in batch.items():
            t = value if isinstance(value, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(value))
            out[key] = t.to(self.device, non_blocking=True)
        return out

    def run(self, batch):
        """One training step on a global batch; returns the metrics dict."""
        self.state, metrics = self._t.step(self.state, self._to_device(batch))
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
