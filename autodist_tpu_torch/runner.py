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
the same on every replica, to the host: the full, unpadded f32 parameters
also under ``precision="bf16_master"``, gathered from the master shards.

With ``batch_mask=True`` a dict batch whose dim 0 does not divide by the
replicas times ``accum_steps`` is padded by repeating its last row, and a
``BATCH_MASK_KEY`` leaf (1.0 real, 0.0 pad) tells the engine and the loss
which rows are real (:meth:`DistributedSession._pad_uneven`); without it
such a batch raises.

``run_steps`` and ``fit`` loop over ``run``; ``predict`` runs a forward
only and gathers its per-example outputs in batch order;
``check_replication`` names the variables whose copies differ between the
replicas.  ``evaluate``, telemetry, preemption and checkpoints are later
slices of the port (ROADMAP, Queue A items 7 and 10).
"""
from collections import OrderedDict

import numpy as np
import torch

from autodist_tpu_torch.const import BATCH_MASK_KEY
from autodist_tpu_torch.parallel import collectives as coll
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.tree import batch_leaves, map_batch


class DistributedSession:
    def __init__(self, transformer, rng=None, strategy_id="", batch_mask=False):
        self._t = transformer
        self.strategy_id = strategy_id   # the id of the strategy the chief built
        self.device = transformer.device
        self._batch_mask = bool(batch_mask)
        self._warned_uneven = False
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
                        f"divide over {count} replicas; for uneven dict batches pass "
                        f"distribute(..., batch_mask=True) with a loss that ignores "
                        f"'{BATCH_MASK_KEY}' rows (the train_lib losses do)")
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

        return map_batch(shard, batch)

    def _pad_uneven(self, batch):
        """(batch, pad): a dict batch whose dim 0 does not divide by the
        replicas times ``accum_steps``, padded to the next multiple by
        repeating its last row, with a ``BATCH_MASK_KEY`` leaf (1.0 real,
        0.0 pad); any other batch as it is, with pad 0.  The engine weights
        each replica's loss by its real rows, so the update is the mean
        over the real examples (the reference's ``remapper.py:109-118``);
        the loss must leave masked rows out of its own mean."""
        if not isinstance(batch, dict) or BATCH_MASK_KEY in batch:
            return batch, 0
        sizes = {leaf.shape[0] for leaf in batch_leaves(batch) if np.ndim(leaf) >= 1}
        if len(sizes) != 1:
            return batch, 0   # mixed leading dims: the divisibility check speaks
        (rows,) = sizes
        multiple = self._t.world.data_slice[1] * self._t.accum_steps
        pad = (-rows) % multiple
        if pad == 0:
            return batch, 0
        if not self._warned_uneven:
            self._warned_uneven = True
            logging.warning("Global batch %d does not divide by %d (replicas x "
                            "accum_steps): padding %d row(s) and a '%s' mask (the loss "
                            "must ignore masked rows; logged once)", rows, multiple, pad,
                            BATCH_MASK_KEY)

        def pad_leaf(leaf, _):
            if np.ndim(leaf) == 0:
                return leaf
            if isinstance(leaf, torch.Tensor):
                return torch.cat([leaf, leaf[-1:].expand(pad, *leaf.shape[1:])])
            leaf = np.asarray(leaf)
            return np.concatenate([leaf, np.repeat(leaf[-1:], pad, axis=0)])

        padded = map_batch(pad_leaf, batch)
        mask = np.zeros((rows + pad,), np.float32)
        mask[:rows] = 1.0
        padded[BATCH_MASK_KEY] = mask
        return padded, pad

    def run(self, batch):
        """One training step on a global batch; returns the metrics dict."""
        if self._batch_mask:
            batch, _ = self._pad_uneven(batch)
        self.state, metrics = self._t.step(self.state, self.shard_batch(batch))
        return metrics

    def run_steps(self, batches, log_every=0):
        """One step per batch of ``batches``; returns the last metrics."""
        metrics = None
        for i, batch in enumerate(batches):
            metrics = self.run(batch)
            if log_every and (i + 1) % log_every == 0:
                logging.info("step %d: %s", i + 1, _metrics_str(metrics))
        return metrics

    def fit(self, batch_fn, steps, *, checkpoint_path=None, save_every=0, log_every=0,
            resume=True, preempt_checkpoint_dir=None):
        """Train until ``self.step == steps``, step s on ``batch_fn(s)``;
        returns the last metrics (None when no step ran).  Checkpoints and
        preemption are a later slice (ROADMAP, Queue A item 7) and raise."""
        del save_every, resume   # they tune checkpoints
        if checkpoint_path or preempt_checkpoint_dir:
            raise NotImplementedError(
                "fit(checkpoint_path=..., preempt_checkpoint_dir=...): checkpoints "
                "are a later slice of the port (ROADMAP, Queue A item 7)")
        metrics = None
        while self.step < steps:
            metrics = self.run(batch_fn(self.step))
            if log_every and self.step % log_every == 0:
                logging.info("step %d: %s", self.step, _metrics_str(metrics))
        return metrics

    def predict(self, batch, apply_fn=None):
        """The forward alone on a global batch: ``apply_fn(params[, state],
        batch) -> outputs`` (default: the ``eval_fn`` given to
        ``distribute``) under ``no_grad`` on this rank's slice, with the
        full parameters of :meth:`params` (bf16-master ones gathered in
        f32, as JAX's ``canonicalize_params``).  Every output
        leaf must be per example, dim 0 the slice's rows: the leaves are
        gathered from the replicas in batch order, trimmed of the rows
        ``batch_mask`` padded, and returned on the host in the outputs'
        structure.  A leaf without that dim 0 raises ``ValueError`` naming
        its path (JAX computes such an output over the global batch; the
        port does not guess the reduction)."""
        apply_fn = apply_fn or self._t.model_item.eval_fn
        if apply_fn is None:
            raise ValueError("No eval_fn: pass apply_fn or distribute(eval_fn=...)")
        if self._t.seq_axis is not None:
            raise NotImplementedError(
                "predict under sequence parallelism is a later slice of the port "
                "(ROADMAP, Queue A item 9)")
        pad = 0
        if self._batch_mask:
            batch, pad = self._pad_uneven(batch)
        local = self.shard_batch(batch)
        rows = {leaf.shape[0] for leaf in batch_leaves(local) if leaf.dim()}
        mutable = self.state["mutable"]
        params = self._t.canonical_params(self.state)
        with torch.no_grad():
            out = (apply_fn(params, local) if mutable is None
                   else apply_fn(params, mutable, local))

        def gather(leaf, path):
            if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0 or rows != {leaf.shape[0]}:
                raise ValueError(
                    f"predict: output {path} of shape {tuple(np.shape(leaf))} is not "
                    f"per example (dim 0 = this replica's {sorted(rows)} rows); return "
                    f"per-example outputs and reduce them on the host")
            full = coll.all_gather_into_tensor(leaf, self._t.group).cpu()
            return full[:full.shape[0] - pad]

        return map_batch(gather, out, "outputs")

    def check_replication(self, atol=0.0):
        """The names of the stored (REPLICATED) variables whose copy on some
        replica differs from rank 0's by more than ``atol`` (for a
        bf16-master variable its bf16 compute copy, the full-shape tensor
        it stores; its master is sharded); every rank returns the same list
        ([] when the copies agree)."""
        group = self._t.group
        if group is None:
            return []
        names = list(self.state["params"])
        flags = torch.zeros(len(names), dtype=torch.int32, device=self.device)
        for i, name in enumerate(names):
            mine = self.state["params"][name].detach()
            ref = mine.clone()
            torch.distributed.broadcast(ref, src=torch.distributed.get_global_rank(group, 0),
                                        group=group)
            flags[i] = int(not torch.allclose(mine, ref, rtol=0.0, atol=atol))
        torch.distributed.all_reduce(flags, op=torch.distributed.ReduceOp.MAX, group=group)
        return [n for n, f in zip(names, flags.tolist()) if f]

    def params(self):
        """The current full, unpadded parameters by '/'-joined name, copied
        to the host (JAX's ``canonicalize_params``: bf16-master variables
        gathered from their f32 master shards)."""
        return OrderedDict((n, t.detach().cpu().clone())
                           for n, t in self._t.canonical_params(self.state).items())

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


def _metrics_str(metrics):
    return ", ".join(f"{k}={float(v):.6g}" if isinstance(v, torch.Tensor) else f"{k}={v}"
                     for k, v in metrics.items())
