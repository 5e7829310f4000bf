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
also under ``precision="bf16_master"``, gathered from the master shards,
of SHARDED (partitioned) variables, gathered from their blocks, and of
DIVERGENT variables (a PS with ``staleness > 0``), the mean of the
replicas' copies, as JAX's fetch contract returns it.

With ``batch_mask=True`` a dict batch whose dim 0 does not divide by the
replicas times ``accum_steps`` is padded by repeating its last row, and a
``BATCH_MASK_KEY`` leaf (1.0 real, 0.0 pad) tells the engine and the loss
which rows are real (:meth:`DistributedSession._pad_uneven`); without it
such a batch raises.

``run_steps`` and ``fit`` loop over ``run``: ``fit`` with periodic
checkpoints and resume after a crash, both with preemption
(:class:`PreemptionGuard`: SIGTERM or SIGINT drains the step in flight,
writes an update-space checkpoint and returns); ``predict`` runs a forward
only and gathers its per-example outputs in batch order;
``check_replication`` names the variables whose copies differ between the
replicas; ``memory_stats`` reads each device's allocator.  Telemetry
(``run(trace_dir=...)``, ``finalize_telemetry``) and ``verify`` are later
slices of the port (ROADMAP, Queue A items 10 and 11): their arguments are
taken and raise ``NotImplementedError``, so that code written against the
JAX session's signatures fails loudly, never with a ``TypeError``.
"""
import contextlib
import os
import signal
import threading
from collections import OrderedDict

import numpy as np
import torch

from autodist_tpu_torch.const import BATCH_MASK_KEY
from autodist_tpu_torch.parallel import collectives as coll
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.tree import batch_leaves, map_batch


class PreemptionGuard:
    """The SIGTERM/SIGINT drain hook of the training loops (JAX
    ``PreemptionGuard``): inside it a signal only sets a flag, which the
    loop reads at the next step boundary, where it writes a checkpoint and
    returns cleanly.  The previous handlers come back on exit.  Off the
    main thread (where Python forbids ``signal.signal``) it is an inert
    flag holder."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._prev = {}
        self._received = None

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._on_signal)
        return self

    def _on_signal(self, signum, frame):
        logging.warning("Received signal %d: draining the in-flight step, then writing a "
                        "preemption checkpoint", signum)
        self._received = signum

    @property
    def requested(self):
        return self._received is not None

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev = {}
        return False


class DistributedSession:
    def __init__(self, transformer, rng=None, strategy_id="", batch_mask=False):
        self._t = transformer
        self.strategy_id = strategy_id   # the id of the strategy the chief built
        self.device = transformer.device
        self._batch_mask = bool(batch_mask)
        self._warned_uneven = False
        self.preempted = False   # set when a preemption checkpoint ended a loop
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

    def run(self, batch, trace_dir=None):
        """One training step on a global batch; returns the metrics dict.
        A profile of the step (``trace_dir``) is a later slice (ROADMAP,
        Queue A item 10) and raises."""
        if trace_dir is not None:
            raise NotImplementedError(
                "run(trace_dir=...): profiles are a later slice of the port (ROADMAP, "
                "Queue A item 10)")
        if self._batch_mask:
            batch, _ = self._pad_uneven(batch)
        self.state, metrics = self._t.step(self.state, self.shard_batch(batch))
        return metrics

    def _preempt_path(self, preempt_checkpoint_dir):
        return os.path.join(preempt_checkpoint_dir, "preempt_ckpt")

    def _preempt_save(self, preempt_checkpoint_dir):
        """Drain and write the preemption checkpoint: the update-space
        layout, no gather (the preemption window is short)."""
        from autodist_tpu_torch.checkpoint.saver import Saver

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        path = Saver(self).save_sharded(self._preempt_path(preempt_checkpoint_dir))
        logging.warning("Preemption checkpoint written to %s (step %d); exiting the "
                        "training loop cleanly", path, self.step)
        self.preempted = True
        return path

    def _preempt_resume(self, preempt_checkpoint_dir):
        """Resume from a preemption checkpoint when there is one and it is
        ahead of the session's step (a periodic checkpoint may be newer)."""
        from autodist_tpu_torch.checkpoint.manifest import load_manifest
        from autodist_tpu_torch.checkpoint.saver import Saver

        path = self._preempt_path(preempt_checkpoint_dir)
        if not Saver.exists(path):
            return
        m = load_manifest(path)
        if m is not None and int(m["step"]) <= self.step:
            return
        Saver(self).restore(path)
        logging.info("Resumed from preemption checkpoint %s at step %d", path, self.step)

    def run_steps(self, batches, log_every=0, preempt_checkpoint_dir=None):
        """One step per batch of ``batches``; returns the last metrics.
        With ``preempt_checkpoint_dir`` a SIGTERM or SIGINT drains the step
        in flight, writes an update-space checkpoint to
        ``<dir>/preempt_ckpt`` and returns, with ``preempted`` set (see
        :meth:`fit`)."""
        metrics = None
        with (PreemptionGuard() if preempt_checkpoint_dir
              else contextlib.nullcontext()) as guard:
            for i, batch in enumerate(batches):
                metrics = self.run(batch)
                if log_every and (i + 1) % log_every == 0:
                    logging.info("step %d: %s", i + 1, _metrics_str(metrics))
                if guard is not None and guard.requested:
                    self._preempt_save(preempt_checkpoint_dir)
                    break
        return metrics

    def fit(self, batch_fn, steps, *, checkpoint_path=None, save_every=0, log_every=0,
            resume=True, preempt_checkpoint_dir=None):
        """Train until ``self.step == steps``, step s on ``batch_fn(s)``;
        returns the last metrics (None when no step ran).

        With ``checkpoint_path`` it restores the checkpoint there on entry
        (``resume=True``; "start fresh" is decided by
        :meth:`Saver.exists`, never by a restore's exception), saves a
        canonical checkpoint every ``save_every`` steps and at the end, so
        that a crashed job run again with the same arguments goes on where
        it left off.  ``preempt_checkpoint_dir`` turns on
        :class:`PreemptionGuard`: on a signal the step in flight drains, an
        update-space checkpoint goes to ``<dir>/preempt_ckpt``, and ``fit``
        returns with ``self.preempted`` set; run again, it resumes from
        there when that checkpoint is ahead of ``checkpoint_path``'s.
        """
        saver = None
        self.preempted = False
        if checkpoint_path:
            from autodist_tpu_torch.checkpoint.saver import Saver

            saver = Saver(self)
            if resume:
                if Saver.exists(checkpoint_path):
                    saver.restore(checkpoint_path)
                    logging.info("fit: resumed from %s at step %d", checkpoint_path,
                                 self.step)
                else:
                    logging.info("fit: no checkpoint at %s; starting fresh",
                                 checkpoint_path)
        if preempt_checkpoint_dir and resume:
            self._preempt_resume(preempt_checkpoint_dir)
        metrics = None
        last_saved = -1
        with (PreemptionGuard() if preempt_checkpoint_dir
              else contextlib.nullcontext()) as guard:
            while self.step < steps:
                metrics = self.run(batch_fn(self.step))
                done = self.step
                if log_every and done % log_every == 0:
                    logging.info("step %d: %s", done, _metrics_str(metrics))
                if guard is not None and guard.requested:
                    self._preempt_save(preempt_checkpoint_dir)
                    break
                if saver and save_every and done % save_every == 0:
                    saver.save(checkpoint_path)
                    last_saved = done
        if saver and self.step != last_saved and metrics is not None and not self.preempted:
            saver.save(checkpoint_path)
        return metrics

    def predict(self, batch, apply_fn=None):
        """The forward alone on a global batch: ``apply_fn(params[, state],
        batch) -> outputs`` (default: the ``eval_fn`` given to
        ``distribute``) under ``no_grad`` on this rank's slice, with the
        full parameters of :meth:`params` (bf16-master ones gathered in
        f32, DIVERGENT copies averaged, as JAX's ``canonicalize_params``).
        Every output leaf must be per example, dim 0 the slice's rows: the leaves are
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
        it stores; its master is sharded; a SHARDED variable's blocks and a
        DIVERGENT variable's copies are not compared); every rank returns
        the same list ([] when the copies agree)."""
        group = self._t.group
        if group is None:
            return []
        skip = set(self._t.sharded_names) | set(self._t.divergent_names)
        names = [n for n in self.state["params"]
                 if n not in skip]   # a block or a divergent copy differs by design
        flags = torch.zeros(len(names), dtype=torch.int32, device=self.device)
        for i, name in enumerate(names):
            mine = self.state["params"][name].detach()
            ref = mine.clone()
            torch.distributed.broadcast(ref, src=torch.distributed.get_global_rank(group, 0),
                                        group=group)
            flags[i] = int(not torch.allclose(mine, ref, rtol=0.0, atol=atol))
        torch.distributed.all_reduce(flags, op=torch.distributed.ReduceOp.MAX, group=group)
        return [n for n, f in zip(names, flags.tolist()) if f]

    def memory_stats(self):
        """This rank's device memory by device name (JAX's per device):
        ``torch.cuda.memory_stats`` of a CUDA device (bytes and counts of
        its caching allocator), None for the CPU, which reports none."""
        dev = self.device
        return {str(dev): torch.cuda.memory_stats(dev) if dev.type == "cuda" else None}

    def verify(self, batch, hbm_bytes_per_device=None, raise_on_error=True):
        """The strategy verifier is a later slice (ROADMAP, Queue A item 11)."""
        raise NotImplementedError("verify: the strategy verifier is a later slice of the "
                                  "port (ROADMAP, Queue A item 11)")

    def finalize_telemetry(self):
        """Flush the session's telemetry: the port has none yet (ROADMAP,
        Queue A item 10), so there is nothing to flush; returns None, as
        JAX's does with telemetry off."""
        return None

    def params(self):
        """The current full, unpadded parameters by '/'-joined name, copied
        to the host (JAX's ``canonicalize_params``: bf16-master variables
        gathered from their f32 master shards, SHARDED ones from their
        blocks, DIVERGENT copies averaged); a collective where the state is
        sharded or divergent, so every rank calls it."""
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
