"""Asynchronous bounded-staleness parameter serving within one process
(counterpart of ``autodist_tpu/kernel/synchronization/async_ps.py``).

The reference's stale-sync PS gives every worker a size-``s`` token queue:
a fast worker may run up to ``s`` steps ahead of the slowest one, pushing
gradients computed against stale parameters while the stragglers catch up
(its integration case c9: a fast chief and a slow worker).  A training
step whose collectives meet every replica cannot express that, so the
DIVERGENT placement (:mod:`autodist_tpu_torch.kernel.partitioner`) covers
the synchronous reading of staleness, and this module is the asynchronous
runtime:

- the parameter server is host memory behind a lock: CPU tensors of the
  parameters and of the optimizer state, updated by the port's own
  optimizer (:mod:`autodist_tpu_torch.optim`) on the host as each push
  lands (async SGD), the push tagged with the version its gradient was
  computed against, and the stale pushes counted;
- every worker is a daemon thread with a ``torch.device`` of its own (one
  card may be named twice: two workers then share it, each on a CUDA
  stream of its own).  It pulls the parameters straight to its device,
  takes the value and gradient there, copies the gradients to the host
  outside the server's lock and pushes them;
- a token barrier (:class:`TokenBarrier`) holds the reference's bound: a
  worker may start a step at most ``staleness`` steps ahead of the slowest
  worker; it is not a lockstep barrier.

The loss runs the model through ``torch.func.functional_call``, which puts
the worker's tensors into the one shared module for the length of the
call: two threads inside it at once would read each other's parameters.
So one worker at a time enqueues its forward and backward (a lock of the
session); the device runs them on the workers' own streams, and the
copies to and from the host, the host update and the barrier waits
overlap.  A worker on a CUDA device whose kernel fails to build or launch
raises through :meth:`AsyncPSSession.run`; nothing falls back to the CPU.

The ``async_ps.*`` telemetry counters of the JAX package wait for the
port's registry (ROADMAP, Queue A item 10); the session keeps the same
numbers as attributes (``version``, ``stale_pushes``,
``barrier.max_lead_seen``) and each push's host times in ``timings``.
"""
import contextlib
import threading
import time
from collections import OrderedDict

import torch

from autodist_tpu_torch.kernel.device.resolver import resolve_device
from autodist_tpu_torch.model_item import flatten_params
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.rng import step_generator
from autodist_tpu_torch.utils.tree import map_batch

QUIESCE_S = 5.0   # after run's deadline, the shared grace for workers to stop


class TokenBarrier:
    """Bounded-lead barrier: ``wait_turn(w)`` blocks while worker ``w`` is
    more than ``staleness`` steps ahead of the slowest worker (the size-s
    token queue of the reference's stale PS)."""

    def __init__(self, num_workers, staleness):
        self._steps = [0] * num_workers
        self._cv = threading.Condition()
        self._s = max(0, int(staleness))
        self.max_lead_seen = 0

    def wait_turn(self, worker, stop=None):
        with self._cv:
            while (self._steps[worker] - min(self._steps) > self._s
                   and not (stop and stop.is_set())):
                self._cv.wait(timeout=0.05)
            # the lead at the step's start: what the size-s queue bounds
            self.max_lead_seen = max(self.max_lead_seen,
                                     self._steps[worker] - min(self._steps))

    def probe(self, worker):
        """Non-blocking :meth:`wait_turn`: True when ``worker`` is within
        the bound now (and its lead is recorded); the polled form of the
        cross-process clients."""
        with self._cv:
            lead = self._steps[worker] - min(self._steps)
            if lead <= self._s:
                self.max_lead_seen = max(self.max_lead_seen, lead)
                return True
            return False

    def advance(self, worker):
        with self._cv:
            self._steps[worker] += 1
            self._cv.notify_all()

    @property
    def steps(self):
        with self._cv:
            return list(self._steps)


def resolve_async_plans(strategy, model_item):
    """``(plans, staleness)`` of an async strategy, shared by the engine and
    the cluster sessions: the model must be one the async runtime runs (an
    optimizer, no ``eval_fn``, no ``mutable_state``), the strategy must
    hold an async (``sync=False``) PS node, and the bound is the least
    staleness over those nodes (only the tightest bound keeps every
    variable's contract).  AllReduce variables are served asynchronously
    too, with a warning: a worker that runs ahead cannot meet the others
    in a collective."""
    from autodist_tpu_torch.kernel.partitioner import SyncKind, build_var_plans

    if model_item.optimizer is None:
        raise ValueError("ModelItem has no optimizer")
    for feature, flag in (("eval_fn", model_item.eval_fn is not None),
                          ("mutable_state", model_item.mutable_state is not None)):
        if flag:
            raise NotImplementedError(
                f"async PS runtime does not support {feature} yet; use the "
                f"synchronous engine (sync=True)")
    plans = build_var_plans(strategy, model_item, num_replicas=1)
    stale = [p.staleness for p in plans.values() if p.sync == SyncKind.PS and not p.ps_sync]
    if not stale:
        raise ValueError("strategy has no async (sync=False) PS node; the synchronous "
                         "engine handles it")
    ar_nodes = sorted(n for n, p in plans.items() if p.sync == SyncKind.ALL_REDUCE)
    if ar_nodes:
        logging.warning(
            "Async PS runtime: %d AllReduce-labeled variable(s) %s degrade to "
            "asynchronous host serving: per-step collective semantics cannot hold when "
            "workers run ahead. Use sync=True for per-step AllReduce.",
            len(ar_nodes), ar_nodes)
    return plans, min(stale)


def value_and_grad(loss_fn, params, batch, device, has_aux=False, generator=None,
                   lock=None):
    """``(loss, aux, grads)`` of ``loss_fn(params, batch[, generator])`` at
    ``params`` (name -> tensor, on ``device``), the batch's array leaves
    moved there; under ``lock`` (the module swap of
    ``functional_call`` is not thread-safe)."""
    leaves = OrderedDict((n, t.detach().requires_grad_(True)) for n, t in params.items())
    batch = map_batch(lambda x, _: torch.as_tensor(x).to(device, non_blocking=True), batch)
    args = (leaves, batch) + (() if generator is None else (generator,))
    with lock if lock is not None else contextlib.nullcontext():
        out = loss_fn(*args)
        loss, aux = out if has_aux else (out, None)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), aux, OrderedDict(zip(leaves, grads))


def resolve_devices(devices):
    """``torch.device``s of the workers: ``devices`` as given (a device may
    repeat; a CUDA one needs a GPU, as every entry point of the port),
    else every visible CUDA device; none raises."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("No devices for async workers: no CUDA device is visible; pass "
                         "devices=[...] (\"cpu\" to run the workers on the CPU)")
    return devices


class HostServer:
    """The parameter server's state: CPU tensors of the parameters and the
    optimizer over them, the version, the stale-push count, and each
    push's host update time; every method is thread-safe."""

    def __init__(self, params, optimizer):
        self._params = OrderedDict((n, t.detach().to("cpu", copy=True))
                                   for n, t in params.items())
        self._opt = optimizer.create(list(self._params.values()))
        self._version = 0
        self._stale_pushes = 0
        self._lock = threading.Lock()

    def pull(self, device="cpu"):
        """(a copy of the parameters on ``device``, the version)."""
        with self._lock:
            return (OrderedDict((n, t.to(device, copy=True)) for n, t in self._params.items()),
                    self._version)

    def push(self, grads, seen_version):
        """Apply one gradient (host tensors by name, computed at
        ``seen_version``); returns (the new version, the update's seconds).
        A push is stale when another landed since its pull."""
        with self._lock:
            t0 = time.perf_counter()
            with torch.no_grad():
                for n, t in self._params.items():
                    t.grad = grads[n].to(t.dtype)
                self._opt.step()
                for t in self._params.values():
                    t.grad = None
            self._version += 1
            ver = self._version
            if seen_version < ver - 1:
                self._stale_pushes += 1
            return ver, time.perf_counter() - t0

    def params(self):
        with self._lock:
            return OrderedDict((n, t.clone()) for n, t in self._params.items())

    @property
    def version(self):
        with self._lock:
            return self._version

    @property
    def stale_pushes(self):
        """Gradients applied after another push had landed since their pull
        (the evidence of asynchrony)."""
        with self._lock:
            return self._stale_pushes


class AsyncPSSession:
    """Asynchronous bounded-staleness training within one process.

    ``loss_fn(params, batch[, generator]) -> loss`` is single-device code
    over a dict of tensors (``has_aux``: ``(loss, aux)``, aux kept in
    ``aux_history``).  Each worker takes gradients on its device against
    its last pull and pushes them to the host server, which applies them
    at once; ``staleness`` bounds how far a worker may start ahead of the
    slowest.  With ``has_rng`` every (worker, lifetime step) draws from
    its own generator, folded from ``rng`` (default 0), the worker and the
    step counted across ``run`` calls, so that a later ``run`` never
    replays an earlier one's masks.  ``params()`` is a method, as on every
    session of the port (JAX's thread session has a property).
    """

    def __init__(self, loss_fn, params, optimizer, *, staleness=0, devices=None,
                 num_workers=None, has_rng=False, has_aux=False, rng=None):
        self._devices = resolve_devices(devices)
        if num_workers is not None:
            self._devices = self._devices[:num_workers]
        self._loss_fn = loss_fn
        self._server = HostServer(flatten_params(params), optimizer)
        self._has_rng = bool(has_rng)
        self._has_aux = bool(has_aux)
        self._seed = 0 if rng is None else int(rng)
        self._compute_lock = threading.Lock()
        self.staleness = int(staleness)
        self.barrier = TokenBarrier(len(self._devices), staleness)
        self.history = []      # (worker, version, loss)
        self.aux_history = []  # (worker, version, aux)
        # per push: the worker, and the seconds of its step, of its pull,
        # delay and value and gradient, of the copy of its gradients to the
        # host and of the host update
        self.timings = []
        self._rng_step_base = 0

    @property
    def devices(self):
        return list(self._devices)

    # -- server --------------------------------------------------------------

    def pull(self, device="cpu"):
        """(parameters on ``device``, version) for a worker."""
        return self._server.pull(device)

    def push(self, grads, seen_version):
        """Apply one gradient (tensors by name, on any device); returns the
        new server version."""
        grads = OrderedDict((n, g.to("cpu")) for n, g in grads.items())
        return self._server.push(grads, seen_version)[0]

    def params(self):
        """The server's parameters by name, copied."""
        return self._server.params()

    @property
    def version(self):
        return self._server.version

    @property
    def stale_pushes(self):
        return self._server.stale_pushes

    # -- workers -------------------------------------------------------------

    def _generator(self, w, i, device):
        if not self._has_rng:
            return None
        return step_generator(self._seed, self._rng_step_base + i, device, replica=w)

    def _worker_loop(self, w, batches, steps, delay, stop, errors):
        dev = self._devices[w]
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        try:
            with (torch.cuda.device(dev) if stream else contextlib.nullcontext()), \
                    torch.cuda.stream(stream) if stream else contextlib.nullcontext():
                for i in range(steps):
                    if stop.is_set():
                        return
                    self.barrier.wait_turn(w, stop)
                    if stop.is_set():
                        return
                    t0 = time.perf_counter()
                    p, ver = self._server.pull(dev)
                    if delay:
                        # the induced straggler of the c9 rig is slow between
                        # its pull and its push, so that its push is stale
                        time.sleep(delay)
                    loss, aux, grads = value_and_grad(
                        self._loss_fn, p, batches[i % len(batches)], dev, self._has_aux,
                        self._generator(w, i, dev), self._compute_lock)
                    if stream is not None:
                        stream.synchronize()   # the copy below times the copy alone
                    t1 = time.perf_counter()
                    host = OrderedDict((n, g.to("cpu")) for n, g in grads.items())
                    loss = float(loss)
                    t2 = time.perf_counter()
                    new_ver, update_s = self._server.push(host, ver)
                    self.history.append((w, new_ver, loss))
                    if self._has_aux:
                        self.aux_history.append((w, new_ver, map_batch(
                            lambda x, _: x.detach().cpu() if isinstance(x, torch.Tensor)
                            else x, aux)))
                    self.timings.append({"worker": w, "step_s": time.perf_counter() - t0,
                                         "grads_s": t1 - t0, "copy_s": t2 - t1,
                                         "update_s": update_s})
                    self.barrier.advance(w)
        except Exception as e:   # surfaced by run, never swallowed
            errors.append((w, e))
            stop.set()

    def run(self, batches_per_worker, steps, delays=None, timeout=300.0):
        """Run every worker for ``steps`` steps; returns the server's
        parameters.  ``batches_per_worker`` holds one list of batches per
        worker (step i takes batch ``i % len``); ``delays`` are per-worker
        seconds of induced slowness, slept between the pull and the value
        and gradient, as the cross-process worker does (JAX's thread
        session sleeps before the pull; there a push is stale only when
        two computations happen to overlap).  After ``timeout`` seconds the
        workers are told to stop and get one shared grace of
        ``QUIESCE_S`` to quiesce at a step boundary before anything
        raises: a worker's error first, else ``TimeoutError`` when one
        still runs."""
        W = len(self._devices)
        if len(batches_per_worker) != W:
            raise ValueError(f"need {W} batch streams, got {len(batches_per_worker)}")
        delays = delays or [0.0] * W
        stop = threading.Event()
        errors = []
        threads = [threading.Thread(target=self._worker_loop, name=f"async-ps-worker-{w}",
                                    args=(w, batches_per_worker[w], steps, delays[w],
                                          stop, errors), daemon=True)
                   for w in range(W)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(max(0.0, timeout - (time.monotonic() - t0)))
        stop.set()
        grace_end = time.monotonic() + QUIESCE_S
        for t in threads:
            t.join(max(0.0, grace_end - time.monotonic()))
        self._rng_step_base += steps
        if errors:
            raise errors[0][1]
        alive = [t for t in threads if t.is_alive()]
        if alive:
            raise TimeoutError(f"{len(alive)} async workers still running after {timeout}s "
                               f"(stop flag set; they quiesce at the next step boundary)")
        logging.info("AsyncPS run done: version=%d, max_lead=%d, stale_pushes=%d",
                     self.version, self.barrier.max_lead_seen, self.stale_pushes)
        return self.params()


class AsyncPSEngineSession:
    """The async session ``AutoDist.distribute`` returns when the compiled
    strategy holds a ``PSSynchronizer`` with ``sync=False`` (the reference
    makes asynchrony a strategy field, not a side API).  It reads the
    ModelItem and the compiled strategy: the bound is the least staleness
    over the async PS nodes (:func:`resolve_async_plans`), and the plans
    stay inspectable (``.plans``; every variable is host-served here).  The
    workers and the server are an :class:`AsyncPSSession`."""

    def __init__(self, strategy, model_item, *, devices=None, num_workers=None):
        self.strategy = strategy
        self.model_item = model_item
        self.plans, self.staleness = resolve_async_plans(strategy, model_item)
        self._inner = AsyncPSSession(
            model_item.loss_fn, model_item.params, model_item.optimizer,
            staleness=self.staleness, devices=devices, num_workers=num_workers,
            has_rng=model_item.has_rng, has_aux=model_item.has_aux)

    def params(self):
        """The server's parameters by name (a method, as
        ``DistributedSession.params``)."""
        return self._inner.params()

    @property
    def version(self):
        return self._inner.version

    @property
    def stale_pushes(self):
        return self._inner.stale_pushes

    @property
    def barrier(self):
        return self._inner.barrier

    @property
    def history(self):
        return self._inner.history

    @property
    def aux_history(self):
        return self._inner.aux_history

    @property
    def timings(self):
        return self._inner.timings

    @property
    def num_workers(self):
        return len(self._inner.devices)

    def run(self, batches_per_worker, steps, delays=None, timeout=300.0):
        return self._inner.run(batches_per_worker, steps, delays=delays, timeout=timeout)

    def close(self):
        """Nothing to stop: ``run`` joins its workers before it returns."""
