"""Cross-process asynchronous parameter serving (counterpart of
``autodist_tpu/kernel/synchronization/async_service.py``).

:mod:`~autodist_tpu_torch.kernel.synchronization.async_ps` bounds the
staleness of the workers of one process.  This module is the
cross-process half: the host parameter server and the token barrier
served over TCP, the reference's gRPC PS transport and its size-``s``
token queues held across real processes.

The chief process owns the authoritative parameters and optimizer state
and serves them from threads of its own (no fork: CUDA would not survive
one, and the state stays in the chief).  Every worker process, the
chief's own usually among them, connects and loops pull -> value and
gradient on its own device -> push.  The barrier is polled
(``may_start``), never held on the server, so a wedged worker pins no
server thread.  Only numpy pytrees cross the wire, pickled.

The transport is ``multiprocessing.connection`` (the authenticated
pickle channel ``BaseManager`` is built on, which the JAX package uses):
one thread accepts, one thread serves each connection, and
:meth:`ServiceServer.close` stops them all, which ``BaseManager``'s
``serve_forever`` cannot.

.. warning:: **Trusted networks only.**  The transport is pickle: any peer
   that reaches the port with the authkey can execute arbitrary code in
   the serving process.  The default bind address is loopback; bind a
   routable address only inside a private, trusted cluster network (the
   trust model of the reference's gRPC PS, which also ran
   unauthenticated inside the job's network).  A chief that launches its
   workers authenticates them with a random 256-bit token
   (``secrets.token_bytes``) passed as ``AUTODIST_ASYNC_PS_AUTHKEY``.
   Deployments that cannot pass the token fall back to an authkey derived
   from the run's strategy id (:func:`_run_authkey`): run isolation only
   (two concurrent runs cannot cross-connect by accident), not an
   authentication boundary, because the strategy id is predictable.
"""
import hashlib
import threading
import time
from collections import OrderedDict
from multiprocessing import AuthenticationError
from multiprocessing.connection import Client, Listener

import numpy as np
import torch

from autodist_tpu_torch.kernel.device.resolver import resolve_device
from autodist_tpu_torch.kernel.synchronization.async_ps import (HostServer, TokenBarrier,
                                                                resolve_async_plans,
                                                                value_and_grad)
from autodist_tpu_torch.model_item import flatten_params
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.rng import step_generator

_EXPOSED = ("pull", "push", "may_start", "advance", "stats")
DEFAULT_AUTHKEY = b"autodist-async-ps"
POLL_S = 0.05        # how often a serving thread looks at its stop flag
CLOSE_WAIT_S = 5.0   # the shared wait for the serving threads to end
# how long a cluster worker retries its connection to a chief that has not
# bound yet (an externally scheduled worker may start well before it)
CONNECT_WINDOW_S = 120.0
CONNECT_RETRY_S = 0.5


class AsyncPSService:
    """The server half of an async PS, shared across processes: the
    push/pull and bounded-lead contract of
    :class:`~autodist_tpu_torch.kernel.synchronization.async_ps.AsyncPSSession`
    without its worker threads (the workers live in their own processes
    and drive their own devices).  Every method takes and returns numpy
    arrays and Python values."""

    def __init__(self, params, optimizer, *, staleness=0, num_workers=1):
        self._server = HostServer(flatten_params(params), optimizer)
        self.barrier = TokenBarrier(num_workers, staleness)
        self.staleness = int(staleness)

    def pull(self):
        params, version = self._server.pull()
        return OrderedDict((n, t.numpy()) for n, t in params.items()), version

    def push(self, grads, seen_version):
        return self._server.push(OrderedDict((n, torch.from_numpy(np.asarray(g)))
                                             for n, g in grads.items()), seen_version)[0]

    def may_start(self, worker):
        """Non-blocking barrier probe: True when ``worker`` is within the
        staleness bound (clients poll; no server thread is held)."""
        return self.barrier.probe(worker)

    def advance(self, worker):
        self.barrier.advance(worker)

    def stats(self):
        return {"version": self._server.version,
                "stale_pushes": self._server.stale_pushes,
                "max_lead_seen": self.barrier.max_lead_seen,
                "steps": self.barrier.steps}


class ServiceServer:
    """``service`` served at ``address`` from daemon threads of this process
    until :meth:`close`: requests are ``(method, args)`` of ``_EXPOSED``,
    answered with ``("ok", value)`` or ``("error", exception)``."""

    def __init__(self, service, address, authkey):
        self._service = service
        self._authkey = authkey
        self._listener = Listener(address, authkey=authkey)
        self.address = self._listener.address
        self._stop = threading.Event()
        self._threads = []
        self._accepter = threading.Thread(target=self._accept, name="async-ps-accept",
                                          daemon=True)
        self._accepter.start()

    def _accept(self):
        while not self._stop.is_set():
            try:
                conn = self._listener.accept()
            except (OSError, EOFError, AuthenticationError):
                continue   # a failed handshake; a closed listener ends with the flag
            if self._stop.is_set():
                conn.close()
                return
            t = threading.Thread(target=self._serve, args=(conn,), name="async-ps-serve",
                                 daemon=True)
            self._threads.append(t)
            t.start()

    def _serve(self, conn):
        try:
            while not self._stop.is_set():
                if not conn.poll(POLL_S):
                    continue
                name, args = conn.recv()
                try:
                    if name not in _EXPOSED:
                        raise AttributeError(f"async PS service has no method {name!r}")
                    reply = ("ok", getattr(self._service, name)(*args))
                except Exception as e:   # the caller re-raises it
                    reply = ("error", e)
                conn.send(reply)
        except (EOFError, OSError):
            pass   # the client went away
        finally:
            conn.close()

    def close(self):
        """Stop accepting, end every serving thread and close the socket;
        waits up to ``CLOSE_WAIT_S`` for the threads in all."""
        if self._stop.is_set():
            return
        self._stop.set()
        host, port = self.address
        try:   # wake the blocking accept with one last connection
            Client((host if host not in ("", "0.0.0.0") else "127.0.0.1", port),
                   authkey=self._authkey).close()
        except (OSError, EOFError, AuthenticationError):
            pass
        deadline = time.monotonic() + CLOSE_WAIT_S
        for t in [self._accepter] + self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
        self._listener.close()


class ServiceClient:
    """A connection to an :class:`AsyncPSService` served elsewhere, with
    its methods; thread-safe, one request at a time."""

    def __init__(self, conn):
        self._conn = conn
        self._lock = threading.Lock()

    def _call(self, name, *args):
        with self._lock:
            self._conn.send((name, args))
            kind, value = self._conn.recv()
        if kind == "error":
            raise value
        return value

    def pull(self):
        return self._call("pull")

    def push(self, grads, seen_version):
        return self._call("push", grads, seen_version)

    def may_start(self, worker):
        return self._call("may_start", worker)

    def advance(self, worker):
        return self._call("advance", worker)

    def stats(self):
        return self._call("stats")

    def close(self):
        self._conn.close()


def serve_async_ps(service, address, authkey=DEFAULT_AUTHKEY):
    """Serve ``service`` at ``address`` (``(host, port)``; port 0 takes an
    ephemeral one) from daemon threads of this process, whose state stays
    the authoritative one.  Returns ``(server, bound_address)``; the
    server's :meth:`~ServiceServer.close` stops it (the JAX package
    returns the serving thread, which never stops)."""
    server = ServiceServer(service, address, authkey)
    logging.info("Async PS service at %s (staleness=%d)", server.address, service.staleness)
    return server, server.address


def connect_async_ps(address, authkey=DEFAULT_AUTHKEY, retries=40, retry_s=0.25):
    """A :class:`ServiceClient` of the service at ``address``, retrying while
    the chief is not yet listening."""
    for attempt in range(retries):
        try:
            return ServiceClient(Client(tuple(address), authkey=authkey))
        except (ConnectionError, OSError):
            if attempt == retries - 1:
                raise
            time.sleep(retry_s)


def _run_authkey(run_id):
    """The fallback authkey, derived from the shared raw strategy id (every
    process holds it through the chief -> worker strategy hand-off): run
    isolation, not an authentication boundary (the id is predictable; see
    the module's warning).  The JAX package's bytes for the same id."""
    return hashlib.sha256(b"autodist-async-ps:" + run_id.encode()).digest()


def resolve_authkey(run_id, token=None):
    """The session's transport authkey, the strongest source first: the
    chief-minted random token ``token`` (bytes, or hex); the same token in
    ``AUTODIST_ASYNC_PS_AUTHKEY`` (hex); else the key derived from
    ``run_id`` (:func:`_run_authkey`)."""
    from autodist_tpu_torch.const import ENV

    if token:
        return token if isinstance(token, bytes) else bytes.fromhex(token)
    env_tok = ENV.AUTODIST_ASYNC_PS_AUTHKEY.val
    if env_tok:
        return bytes.fromhex(env_tok)
    return _run_authkey(run_id)


def run_async_worker(svc, loss_fn, worker_id, batches, steps, *, delay=0.0, device=None,
                     poll_s=0.01, timeout=120.0, has_aux=False, rng_for_step=None,
                     on_result=None):
    """Drive one worker against a service, local or remote: pull, value and
    gradient on ``device`` (default: ``cuda``), push, with the polled token
    barrier bounding the lead.  ``timeout`` bounds each barrier wait, so a
    slow run that progresses never dies.  ``rng_for_step(i)`` gives step
    i's generator (``has_rng``); ``on_result(i, version, loss, aux)`` sees
    each step.  Returns the (version, loss) this worker contributed."""
    dev = resolve_device(device)
    out = []
    for i in range(steps):
        deadline = time.monotonic() + timeout
        while not svc.may_start(worker_id):
            if time.monotonic() > deadline:
                raise TimeoutError(f"worker {worker_id} barred for {timeout}s at step {i} "
                                   f"with no barrier progress")
            time.sleep(poll_s)
        params, ver = svc.pull()
        if delay:
            # an induced straggler is slow between pull and push, which is
            # what makes its push stale
            time.sleep(delay)
        params = OrderedDict((n, torch.from_numpy(np.asarray(a)).to(dev))
                             for n, a in params.items())
        loss, aux, grads = value_and_grad(
            loss_fn, params, batches[i % len(batches)], dev, has_aux,
            None if rng_for_step is None else rng_for_step(i))
        new_ver = svc.push(OrderedDict((n, g.cpu().numpy()) for n, g in grads.items()), ver)
        out.append((new_ver, float(loss)))
        if on_result is not None:
            on_result(i, new_ver, float(loss), aux)
        svc.advance(worker_id)
    return out


class AsyncPSClusterSession:
    """The cross-process async session, which ``AutoDist.distribute``
    returns when an async strategy (``PS(sync=False, staleness=s)``) meets
    a deployment of several processes: process 0, the chief, owns the
    :class:`AsyncPSService` and serves it over TCP; every process, the
    chief too, drives one worker on its own device.

    The address comes from ``address``, else ``AUTODIST_ASYNC_PS_ADDR``
    (``host:port``), else ``chief_host:DEFAULT_ASYNC_PS_PORT``.  With a
    ``world`` of several ranks (the processes' ``ReplicaWorld``) the chief
    hands its bound address to the others through it, so it may bind port
    0.  The authkey resolves by :func:`resolve_authkey`.  :meth:`close`
    stops the chief's server (or closes a worker's connection)."""

    def __init__(self, strategy, model_item, *, run_id, num_workers=None, worker_id=None,
                 address=None, chief_host=None, authkey=None, device=None, world=None):
        from autodist_tpu_torch.const import DEFAULT_ASYNC_PS_PORT, ENV
        from autodist_tpu_torch.parallel.mesh import broadcast_text

        self.strategy = strategy
        self.model_item = model_item
        self.run_id = run_id   # the raw strategy id every process shares
        self.plans, self.staleness = resolve_async_plans(strategy, model_item)
        self.num_workers = int(num_workers if num_workers is not None
                               else max(1, ENV.AUTODIST_NUM_PROCESSES.val))
        self.worker_id = int(worker_id if worker_id is not None
                             else ENV.AUTODIST_PROCESS_ID.val)
        self.is_chief = self.worker_id == 0
        self.device = resolve_device(device)
        self._step_base = 0
        self._steps_done = 0
        self._server = None
        self.history = []       # (worker, version, loss)
        self.aux_history = []

        authkey = resolve_authkey(run_id, authkey)
        if address is None:
            address = ENV.AUTODIST_ASYNC_PS_ADDR.val or (
                f"{chief_host or '127.0.0.1'}:{DEFAULT_ASYNC_PS_PORT}")
        host, _, port = address.rpartition(":")
        host = host or "127.0.0.1"
        if self.is_chief:
            self._service = AsyncPSService(model_item.params, model_item.optimizer,
                                           staleness=self.staleness,
                                           num_workers=self.num_workers)
            self._server, bound = serve_async_ps(self._service, (host, int(port)),
                                                 authkey=authkey)
            # the bound port (port 0 asks for any); the host as asked, never
            # a locally resolved alias the workers could not reach
            self.address = f"{host}:{bound[1]}"
            self._svc = self._service   # in-process: no TCP hop
        if world is not None and world.group is not None:
            self.address = broadcast_text(self.address if self.is_chief else None, world)
        if not self.is_chief:
            self._service = None
            if world is None or world.group is None:
                self.address = address
            whost, _, wport = self.address.rpartition(":")
            # a worker started before the chief has bound waits for it
            self._svc = connect_async_ps(
                (whost, int(wport)), authkey=authkey,
                retries=max(1, int(CONNECT_WINDOW_S / CONNECT_RETRY_S)),
                retry_s=CONNECT_RETRY_S)
        logging.info("AsyncPSClusterSession rank %d/%d (%s) at %s, staleness=%d",
                     self.worker_id, self.num_workers, "chief" if self.is_chief else "worker",
                     self.address, self.staleness)

    def params(self):
        """The server's parameters by name, as host tensors."""
        return OrderedDict((n, torch.from_numpy(np.array(a)))
                           for n, a in self._svc.pull()[0].items())

    def stats(self):
        return self._svc.stats()

    @property
    def version(self):
        return self.stats()["version"]

    @property
    def stale_pushes(self):
        return self.stats()["stale_pushes"]

    def run(self, batches, steps, *, delay=0.0, poll_s=0.01, timeout=120.0, rng=None,
            wait_all=None):
        """Drive this process's worker for ``steps`` steps; returns the
        server's parameters.  Each process contributes one worker, and all
        call ``run`` with the same ``steps``.  ``timeout`` bounds each
        barrier wait, not the run.  ``wait_all`` (default: on the chief)
        then waits until every worker has pushed its steps, so that the
        parameters hold every contribution.  With ``has_rng`` each (worker,
        lifetime step) draws its own generator, folded from ``rng``
        (default 0), so that a later ``run`` never replays earlier
        masks."""
        seed, base = 0 if rng is None else int(rng), self._step_base

        def rng_for_step(i):
            return step_generator(seed, base + i, self.device, replica=self.worker_id)

        def record(i, version, loss, aux):
            self.history.append((self.worker_id, version, loss))
            if self.model_item.has_aux:
                self.aux_history.append((self.worker_id, version, aux))

        run_async_worker(self._svc, self.model_item.loss_fn, self.worker_id, batches, steps,
                         delay=delay, device=self.device, poll_s=poll_s, timeout=timeout,
                         has_aux=self.model_item.has_aux,
                         rng_for_step=rng_for_step if self.model_item.has_rng else None,
                         on_result=record)
        self._step_base += steps
        self._steps_done += steps
        if self.is_chief if wait_all is None else wait_all:
            self.wait_all(self._steps_done, timeout=timeout)
        return self.params()

    def wait_all(self, target_steps, timeout=120.0):
        """Wait until every worker's step count reaches ``target_steps``.
        ``timeout`` bounds the time without progress: it restarts whenever
        the slowest worker advances."""
        deadline = time.monotonic() + timeout
        last_min = min(self.stats()["steps"])
        while last_min < target_steps:
            now_min = min(self.stats()["steps"])
            if now_min > last_min:
                last_min = now_min
                deadline = time.monotonic() + timeout
                continue
            if time.monotonic() > deadline:
                raise TimeoutError(f"workers stuck below step {target_steps} for {timeout}s "
                                   f"with no progress: {self.stats()}")
            time.sleep(0.05)

    def close(self):
        """Stop the chief's server, or close a worker's connection."""
        if self._server is not None:
            self._server.close()
        elif isinstance(self._svc, ServiceClient):
            self._svc.close()
