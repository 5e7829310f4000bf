"""Cluster and process management (counterpart of ``autodist_tpu/cluster.py``).

The JAX package runs one process per host; the port runs one process per
GPU (:func:`~autodist_tpu_torch.parallel.mesh.replica_world`), ranked by
:func:`rank_devices`: the chief's node first, then the other nodes in spec
order, each node's devices in spec order.  So:

1. :class:`Cluster` maps a ResourceSpec to the ``torch.distributed``
   process group: ``num_processes`` is the spec's device count, the
   rendezvous the chief's coordinator address (``MASTER_ADDR`` the chief,
   ``MASTER_PORT`` the coordinator port), and :meth:`Cluster.initialize`
   joins the group where JAX calls ``jax.distributed.initialize``.
2. :meth:`Cluster.launch_workers` starts one process for every device but
   the chief's first: re-executing the user's script with the JAX
   package's ``AUTODIST_*`` env contract beside ``RANK``, ``LOCAL_RANK``
   (the device's index), ``WORLD_SIZE``, ``MASTER_ADDR`` and
   ``MASTER_PORT``.  A process on the chief's own address starts locally;
   one on another node through ``ssh``.  Each launch is retried with
   exponential backoff, and a monitor thread watches each process: an exit
   the ``on_worker_exit`` callback does not claim kills the chief (the
   reference's fail-fast).
3. :class:`Coordinator` is the chief-side launcher: serialise the
   strategy, launch the workers, join the group.

Membership epochs (:meth:`Cluster.advance_epoch`, inherited through
``AUTODIST_EPOCH``) and the deterministic chief-failover successor
(:meth:`Cluster.successor_chief`) serve the elastic trainer.  The live
telemetry collector (``start_collector``, ``cluster_view``,
``stream_address``, ``merge_telemetry``) is ROADMAP Queue A item 10: with
telemetry off, as here, they return None, as JAX's do.
"""
import os
import shlex
import subprocess
import sys
import threading
import time

from autodist_tpu_torch.const import DEFAULT_ASYNC_PS_PORT, DEFAULT_COORDINATOR_PORT, ENV
from autodist_tpu_torch.resource_spec import DeviceType
from autodist_tpu_torch.utils import logging


class WorkerLaunchError(RuntimeError):
    """A worker could not be launched within the retry budget."""


def rank_order(spec):
    """The spec's node addresses, the chief's first."""
    return [spec.chief] + [n for n in spec.node_addresses if n != spec.chief]


def rank_devices(spec):
    """``(address, DeviceSpec)`` of every process, in rank order: one a
    device, the chief's node first, then the other nodes in spec order."""
    return [(addr, d) for addr in rank_order(spec) for d in spec.node_devices(addr)]


class Cluster:
    """``torch.distributed`` process-group bookkeeping for a ResourceSpec.

    Elasticity: :attr:`epoch` counts membership changes
    (:meth:`advance_epoch`; inherited from ``AUTODIST_EPOCH``);
    :attr:`on_worker_exit`, a callable ``(addr, exit_code) -> bool`` run on
    the monitor thread, claims a worker's failure instead of the fail-fast
    ``os._exit(1)``; :meth:`launch_workers` retries each launch;
    :meth:`successor_chief` names the next chief without an election.
    """

    def __init__(self, resource_spec, coordinator_port=DEFAULT_COORDINATOR_PORT):
        self._spec = resource_spec
        self._port = coordinator_port
        self._procs = []
        self._monitor_threads = []
        self._terminating = False
        self._epoch = ENV.AUTODIST_EPOCH.val
        self.on_worker_exit = None

    # -- identity ----------------------------------------------------------

    @property
    def coordinator_address(self):
        addr = ENV.AUTODIST_COORDINATOR.val
        return addr or f"{self._spec.chief}:{self._port}"

    @property
    def num_processes(self):
        """One process a device of the spec."""
        return len(rank_devices(self._spec))

    @property
    def process_id(self):
        """This process's rank: 0 for the chief (no ``AUTODIST_WORKER``);
        a launched worker's ``RANK``, else its node's first rank."""
        worker = ENV.AUTODIST_WORKER.val
        if not worker:
            return 0
        order = self._rank_order()
        if worker not in order:
            raise ValueError(f"AUTODIST_WORKER={worker!r} not in resource spec nodes")
        if os.environ.get("RANK"):
            return ENV.RANK.val
        return [a for a, _ in rank_devices(self._spec)].index(worker)

    def _rank_order(self):
        return rank_order(self._spec)

    @property
    def is_chief(self):
        return self.process_id == 0

    # -- membership epochs --------------------------------------------------

    @property
    def epoch(self):
        """The membership epoch (0 for a fresh, full-topology run)."""
        return self._epoch

    def advance_epoch(self):
        """Enter the next membership epoch (on any topology change)."""
        self._epoch += 1
        logging.info("Cluster membership epoch -> %d", self._epoch)
        return self._epoch

    def successor_chief(self, down=()):
        """The first address in rank order not in ``down``: every surviving
        process computes the same chief from the same spec."""
        down = set(down)
        for addr in self._rank_order():
            if addr not in down:
                return addr
        raise RuntimeError(f"No surviving node: all of {self._rank_order()} are down")

    # -- live control plane: telemetry, ROADMAP Queue A item 10 -------------

    @property
    def cluster_view(self):
        """The live cluster view: None with telemetry off (item 10)."""
        return None

    @property
    def stream_address(self):
        """The telemetry collector's address: None with telemetry off."""
        return None

    def start_collector(self, port=0, view=None):
        """The live telemetry collector is item 10: None, as JAX's
        off-chief or with telemetry off."""
        return None

    def stop_collector(self):
        """Nothing to stop: no collector runs (item 10)."""

    def merge_telemetry(self, run_dir=None):
        """The manifest merge is item 10: None, as JAX's without a run
        directory."""
        return None

    def initialize(self, device=None):
        """Join the ``torch.distributed`` process group (a no-op for one
        process, or when the group exists): rank :attr:`process_id` of
        :attr:`num_processes`, rendezvous at the coordinator address; NCCL
        for a CUDA ``device`` (default ``cuda:LOCAL_RANK`` where CUDA is
        available), gloo for the CPU."""
        import torch
        import torch.distributed as dist

        if self.num_processes <= 1 or dist.is_initialized():
            return
        if device is None:
            device = f"cuda:{ENV.LOCAL_RANK.val}" if torch.cuda.is_available() else "cpu"
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        host, _, port = self.coordinator_address.rpartition(":")
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"tcp://{host}:{port}", rank=self.process_id,
                                world_size=self.num_processes)
        logging.info("torch.distributed initialized: rank %d/%d via %s", self.process_id,
                     self.num_processes, self.coordinator_address)

    # -- launch -----------------------------------------------------------

    def worker_env(self, worker_address, strategy_id, extra_env=None, rank=None):
        """The env contract the chief hands the process of rank ``rank``
        (default: the node's first) on ``worker_address``: the JAX
        package's ``AUTODIST_*`` keys (the process id and count are ranks
        and processes, one a device) and the ``torch.distributed`` keys.
        ``extra_env`` carries values scoped to this launch (the async PS's
        bound address and authkey), so the chief never edits its own
        ``os.environ`` to publish them."""
        devices = rank_devices(self._spec)
        if rank is None:
            rank = [a for a, _ in devices].index(worker_address)
        addr, device = devices[rank]
        if addr != worker_address:
            raise ValueError(f"rank {rank} runs on {addr}, not {worker_address}")
        extra_env = dict(extra_env or {})
        master, _, port = self.coordinator_address.rpartition(":")
        local = (device.device_index if device.device_type != DeviceType.CPU
                 else self._spec.node_devices(addr).index(device))
        env = {
            "AUTODIST_WORKER": worker_address,
            "AUTODIST_STRATEGY_ID": strategy_id or "",
            "AUTODIST_PROCESS_ID": str(rank),
            "AUTODIST_NUM_PROCESSES": str(len(devices)),
            "AUTODIST_COORDINATOR": self.coordinator_address,
            "AUTODIST_MIN_LOG_LEVEL": ENV.AUTODIST_MIN_LOG_LEVEL.val,
            # a worker relaunched after a topology change knows its epoch
            "AUTODIST_EPOCH": str(self._epoch),
            # the launch's own value first, then the chief's env override
            "AUTODIST_ASYNC_PS_ADDR": extra_env.pop("AUTODIST_ASYNC_PS_ADDR", "")
            or ENV.AUTODIST_ASYNC_PS_ADDR.val
            or f"{self._spec.chief}:{DEFAULT_ASYNC_PS_PORT}",
            "RANK": str(rank),
            "LOCAL_RANK": str(local),
            "WORLD_SIZE": str(len(devices)),
            "MASTER_ADDR": master,
            "MASTER_PORT": port,
        }
        env.update(extra_env)
        ssh = self._spec.ssh_config(worker_address)
        if ssh is not None:
            env.update(ssh.env)
        return env

    @staticmethod
    def local_command(argv, env):
        """The command line re-executing ``argv`` on this host with ``env``
        added to the inherited environment."""
        return (["env"] + [f"{k}={v}" for k, v in sorted(env.items())]
                + [sys.executable, "-u"] + list(argv))

    def remote_command(self, worker_address, argv, env, connect_timeout_s=10):
        """The ssh command line re-executing ``argv`` on the worker (the
        openssh client).  ``connect_timeout_s`` bounds each attempt, so a
        black-holed address fails in seconds and enters
        :meth:`launch_workers`'s retry loop."""
        ssh = self._spec.ssh_config(worker_address)
        envs = " ".join(f"{k}={shlex.quote(v)}" for k, v in sorted(env.items()))
        py = sys.executable
        if ssh is not None and ssh.python_venv:
            py = f"{ssh.python_venv}/bin/python"
        remote = f"{envs} {py} -u " + " ".join(shlex.quote(a) for a in argv)
        # trust on first use: a changed host key is still refused
        cmd = ["ssh", "-o", "StrictHostKeyChecking=accept-new",
               "-o", f"ConnectTimeout={int(connect_timeout_s)}", "-tt"]
        if ssh is not None:
            if ssh.key_file:
                cmd += ["-i", ssh.key_file]
            if ssh.port:
                cmd += ["-p", str(ssh.port)]
            target = f"{ssh.username}@{worker_address}" if ssh.username else worker_address
        else:
            target = worker_address
        cmd += [target, f"bash -c {shlex.quote(remote)}"]
        return cmd

    def launch_workers(self, strategy_id, argv=None, extra_env=None, max_attempts=3,
                       backoff_s=1.0, probe_s=2.0):
        """Chief only: re-execute the user's script for every rank but 0,
        locally on the chief's address and through ssh elsewhere.

        Each launch gets ``max_attempts`` tries: an attempt whose process
        exits non-zero within the ``probe_s`` startup window is retried
        after a pause of ``backoff_s``, doubled each time; exhausting the
        budget raises :class:`WorkerLaunchError` naming the address and the
        attempt count."""
        if not self.is_chief:
            return
        argv = argv or [os.path.abspath(sys.argv[0])] + sys.argv[1:]
        for rank, (addr, _) in enumerate(rank_devices(self._spec)):
            if rank == 0:
                continue

            def cmd_fn(a=addr, r=rank):
                # rebuilt each attempt: the contract carries the epoch
                env = self.worker_env(a, strategy_id, extra_env=extra_env, rank=r)
                if a == self._spec.chief:
                    return self.local_command(argv, env)
                return self.remote_command(a, argv, env)

            proc = self._launch_with_retry(addr, cmd_fn, max_attempts, backoff_s, probe_s)
            self._procs.append((addr, proc))
            t = threading.Thread(target=self._monitor, args=(addr, proc), daemon=True)
            t.start()
            self._monitor_threads.append(t)

    def _launch_with_retry(self, addr, cmd_fn, max_attempts, backoff_s, probe_s):
        delay = backoff_s
        code = None
        for attempt in range(1, max_attempts + 1):
            logging.info("Launching worker on %s (attempt %d/%d)", addr, attempt, max_attempts)
            proc = subprocess.Popen(cmd_fn(), start_new_session=True)
            deadline = time.monotonic() + probe_s
            while time.monotonic() < deadline and proc.poll() is None:
                time.sleep(min(0.05, probe_s / 4 or 0.01))
            code = proc.poll()
            if code is None or code == 0:
                return proc   # alive past the probe window, or a clean exit
            logging.warning("Worker launch on %s died with exit %d within %.1fs "
                            "(attempt %d/%d)%s", addr, code, probe_s, attempt, max_attempts,
                            f"; retrying in {delay:.1f}s" if attempt < max_attempts else "")
            if attempt < max_attempts:
                time.sleep(delay)
                delay *= 2
        raise WorkerLaunchError(
            f"Could not launch worker on {addr}: {max_attempts} attempt(s) exited nonzero "
            f"within the {probe_s:.1f}s startup window (last exit code {code}); check ssh "
            f"reachability and the worker's environment")

    def _monitor(self, addr, proc, poll_s=0.5):
        """Fail fast: a worker's non-zero exit kills the chief, unless
        :attr:`on_worker_exit` claims it or :meth:`terminate` stopped it."""
        while proc.poll() is None:
            time.sleep(poll_s)
        code = proc.returncode
        if code != 0 and not self._terminating:
            if self.on_worker_exit is not None:
                try:
                    if self.on_worker_exit(addr, code):
                        logging.warning("Worker %s exited with %d; membership handler "
                                        "claimed the failure (epoch %d)", addr, code,
                                        self._epoch)
                        return
                except Exception:
                    logging.exception("on_worker_exit(%s, %d) raised; falling back to "
                                      "fail-fast", addr, code)
            logging.error("Worker %s exited with %d; terminating chief", addr, code)
            os._exit(1)

    def terminate(self, grace_s=5.0):
        """Stop every launched worker: TERM first, KILL after ``grace_s``;
        every process is reaped and every monitor thread joined."""
        self._terminating = True
        procs, self._procs = self._procs, []
        for _, proc in procs:
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + grace_s
        for addr, proc in procs:
            while proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if proc.poll() is None:
                logging.warning("Worker %s ignored SIGTERM for %.1fs; escalating to SIGKILL",
                                addr, grace_s)
                proc.kill()
            proc.wait()   # reaped: no zombies
        threads, self._monitor_threads = self._monitor_threads, []
        for t in threads:
            t.join(timeout=max(grace_s, 2.0))
        self.stop_collector()


class Coordinator:
    """Chief-side orchestration: launch the workers, join the process
    group."""

    def __init__(self, resource_spec, coordinator_port=DEFAULT_COORDINATOR_PORT):
        self.cluster = Cluster(resource_spec, coordinator_port)

    def setup(self, strategy, device=None, extra_env=None):
        if self.cluster.num_processes > 1 and self.cluster.is_chief:
            self.cluster.launch_workers(strategy.id, extra_env=extra_env)
        self.cluster.initialize(device)
        return self.cluster
