"""The JAX side of the port's parity tests, computed ahead in one process
of its own.

A test module whose JAX results depend on nothing of the port passes
their module-level functions and arguments to :func:`submit` when it is
imported; the first call starts the worker, a Python process running
this file, niced (``NICE``) so that the tests running meanwhile keep the
cores they use.  The worker imports each module by name (with
``WORKER_ENV`` set, so module-level starts such as
``torch_gloo_ranks.prestart`` do nothing there), calls the functions in
the order given and pickles each result to a file of its own.  A test
takes its result with :func:`result`, which waits for the file, or calls
the function here when the worker failed on it, died, was never started
or is more than ``WAIT_S`` late: the test checks the same values either
way.  The worker is killed at the test process's exit.

pytest imports every test module before it runs the first test, so the
worker computes the port's JAX results while the test files before the
port's run.
"""
import atexit
import hashlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

WORKER_ENV = "AUTODIST_TEST_JAX_WORKER"
NICE = 10        # below the test process: it takes what its tests leave idle
WAIT_S = 600     # longest wait for one result before computing it here
TESTS = os.path.dirname(os.path.abspath(__file__))
_STATE = {}


def in_worker():
    """True in the worker process."""
    return os.environ.get(WORKER_ENV) == "1"


def _file(module, name, args):
    digest = hashlib.sha1(repr((module, name, args)).encode()).hexdigest()[:16]
    return f"{module}.{name}.{digest}"


def _kill(proc):
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def _start():
    workdir = tempfile.mkdtemp(prefix="jax-worker-")
    atexit.register(shutil.rmtree, workdir, ignore_errors=True)
    path = os.pathsep.join([TESTS, os.path.dirname(TESTS)] + sys.path[1:])
    env = dict(os.environ, PYTHONPATH=path, **{WORKER_ENV: "1"})
    with open(os.path.join(workdir, "worker.log"), "w") as log:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), workdir],
                                stdin=subprocess.PIPE, stdout=log, stderr=subprocess.STDOUT,
                                env=env)
    atexit.register(_kill, proc)
    _STATE.update(proc=proc, dir=workdir, submitted=set())


def submit(*calls):
    """Queue ``(fn, *args)`` calls for the worker; ``fn`` is a module-level
    function of a test module, ``args`` picklable values with a stable
    ``repr``.  Does nothing in the worker itself."""
    if in_worker():
        return
    if "proc" not in _STATE:
        try:
            _start()
        except OSError:
            _STATE["proc"] = None
    proc = _STATE["proc"]
    if proc is None or proc.poll() is not None:
        return
    jobs = [(fn.__module__, fn.__name__, tuple(args)) for fn, *args in calls]
    try:
        pickle.dump(jobs, proc.stdin)
        proc.stdin.flush()
    except OSError:
        return
    _STATE["submitted"].update(_file(*job) for job in jobs)


def result(fn, *args):
    """``fn(*args)``: the worker's result if it has or will have it, else
    computed here."""
    name = _file(fn.__module__, fn.__name__, tuple(args))
    if name in _STATE.get("submitted", ()):
        path = os.path.join(_STATE["dir"], name)
        deadline = time.monotonic() + WAIT_S
        while True:
            if os.path.exists(path + ".pkl"):
                with open(path + ".pkl", "rb") as f:
                    return pickle.load(f)
            if os.path.exists(path + ".err") or _STATE["proc"].poll() is not None:
                break
            if time.monotonic() > deadline:   # hung: every later result is computed here
                _kill(_STATE["proc"])
                break
            time.sleep(0.02)
    return fn(*args)


def main(workdir):
    import importlib

    os.nice(NICE)
    import conftest  # noqa: F401  the virtual CPU devices, before JAX starts
    import jax

    while True:
        try:
            jobs = pickle.load(sys.stdin.buffer)
        except EOFError:
            return
        for module, name, args in jobs:
            path = os.path.join(workdir, _file(module, name, args))
            try:
                value = getattr(importlib.import_module(module), name)(*args)
                with open(path + ".tmp", "wb") as f:
                    pickle.dump(value, f)
                os.replace(path + ".tmp", path + ".pkl")
            except Exception:
                traceback.print_exc()
                open(path + ".err", "w").close()
        jax.clear_caches()


if __name__ == "__main__":
    main(sys.argv[1])
