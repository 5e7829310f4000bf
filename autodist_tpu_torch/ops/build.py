"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source under ``autodist_tpu_torch/csrc/`` compiles on its own into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes).  Libraries land in ``autodist_tpu_torch/_build/``
under a name that carries the hash of the source and the flags, so an edited
source is rebuilt at its next use and an unchanged one is loaded as it is.
The compiler's output, with ``-Xptxas -v``'s register and spill report, is
kept beside each library as ``<name>.log``.

Nothing here runs at import time: the first kernel call builds.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded = {}
_lock = threading.Lock()


def find_nvcc():
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels build on a machine with the CUDA toolkit")


def library_path(name):
    """Where the library of ``csrc/<name>.cu`` lives for the current source."""
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name, nvcc):
    """Start ``nvcc`` for ``csrc/<name>.cu``; None when already built."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    log = open(os.path.join(BUILD_DIR, name + ".log"), "w")
    proc = subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")],
        stdout=log, stderr=subprocess.STDOUT)
    return proc, log, tmp, out


def _finish(name, job):
    proc, log, tmp, out = job
    rc = proc.wait()
    log.close()
    if rc != 0:
        with open(log.name) as f:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {rc}):\n"
                               f"{f.read()[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build(names):
    """Compile every named source that is not built yet, all ``nvcc``
    processes started together; returns the library paths."""
    pending = [n for n in names if not os.path.exists(library_path(n))]
    if pending:
        nvcc = find_nvcc()
        jobs = {n: _start(n, nvcc) for n in pending}
        errors = []
        for n, job in jobs.items():
            if job is None:
                continue
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return [library_path(n) for n in names]


def load(name):
    """The ``ctypes`` library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            (path,) = build([name])
            lib = _loaded[name] = ctypes.CDLL(path)
        return lib
