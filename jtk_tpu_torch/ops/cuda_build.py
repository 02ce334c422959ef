"""Build and load the hand-written CUDA kernels in ``jtk_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ctypes.  Libraries
build at first use into the package's git-ignored ``_build/cuda``
directory, keyed by a hash of the sources, so a changed source rebuilds.
:func:`build` starts one ``nvcc`` per source, all at once.

Every launch goes on the device of its tensor arguments, which must all lie
on one CUDA device, and on PyTorch's current stream of that device (a
sharded path launches on each device of its set in turn); each C entry
point returns ``cudaGetLastError()``, or a negative code of its own checks
(such as a launch geometry it was not built for), and :func:`launch`
raises when it is not 0.
"""

from __future__ import annotations

import collections
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from .. import trace

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "_build", "cuda")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# ptxas register/shared-memory report of each build (for the chip log)
BUILD_LOG: dict[str, str] = {}
# the entry of the device set whose shard is running (``parallel.on_entry``
# sets it around each shard's work; 0, the primary, elsewhere)
ENTRY: contextvars.ContextVar = contextvars.ContextVar("entry", default=0)


class Launches:
    """Launch counter of one kernel wrapper: :meth:`add` is called where the
    wrapper launches its kernel, and nowhere else.  ``count`` is the number
    of launches, ``shapes`` counts them by launch shape and ``entries`` by
    the entry of the device set (:data:`ENTRY`) they ran for.  It counts
    whether tracing is on or off; :func:`trace.snapshot` lists ``count``
    as ``launches.<name>``.  While tracing is on each launch also counts
    in ``parallel.launches.<entry>``, summed over every kernel."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.shapes: collections.Counter = collections.Counter()
        self.entries: collections.Counter = collections.Counter()
        trace.register(lambda: {f"launches.{self.name}": self.count},
                       self.reset)

    def add(self, shape: tuple) -> None:
        entry = ENTRY.get()
        self.count += 1
        self.shapes[shape] += 1
        self.entries[entry] += 1
        if trace.active():
            trace.count(f"parallel.launches.{entry}")

    def reset(self) -> None:
        self.count = 0
        self.shapes.clear()
        self.entries.clear()


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources_digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return h.hexdigest()[:16]


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_sources_digest(name)}.so")


def build(names) -> None:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process per source, all started together; raise on any failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate(timeout=900)
        BUILD_LOG[name] = log
        if p.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(lib_path(name))
            _LIBS[name] = lib
        return lib


def _arg(x):
    if isinstance(x, torch.Tensor):
        return ctypes.c_void_p(x.data_ptr())
    return ctypes.c_int(int(x))


def launch(name: str, fn: str, *args) -> None:
    """Call C entry point ``fn`` of library ``name`` with tensors (passed
    as device pointers) and ints, on the tensors' device and its current
    stream; raise where the tensors lie on more than one device or not on
    a CUDA device, and on a CUDA error code."""
    devs = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{fn}: a launch takes tensors of one CUDA device, "
                         f"got {sorted(str(d) for d in devs)}")
    dev = devs.pop()
    f = getattr(library(name), fn)
    cargs = [_arg(a) for a in args]
    with torch.cuda.device(dev):
        cargs.append(ctypes.c_void_p(torch.cuda.current_stream(dev)
                                     .cuda_stream))
        f.argtypes = [type(a) for a in cargs]
        f.restype = ctypes.c_int
        err = f(*cargs)
    if err != 0:
        what = "CUDA error" if err > 0 else "entry point error"
        raise RuntimeError(f"{fn} failed with {what} {err}")


def check(t: torch.Tensor, dtype, shape, name: str, device=None) -> None:
    """Validate one kernel argument: CUDA device (``device``, the launch's,
    where given), dtype, shape, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device} (the "
                         f"launch's device), got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
