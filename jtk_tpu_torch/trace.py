"""Spans and counters inside the port: one registry, off by default.

    from jtk_tpu_torch import trace

    with trace.span("polish.prep"):
        ...

    @trace.span("mapper.vote")
    def candidates_batch(...):
        ...

    trace.count("encode.reads", len(reads))

Tracing is on while :func:`enable` holds it on (the CLI's ``--trace
FILE``) and while a ``torch.profiler`` records.  Off, a span or a count
costs a flag check: no clock read, no ``record_function``, no
synchronize, no allocation.

On, a span is a range of the profiler's host timeline, so under the
profiler it lies on the clock of the kernels and copies, and it adds its
host seconds (``time.perf_counter``) and one call to the registry.  The
range is an op-scope ``RecordFunction``: a ``record_function`` range
also leaves an annotation on the device's timeline, which a reader of
the device's busy time would have to know by name to tell from work.  A
span inside a span of the same name counts once.  A span made with
``device=True`` ends in a synchronize, so that it holds the device work
it started: inside a shard's work (:func:`jtk_tpu_torch.parallel.on_entry`,
which sets :data:`SHARD`) of that shard's device alone, elsewhere of every
CUDA device of :func:`jtk_tpu_torch.runtime.devices`; so the shards of a
device set still overlap while traced.  Host spans do not synchronize,
so a traced run keeps what overlap of host and device it can.
:func:`count` adds to a named counter, and only while tracing is on, so
that a unit counter covers exactly the work its spans cover (the launches
by entry, ``parallel.launches.<i>``, too).

The kernel wrappers' launch counters (``ops.cuda_build.Launches``) and
the modification table's ``SLICE_CALLS`` count always, on or off; they
:func:`register` here, so :func:`snapshot` lists them beside the spans
and counters.  Tracing never changes a result, a random stream or a
launch.

Names are dotted, ``<layer>.<part>``; README.md lists every span.
"""

from __future__ import annotations

import collections
import contextvars
import functools
import time

import torch
import torch.autograd.profiler as _profiler

# a profiler range on the host's timeline alone (``record_function``
# where PyTorch has no op-scope range)
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None) \
    or torch.profiler.record_function
_ENABLED = False
# name -> [calls, seconds]
_SPANS: dict[str, list] = {}
_COUNTS: collections.Counter = collections.Counter()
# open spans by name (a nested span of an open name counts nothing)
_DEPTH: collections.Counter = collections.Counter()
# (read() -> {counter: value}, clear()) of the always-on counters
_SOURCES: list = []
# the device of the shard whose work is running (set by
# ``parallel.on_entry``); None outside any shard's work
SHARD: contextvars.ContextVar = contextvars.ContextVar("shard", default=None)


def active() -> bool:
    """Whether spans and counts record now."""
    return _ENABLED or _profiler._is_profiler_enabled


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def _sync() -> None:
    """Synchronize the running shard's device, or outside a shard every
    device of the set."""
    if not torch.cuda.is_available():
        return
    from .runtime import devices
    shard = SHARD.get()
    for d in devices() if shard is None else [torch.device(shard)]:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class _Span:
    """A span while tracing is on; also the decorator form of a name."""

    __slots__ = ("name", "device", "_rf", "_t0")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.device = device
        self._rf = None
        self._t0 = 0.0

    def __enter__(self):
        if not _DEPTH[self.name]:
            self._rf = _RANGE(self.name)
            self._rf.__enter__()
            self._t0 = time.perf_counter()
        _DEPTH[self.name] += 1
        return self

    def __exit__(self, *exc):
        _DEPTH[self.name] -= 1
        if self._rf is None:
            return False
        try:
            if self.device:
                _sync()
        finally:
            dt = time.perf_counter() - self._t0
            self._rf.__exit__(*exc)
            rec = _SPANS.setdefault(self.name, [0, 0.0])
            rec[0] += 1
            rec[1] += dt
        return False

    def __call__(self, fn):
        name, device = self.name, self.device

        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name, device):
                return fn(*args, **kwargs)
        return traced


class _Off(_Span):
    """The span of a name while tracing is off: one object a name."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF: tuple[dict, dict] = ({}, {})   # by ``device``: name -> _Off


def span(name: str, device: bool = False):
    """A span named ``name``: a context manager, or a decorator of a
    function whose every call is the span."""
    if _ENABLED or _profiler._is_profiler_enabled:
        return _Span(name, device)
    off = _OFF[device].get(name)
    if off is None:
        off = _OFF[device][name] = _Off(name, device)
    return off


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _ENABLED or _profiler._is_profiler_enabled:
        _COUNTS[name] += n


def register(read, clear) -> None:
    """An always-on counter source: ``read()`` gives {counter: value},
    ``clear()`` zeroes it (:func:`reset`)."""
    _SOURCES.append((read, clear))


def snapshot() -> dict:
    """{"spans": {name: (calls, seconds)}, "counters": {name: value}}:
    the spans and counters recorded since :func:`reset`, and the
    registered always-on counters that are not zero."""
    counters = dict(_COUNTS)
    for read, _clear in _SOURCES:
        counters.update((k, v) for k, v in read().items() if v)
    return {"spans": {k: (c, s) for k, (c, s) in _SPANS.items()},
            "counters": counters}


def names() -> list[str]:
    """The names of the spans recorded since :func:`reset`."""
    return sorted(_SPANS)


def reset() -> None:
    """Forget every span and counter, the registered ones too."""
    _SPANS.clear()
    _COUNTS.clear()
    for _read, clear in _SOURCES:
        clear()


def write(path: str) -> None:
    """:func:`snapshot` as TSV rows ``span <name> <calls> <seconds>`` and
    ``counter <name> <value>``, each kind sorted by name."""
    snap = snapshot()
    with open(path, "w") as f:
        for name, (calls, sec) in sorted(snap["spans"].items()):
            f.write(f"span\t{name}\t{calls}\t{sec:.6f}\n")
        for name, v in sorted(snap["counters"].items()):
            f.write(f"counter\t{name}\t{v}\n")
