"""Spans, launch records and the device trace of a traced run.

Spans come from the benchmark's own files: a metric's reader names the
program functions it times (``"module:function"`` or
``"module:Class.method"``), and :class:`Tracer` wraps them by module
attribute (:func:`patch`, the one way the benchmark replaces a program
function: the jobs' recorders and the planted faults use it too) for the
traced run only.  A span ends with a synchronize, so it
holds the device work it started; a span that calls itself counts once.
Each span is also a ``record_function`` range, so the device trace can
name the host's activity in each idle gap.

A reader may also name launch recorders: for each call of a kernel
wrapper during the profiled job, the launch's least time on the card
(:mod:`roofline`) from its shapes.
"""

from __future__ import annotations

import collections
import importlib
import sys
import time

PROGRAM = "jtk_tpu_torch"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def patch(spec: str, make) -> list:
    """Replace the program function at ``spec`` (``"module:function"`` or
    ``"module:Class.method"``) by ``make(original)`` in every module of the
    program that holds it; returns the undo list for :func:`undo`."""
    mod_name, attr = spec.split(":")
    mod = importlib.import_module(mod_name)
    if "." in attr:
        cls_name, meth = attr.split(".")
        cls = getattr(mod, cls_name)
        orig = cls.__dict__[meth]
        setattr(cls, meth, make(orig))
        return [(cls, meth, orig)]
    orig = getattr(mod, attr)
    new = make(orig)
    done = []
    for name, m in list(sys.modules.items()):
        if m is None or name.split(".")[0] != PROGRAM:
            continue
        for key, val in list(vars(m).items()):
            if val is orig:
                setattr(m, key, new)
                done.append((m, key, orig))
    return done


def undo(done: list):
    """Put back what :func:`patch` replaced, last first."""
    for obj, key, orig in reversed(done):
        setattr(obj, key, orig)
    done.clear()


class Tracer:
    """Installs spans and launch recorders; undoes them on :meth:`close`."""

    def __init__(self):
        self.spans: dict[str, list[float]] = collections.defaultdict(list)
        self.least: dict[str, float] = collections.defaultdict(float)
        self.recording = False
        self._depth: collections.Counter = collections.Counter()
        self._undo: list = []

    def _patch(self, spec: str, make):
        self._undo.extend(patch(spec, make))

    def span(self, name: str, spec: str):
        import torch

        def make(orig):
            def wrapped(*args, **kwargs):
                if self._depth[name]:
                    return orig(*args, **kwargs)
                self._depth[name] += 1
                t0 = time.perf_counter()
                try:
                    with torch.profiler.record_function(name):
                        out = orig(*args, **kwargs)
                        _sync()
                finally:
                    self._depth[name] -= 1
                self.spans[name].append(time.perf_counter() - t0)
                return out
            return wrapped
        self._patch(spec, make)

    def launches(self, spec: str, least):
        """``least(*args, **kwargs)`` -> (family, seconds) for each call of
        the wrapper at ``spec`` while :attr:`recording`."""
        def make(orig):
            def wrapped(*args, **kwargs):
                if self.recording:
                    fam, sec = least(*args, **kwargs)
                    self.least[fam] += sec
                return orig(*args, **kwargs)
            return wrapped
        self._patch(spec, make)

    def close(self):
        undo(self._undo)


def device_intervals(prof, annotations):
    """(device intervals [(start_ns, end_ns, name)]: kernels, copies and
    fills; host ranges [(start_ns, end_ns, name)] of the ``annotations``)
    from a finished profiler."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        name, s = ev.name(), ev.start_ns()
        iv = (s, s + ev.duration_ns(), name)
        if ev.device_type() == cuda:
            # an annotation's range on the device's timeline is no work;
            # older profilers name no activity type
            act = getattr(ev, "activity_type", None)
            if (str(act()) in DEVICE_ACTIVITIES) if act \
                    else name not in annotations:
                dev.append(iv)
        elif name in annotations:
            host.append(iv)
    return dev, host


def busy_and_gaps(dev, host, t0, t1):
    """Seconds the device ran something within [t0, t1] (ns), and idle
    seconds by the innermost host range that covers each gap's middle."""
    iv = sorted((max(a, t0), min(b, t1)) for a, b, _n in dev
                if b > t0 and a < t1)
    busy = 0
    gaps = collections.Counter()
    merged_end = t0
    for a, b in iv:
        if a > merged_end:
            gaps[_host_at(host, (merged_end + a) // 2)] += (a - merged_end)
        if b > merged_end:
            busy += b - max(a, merged_end)
            merged_end = b
    if t1 > merged_end:
        gaps[_host_at(host, (merged_end + t1) // 2)] += t1 - merged_end
    return busy / 1e9, {k: v / 1e9 for k, v in gaps.items()}


def _host_at(host, t):
    best = None
    for a, b, name in host:
        if a <= t <= b and (best is None or b - a < best[0]):
            best = (b - a, name)
    return best[1] if best else "outside spans"


def short_name(name: str) -> str:
    """A kernel's name without its return type, arguments and templates'
    spaces, at most 60 characters."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    n = n.split("(")[0]
    return n[:60]


def kernel_seconds(dev) -> dict[str, float]:
    out = collections.Counter()
    for a, b, name in dev:
        out[short_name(name)] += (b - a) / 1e9
    return dict(out)
