"""Per-layer metrics read from the program's own spans and counters
(``jtk_tpu_torch.trace``), not from wrappers put around its functions.

The program records them while ``torch.profiler`` records, that is during
the traced run's profiled job alone; a reader divides a span's seconds by
the program's own unit counter over that job (``clustering.chunks`` for a
phase job, ``encode.reads`` for an encode job).  A program without the
trace module, a span or the counter gives ``None``: the line then leaves
the metric out.
"""

from __future__ import annotations


def ms_per_unit(spans, unit: str) -> float | None:
    """Milliseconds of the spans ``spans`` together per unit of the
    counter ``unit``; None where the program has no trace module, where a
    span or the counter is missing, or where the counter is 0."""
    try:
        from jtk_tpu_torch import trace
    except ImportError:
        return None
    snap = trace.snapshot()
    n = snap["counters"].get(unit)
    got = [snap["spans"].get(s) for s in spans]
    if not n or any(g is None for g in got):
        return None
    return 1e3 * sum(sec for _calls, sec in got) / n
