"""The share of the profiled job's kernel launches made for entries of
the device set other than the primary (the program's counters
``parallel.launches.<i>``, launches for entry i while tracing), in per
cent: 75 on a perfectly even set of four.  None where the program has no
trace module or counted no launch by entry."""

PREFIX = "parallel.launches."


def read(ctx):
    try:
        from jtk_tpu_torch import trace
    except ImportError:
        return None
    by_entry = {int(k[len(PREFIX):]): v for k, v in
                trace.snapshot()["counters"].items() if k.startswith(PREFIX)}
    total = sum(by_entry.values())
    if not total:
        return None
    return 100.0 * (total - by_entry.get(0, 0)) / total
