"""K2 launches (the program's counter ``launches.modtable_assembly``, the
modification table's assembly kernel) a chunk clustered.

The launch counter counts from the process's start, and the unit counter
``clustering.chunks`` over the profiled job alone; so the value is the
profiled job's modtable slices a chunk (``modtable.slices`` over
``clustering.chunks``) times the share of the process's slices that
launched K2: its launches over the slices the program's always-on
``modtable.calls_by_slices.<n>`` counters count.  None where the program
has no trace module or no K2 counter."""


def read(ctx):
    try:
        from jtk_tpu_torch import trace
    except ImportError:
        return None
    c = trace.snapshot()["counters"]
    launches = c.get("launches.modtable_assembly")
    slices, chunks = c.get("modtable.slices"), c.get("clustering.chunks")
    prefix = "modtable.calls_by_slices."
    total = sum(int(k[len(prefix):]) * v for k, v in c.items()
                if k.startswith(prefix))
    if not (launches and slices and chunks and total):
        return None
    return launches / total * slices / chunks
