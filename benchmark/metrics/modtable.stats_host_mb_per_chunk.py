"""Bytes of variant stats copied to the host (the program's counter
``modtable.stats_host_bytes``: one float64 block of (chunks, Tpad + 1,
14, 6) a features call), in MB (10^6 bytes) a chunk clustered (the
program's counter ``clustering.chunks``).  None where the program has no
trace module or either counter."""


def read(ctx):
    try:
        from jtk_tpu_torch import trace
    except ImportError:
        return None
    c = trace.snapshot()["counters"]
    n, chunks = c.get("modtable.stats_host_bytes"), c.get("clustering.chunks")
    if n is None or not chunks:
        return None
    return n / 1e6 / chunks
