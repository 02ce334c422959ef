"""Bytes the device set's merges take from shards of entries other than
the primary (the program's counter ``parallel.merge_bytes``, 0 where
every merged shard was the primary's), in MB
(10^6 bytes) a chunk clustered (the program's counter
``clustering.chunks``).  None where the program has no trace module or
either counter."""


def read(ctx):
    try:
        from jtk_tpu_torch import trace
    except ImportError:
        return None
    c = trace.snapshot()["counters"]
    n, chunks = c.get("parallel.merge_bytes"), c.get("clustering.chunks")
    if n is None or not chunks:
        return None
    return n / 1e6 / chunks
