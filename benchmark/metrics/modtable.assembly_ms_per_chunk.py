"""The modification table's closed-form assembly in PyTorch on the device
and its per-slice reduction (``ops/modtable``: the program's span
``modtable.assembly``, ending in a synchronize), milliseconds a chunk
clustered (the program's counter ``clustering.chunks``)."""

import program_trace


def read(ctx):
    return program_trace.ms_per_unit(("modtable.assembly",),
                                     "clustering.chunks")
