"""K1f and K1b for the modification table, with their inputs' preparation
(``ops/modtable._modtable_slice``: the program's span ``modtable.k1``,
ending in a synchronize), milliseconds a chunk clustered (the program's
counter ``clustering.chunks``)."""

import program_trace


def read(ctx):
    return program_trace.ms_per_unit(("modtable.k1",), "clustering.chunks")
