"""The CIGAR refresh of every pileup read against its polished template,
K3 and its walk with their host preparation and the write-back (the
program's span ``clustering.refresh``, ending in a synchronize),
milliseconds a chunk clustered (the program's counter
``clustering.chunks``)."""

import program_trace


def read(ctx):
    return program_trace.ms_per_unit(("clustering.refresh",),
                                     "clustering.chunks")
