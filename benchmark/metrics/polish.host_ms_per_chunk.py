"""The polish's host work (``ops/polish.polish_many``: the program's
spans ``polish.prep``, the pairs, band buckets and padded inputs of each
round, and ``polish.edits``, choosing and applying the edits),
milliseconds a chunk clustered (the program's counter
``clustering.chunks``)."""

import program_trace


def read(ctx):
    return program_trace.ms_per_unit(("polish.prep", "polish.edits"),
                                     "clustering.chunks")
