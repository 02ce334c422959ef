"""The device set's merges (the program's span ``parallel.merge``: shard
results brought to the primary or to the host, in shard or slice order,
with their concatenations and sums), milliseconds a chunk clustered (the
program's counter ``clustering.chunks``)."""

import program_trace


def read(ctx):
    return program_trace.ms_per_unit(("parallel.merge",),
                                     "clustering.chunks")
