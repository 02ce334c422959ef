"""The variant features' column gather on the device and its copy back
(the program's span ``clustering.features.gather``, ending in a
synchronize), milliseconds a chunk clustered (the program's counter
``clustering.chunks``)."""

import program_trace


def read(ctx):
    return program_trace.ms_per_unit(("clustering.features.gather",),
                                     "clustering.chunks")
