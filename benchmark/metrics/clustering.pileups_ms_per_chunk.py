"""The host work of a phase job before its polish: coverage, the gain
calibration, gathering the pileups and decoding their nodes (the
program's span ``clustering.pileups``), milliseconds a chunk clustered
(the program's counter ``clustering.chunks``)."""

import program_trace


def read(ctx):
    return program_trace.ms_per_unit(("clustering.pileups",),
                                     "clustering.chunks")
