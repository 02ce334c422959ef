"""Candidate verification's host work (``mapper.extend_candidates``: the
program's spans ``mapper.windows``, the chunk and read blobs and each
batch's window rows, and ``mapper.decode``, decoding and the rare redo
passes), milliseconds a read encoded (the program's counter
``encode.reads``)."""

import program_trace


def read(ctx):
    return program_trace.ms_per_unit(("mapper.windows", "mapper.decode"),
                                     "encode.reads")
