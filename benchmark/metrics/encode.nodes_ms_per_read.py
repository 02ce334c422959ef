"""Node building after verification (``stages/encode.encode``: nodes from
the results, their dedup and the encoded reads; the program's span
``encode.nodes``), milliseconds a read encoded (the program's counter
``encode.reads``)."""

import program_trace


def read(ctx):
    return program_trace.ms_per_unit(("encode.nodes",), "encode.reads")
