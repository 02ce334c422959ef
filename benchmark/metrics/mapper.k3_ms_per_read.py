"""K3 and its walk over each batch of candidates, with the gather and the
copy back (the program's span ``mapper.k3``, ending in a synchronize),
milliseconds a read encoded (the program's counter ``encode.reads``)."""

import program_trace


def read(ctx):
    return program_trace.ms_per_unit(("mapper.k3",), "encode.reads")
