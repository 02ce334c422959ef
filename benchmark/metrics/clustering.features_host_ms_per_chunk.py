"""The variant features' host work (``_variant_features_device`` in
``stages/local_clustering``: the program's spans
``clustering.features.prep``, ``.candidates`` and ``.pick``),
milliseconds a chunk clustered (the program's counter
``clustering.chunks``)."""

import program_trace

PARTS = ("clustering.features.prep", "clustering.features.candidates",
         "clustering.features.pick")


def read(ctx):
    return program_trace.ms_per_unit(PARTS, "clustering.chunks")
