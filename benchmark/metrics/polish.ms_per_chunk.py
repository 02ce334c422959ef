"""The batched polish of every chunk's template through K1 and the
modification table (``ops/polish.polish_many``), milliseconds a chunk
clustered."""

SPANS = {"polish": "jtk_tpu_torch.ops.polish:polish_many"}


def read(ctx):
    s = ctx.span_s("polish")
    if s is None or not ctx.units:
        return None
    return 1e3 * s / ctx.units
