"""Host k-mer voting: the chunk index's build and the candidate sweep
(``mapper.ChunkIndex``), milliseconds a read encoded."""

SPANS = {"mapper.index": "jtk_tpu_torch.mapper:ChunkIndex.__init__",
         "mapper.vote": "jtk_tpu_torch.mapper:ChunkIndex.candidates_batch"}


def read(ctx):
    a, b = ctx.span_s("mapper.index"), ctx.span_s("mapper.vote")
    if a is None or b is None or not ctx.units:
        return None
    return 1e3 * (a + b) / ctx.units
