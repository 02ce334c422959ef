"""Candidate verification: host preparation, K3 and its walk
(``mapper.extend_candidates``), milliseconds a read encoded."""

SPANS = {"mapper.extend": "jtk_tpu_torch.mapper:extend_candidates"}


def read(ctx):
    s = ctx.span_s("mapper.extend")
    if s is None or not ctx.units:
        return None
    return 1e3 * s / ctx.units
