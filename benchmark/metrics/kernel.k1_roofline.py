"""K1f and K1b (``csrc/phmm_tables.cu``) in the profiled job: the least
time their launches need at the card's peaks (``roofline.py``: inputs as
passed, the three tables and row scales written, ~40 operations a band
cell of the rows the pairs need) over the time the profiler saw them run,
in per cent."""

import roofline


def _tables(emis, shifts, inc, rc0, j0, m0, i0, d0, qlen, tlen, strand,
            trans, trans2):
    B, W = rc0.shape
    Q = shifts.shape[1]
    args = (emis, shifts, inc, rc0, j0, m0, i0, d0, qlen, tlen, strand,
            trans, trans2)
    nbytes = sum(t.numel() * t.element_size() for t in args)
    return "k1", roofline.k1_tables(nbytes, B, Q, W, int(qlen.sum()),
                                    m0.element_size())


LAUNCHES = {"jtk_tpu_torch.ops.phmm_tables:fwd_tables": _tables,
            "jtk_tpu_torch.ops.phmm_tables:bwd_tables": _tables}


def read(ctx):
    t = ctx.kernel_s("fwd_tables", "bwd_tables")
    if t <= 0 or ctx.least.get("k1", 0) <= 0:
        return None
    return 100.0 * ctx.least["k1"] / t
