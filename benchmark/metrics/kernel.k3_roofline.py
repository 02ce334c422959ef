"""K3's DP and walk (``csrc/edit_dp.cu``) in the profiled job: the least
time their launches need at the card's peaks (``roofline.py``, from each
launch's shapes, rows up to each pair's q_len) over the time the profiler
saw them run, in per cent."""

import roofline


def _dp(e0, qs, shifts, inc, rc0, j0, qlen, tlen):
    B, W = e0.shape
    return "k3", roofline.k3_dp(B, W, int(qlen.sum()))


def _walk(packed, off, q_len, end_j, W):
    Q, B = packed.shape[0], packed.shape[1]
    return "k3", roofline.k3_walk(B, Q, W, int(q_len.sum()))


LAUNCHES = {"jtk_tpu_torch.ops.edit_dp:edit_dp": _dp,
            "jtk_tpu_torch.ops.edit_dp:traceback_packed": _walk}


def read(ctx):
    t = ctx.kernel_s("edit_dp_", "edit_tb")
    if t <= 0 or ctx.least.get("k3", 0) <= 0:
        return None
    return 100.0 * ctx.least["k3"] / t
