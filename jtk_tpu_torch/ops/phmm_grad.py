"""Gradient of the pair-HMM log-likelihood, as Baum-Welch expected counts.

``jtk_tpu`` differentiates the forward scan with ``jax.value_and_grad``
(``jtk_tpu/parallel/__init__.py::make_train_step``); no Pallas kernel is
involved.  The port computes the same gradient in closed form: lk is a
polynomial in the parameters, so ``d lk / d p_x = E[n_x] / p_x`` with
``E[n_x]`` the expected number of uses of parameter ``x`` over the banded
paths.  :class:`PairHMMLikelihood` is the ``torch.autograd.Function``:

* forward: the K1l kernel (:mod:`.phmm_lk`);
* backward: the K1 forward and backward tables (:mod:`.phmm_tables`, strand
  0, one parameter set) in float64, and the counts kernel of
  ``csrc/phmm_counts.cu`` (:func:`phmm_counts`; :func:`phmm_counts_plain`
  on CPU tensors), scaled by ``grad_output``.  Float64, because a read
  that starts s bases late in its template opens with a deletion run of
  weight ~tdd^(s-1) (~1e-52 at s = 26), under float32's range in a row
  scaled once: its counts were wrong in float32 from s ~ 26; double
  reaches ~150 bases late.  The backward starts from the derivative of lk
  = log(fin + EPS) + fcum itself, the end cell plus EPS times the last
  row's every cell, so a read whose end cell falls under EPS (one that
  ends ~20+ bases early) gets the floored lk's gradient, not ~0.  The kernel is a reduction over (pair, row strip, band
  chunk) units with a fixed-order second pass: no float atomics, so the
  counts are the same bits from run to run.

Per-pair counts are (B, 45) f32: transitions ``[from, to]`` (9, states
M=0, I=1, D=2, row 0's M->D / D->D chain and the in-row D terms
included), ``mat_emit[ref, query]`` (16) from the M posteriors and
``ins_emit[prev query or 4 = start, query]`` (20) from the I posteriors.
"""

from __future__ import annotations

import torch

from .cuda_build import Launches, check, launch
from .phmm import PHMMParams
from .phmm_lk import lk_inputs, phmm_lk, tables8
from .phmm_tables import _shl3, _shr3, prep_tables_inputs, tables_batch

LAUNCHES = Launches("phmm_counts")
N_COUNTS = 9 + 16 + 20
COUNTS_STRIP = 16       # rows of a unit of the counts kernel
COUNTS_CHUNK = 128      # band lanes of a unit: 32 threads x 4 lanes
HALF_WEIGHT_CAP = 700.0  # e^700 < float64's largest, 1.8e308
# the six float64 tables of one gradient slice (B, Q+1, W) may take this
# many bytes; a larger batch is cut into slices of pairs
COUNTS_TABLE_BYTES = 4 << 30
PAIR_KEYS = ("qs", "r", "offs", "q_lens", "t_lens", "strand")


def _half_weight(c, live):
    """exp(c / 2) where ``live``, else 0 (float64): a cell's weight
    exp(fcum + bcum - lk) goes half to its forward and half to its backward
    value.  Whole, it can pass the type's range where f * b is tiny, as at
    row 0 of a read that starts late in its template, and 0 * inf gave NaN
    counts; c / 2 is capped at HALF_WEIGHT_CAP."""
    return torch.where(live, torch.exp(torch.clamp(0.5 * c,
                                                   max=HALF_WEIGHT_CAP)), 0.0)


def phmm_counts_plain(fM, fI, fD, bM, bI, bD, fcum, bcum, rcs, qs, shifts,
                      qlen, lk, trans, me, ie):
    """Plain PyTorch version of the counts kernel: (B, 45) f32 from float64
    tables, computed in float64."""
    B, Q1 = fM.shape[:2]
    dev = fM.device
    rows = torch.arange(Q1, device=dev)
    ql = qlen.to(torch.int64)[:, None]
    h_row = _half_weight(fcum + bcum - lk[:, None], rows[None] <= ql)
    h_in = _half_weight(fcum[:, :-1] + bcum[:, 1:] - lk[:, None],
                        rows[None, 1:] <= ql)[..., None]
    h_cell = h_row[..., None]
    one = (shifts == 1)[..., None]
    prev = [x[:, :-1] * h_in for x in (fM, fI, fD)]
    Xd = [torch.where(one, x, _shr3(x)) for x in prev]
    Xu = [torch.where(one, _shl3(x), x) for x in prev]
    qc = qs.to(torch.int64)
    qp = torch.cat([torch.full((B, 1), 4, dtype=torch.int64, device=dev),
                    qc[:, :-1]], 1)
    rc = rcs[:, 1:].to(torch.int64)
    em = me.reshape(-1)[rc * 8 + qc[..., None]]
    ei = ie.reshape(-1)[qp * 8 + qc][..., None]
    gM = em * bM[:, 1:] * h_in
    gI = ei * bI[:, 1:] * h_in
    gD = bD * h_cell
    t = trans
    cnt = []
    for a in range(3):
        cnt += [(t[a, 0] * Xd[a] * gM).sum((1, 2)),
                (t[a, 1] * Xu[a] * gI).sum((1, 2)),
                (t[a, 2] * _shr3((fM, fI, fD)[a] * h_cell) * gD).sum((1, 2))]
    h1 = h_cell[:, 1:]
    post_m = (fM[:, 1:] * h1) * (bM[:, 1:] * h1)
    post_i = ((fI[:, 1:] * h1) * (bI[:, 1:] * h1)).sum(2)
    oh = torch.nn.functional.one_hot
    dt = post_m.dtype
    by_ref = torch.einsum("bqw,bqwa->bqa", post_m,
                          oh(rc.clamp(0, 4), 5)[..., :4].to(dt))
    oq = oh(qc.clamp(0, 4), 5)[..., :4].to(dt)
    me_c = torch.einsum("bqa,bqc->bac", by_ref, oq).reshape(B, 16)
    ie_c = torch.einsum("bq,bqp,bqc->bpc", post_i,
                        oh(qp.clamp(0, 4), 5).to(dt), oq).reshape(B, 20)
    return torch.cat([torch.stack(cnt, 1), me_c, ie_c], 1).to(torch.float32)


def counts_geometry(W: int, Q: int) -> int:
    """Units of the counts kernel a pair has at band width ``W`` and ``Q``
    query rows: strips of ``COUNTS_STRIP`` rows of its Q + 1 times chunks
    of ``COUNTS_CHUNK`` band lanes (one warp each, ``csrc/phmm_counts.cu``).
    Any W >= 1."""
    if W < 1:
        raise ValueError(f"phmm_counts: band width {W} below 1")
    return -(-(Q + 1) // COUNTS_STRIP) * -(-W // COUNTS_CHUNK)


def phmm_counts(fM, fI, fD, bM, bI, bD, fcum, bcum, rcs, qs, shifts, qlen,
                lk, trans, me, ie):
    """Per-pair expected counts from the stitched K1 tables.

    fM..bD (B, Q+1, W) f64 scaled tables, fcum, bcum (B, Q+1) f64
    cumulative log scales, rcs (B, Q+1, W) int32 template chars per cell,
    qs, shifts (B, Q) int32, qlen (B,) int32, lk (B,) f64, trans, me, ie
    (8, 8) f32 padded tables.  Returns (B, 45) f32, the same bits from run
    to run."""
    if fM.device.type == "cpu":
        return phmm_counts_plain(fM, fI, fD, bM, bI, bD, fcum, bcum, rcs, qs,
                                 shifts, qlen, lk, trans, me, ie)
    B, Q1, W = fM.shape
    Q = Q1 - 1
    units = counts_geometry(W, Q)
    f32, f64, i32 = torch.float32, torch.float64, torch.int32
    tables = (fM, fI, fD, bM, bI, bD, rcs)
    for t, name, dt, shape in (
            (fM, "fM", f64, (B, Q1, W)), (fI, "fI", f64, (B, Q1, W)),
            (fD, "fD", f64, (B, Q1, W)), (bM, "bM", f64, (B, Q1, W)),
            (bI, "bI", f64, (B, Q1, W)), (bD, "bD", f64, (B, Q1, W)),
            (fcum, "fcum", f64, (B, Q1)), (bcum, "bcum", f64, (B, Q1)),
            (rcs, "rcs", i32, (B, Q1, W)), (qs, "qs", i32, (B, Q)),
            (shifts, "shifts", i32, (B, Q)), (qlen, "qlen", i32, (B,)),
            (lk, "lk", f64, (B,)), (trans, "trans", f32, (8, 8)),
            (me, "me", f32, (8, 8)), (ie, "ie", f32, (8, 8))):
        check(t, dt, shape, f"phmm_counts {name}")
    # 16-byte loads of 4 lanes: rows of a multiple of 4 lanes, aligned bases
    vec = W % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tables)
    part = torch.empty((B, units, N_COUNTS), dtype=f32, device=fM.device)
    out = torch.empty((B, N_COUNTS), dtype=f32, device=fM.device)
    launch("phmm_counts", "phmm_counts_launch", fM, fI, fD, bM, bI, bD, fcum,
           bcum, rcs, qs, shifts, qlen, lk, trans, me, ie, part, out, B, Q, W,
           units, int(vec))
    LAUNCHES.add((B, Q, W))
    return out


def counts_prep(params, batch: "PairBatch") -> dict:
    """The K1 tables' prep of ``batch`` under one parameter set (both
    strands)."""
    t8, me8, ie8 = tables8(params, batch.device)
    return dict(batch.prep, trans=t8, me8=me8, ie8=ie8, trans2=t8, me28=me8,
                ie28=ie8)


def counts_args(prep, W: int):
    """Run the K1 table kernels on a prepared batch (one parameter set), in
    float64 and with the backward of lk itself (its EPS term included), and
    return :func:`phmm_counts`' arguments."""
    lk, (fM, fI, fD), fcum, rcs, (bM, bI, bD), bcum, _offs = \
        tables_batch(prep, W, dtype=torch.float64, lk_init=True)
    i32 = torch.int32
    qs = prep["qs"]
    shifts = (prep["offs"][:, 1:] - prep["offs"][:, :-1]).to(i32)
    return (fM, fI, fD, bM, bI, bD, fcum.contiguous(), bcum.contiguous(),
            rcs.to(i32).contiguous(), qs.to(i32).contiguous(),
            shifts.contiguous(), prep["q_lens"].to(i32).contiguous(),
            lk.contiguous(), prep["trans"], prep["me8"], prep["ie8"])


def counts_slices(B: int, Q: int, W: int) -> list[tuple[int, int]]:
    """Pair ranges of the gradient's slices: as many pairs a slice as keep
    its six float64 (Q+1, W) tables within COUNTS_TABLE_BYTES."""
    per = max(1, COUNTS_TABLE_BYTES // (6 * (Q + 1) * W * 8))
    return [(a, min(B, a + per)) for a in range(0, B, per)]


def batch_counts(prep, W: int) -> torch.Tensor:
    """Expected counts (B, 45) of a prepared batch, slice by slice
    (:func:`counts_slices`; the counts of a pair depend on it alone)."""
    B, Q = prep["qs"].shape
    out = []
    for a, b in counts_slices(B, Q, W):
        part = {k: (v[a:b] if k in PAIR_KEYS else v) for k, v in prep.items()}
        out.append(phmm_counts(*counts_args(part, W)))
    return out[0] if len(out) == 1 else torch.cat(out)


class PairBatch:
    """A batch of (read, template) pairs prepared once on the device for
    repeated likelihood and gradient evaluations: the K1l arguments and the
    K1 tables' prep (whose parameter tables are replaced per call)."""

    def __init__(self, qs, template, offsets, q_lens, t_len, W: int,
                 device=None):
        from ..runtime import resolve
        dev = resolve(device)
        self.W = int(W)
        self.device = dev
        self.lk_args = lk_inputs(qs, template, offsets, q_lens, t_len, W,
                                 device=dev)
        self.prep = prep_tables_inputs(qs, template, offsets, q_lens, t_len,
                                       PHMMParams.default(dev), W, device=dev)
        self.q_lens = self.prep["q_lens"]


class PairHMMLikelihood(torch.autograd.Function):
    """lk (B,) of a :class:`PairBatch` under (trans, mat_emit, ins_emit),
    differentiable in the three tables."""

    @staticmethod
    def forward(ctx, trans, mat_emit, ins_emit, batch: PairBatch):
        tabs = tables8(PHMMParams(trans, mat_emit, ins_emit), batch.device)
        ctx.save_for_backward(trans, mat_emit, ins_emit)
        ctx.batch = batch
        return phmm_lk(*batch.lk_args, *tabs)

    @staticmethod
    def backward(ctx, grad_lk):
        trans, mat_emit, ins_emit = ctx.saved_tensors
        batch = ctx.batch
        prep = counts_prep(PHMMParams(trans, mat_emit, ins_emit), batch)
        counts = batch_counts(prep, batch.W)
        g = (grad_lk.to(counts.dtype)[:, None] * counts).sum(0)
        return (g[:9].view(3, 3) / trans, g[9:25].view(4, 4) / mat_emit,
                g[25:].view(5, 4) / ins_emit, None)


def pair_likelihood(params, batch: PairBatch) -> torch.Tensor:
    """Differentiable log-likelihoods (B,) of ``batch`` under ``params``
    (a PHMMParams of tensors on the batch's device)."""
    return PairHMMLikelihood.apply(params.trans, params.mat_emit,
                                   params.ins_emit, batch)
