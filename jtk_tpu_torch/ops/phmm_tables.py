"""K1 — banded pair-HMM forward and backward tables.

Counterpart of the table half of ``jtk_tpu/ops/pallas_phmm.py``.
:func:`fwd_tables` and :func:`bwd_tables` are the kernel wrappers: on CUDA
tensors they launch the hand-written kernels of ``csrc/phmm_tables.cu``; on
CPU tensors they run :func:`fwd_tables_plain` / :func:`bwd_tables_plain`,
the same functions in plain PyTorch.  Around them sits the glue of
``_prep_tables_inputs`` / ``_tables_traced``: the five per-row emission
streams, the closed-form forward row 0 and backward init, stitching to
(B, Q+1, W), the q_len overwrite of the backward tables, fcum/bcum and lk.

The forward pass rescales each row by its SUM, the backward pass by its
MAX; the closed-form modification table joins the two cumulative scales.
The tables are float32, or float64 for the gradient's expected counts
(:mod:`.phmm_grad`): the state, the Del chain and the scales in the given
type, the emissions and transitions float32.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_build import Launches, check, launch

EPS = 1e-30

FWD_LAUNCHES = Launches("fwd_tables")
BWD_LAUNCHES = Launches("bwd_tables")

SHARED_FORM_W = 4096    # the widest band whose row state fits shared memory
MAX_LANES = 4           # band lanes a thread keeps in registers
WIDE_WARPS = 8          # warps a pair in the wide form
SCRATCH_THREADS = 512   # threads of a pair's block in the scratch form


def register_form_w(dtype=torch.float32) -> int:
    """The widest band of the register form: 16 warps of 4 lanes in float32;
    in float64 8 warps (at 16, a block of 512 threads has 128 registers a
    thread, and the double state does not fit)."""
    return 2048 if dtype == torch.float32 else 1024


def tables_geometry(W: int, kernel: str = "tables",
                    dtype=torch.float32) -> tuple[int, int, int]:
    """Launch geometry of the table kernels, and of K1l (``csrc/phmm_lk.cu``),
    for band width ``W`` in ``dtype``: (lanes per thread, warps per pair,
    pairs per block).  In the register form a thread holds up to MAX_LANES
    lanes (the cost of a row is the instructions one thread issues, so
    wide bands take more warps, 1 to 16, rather than more lanes); a block
    holds 4 warps, or one pair of more.  Above ``register_form_w`` the wide
    form keeps each lane's state in shared memory: 8 lanes a thread up to
    2048, 16 up to SHARED_FORM_W, WIDE_WARPS warps, one pair a block (the
    counts are powers of two: the kernels are built for those).  Above
    SHARED_FORM_W the scratch form (``csrc/band_scratch.cuh``): one block
    of SCRATCH_THREADS threads a pair, ceil(W / SCRATCH_THREADS) lanes a
    thread, the state in a per-pair scratch in device memory
    (:func:`scratch_bytes`); any width."""
    if W < 1:
        raise ValueError(f"{kernel}: band width {W} below 1")
    if W > SHARED_FORM_W:
        return -(-W // SCRATCH_THREADS), SCRATCH_THREADS // 32, 1
    if W > register_form_w(dtype):
        return (8 if W <= 32 * 8 * WIDE_WARPS else 16), WIDE_WARPS, 1
    lanes = 1
    while lanes < MAX_LANES and 32 * lanes < W:
        lanes *= 2
    warps = 1
    while 32 * lanes * warps < W:
        warps *= 2
    return lanes, warps, max(1, 4 // warps)


def scratch_bytes(W: int, dtype=torch.float32) -> int:
    """Bytes of device scratch a pair takes at band width ``W``: none up to
    SHARED_FORM_W; above, two rows of M, I, D in ``dtype`` and two rows of
    band chars, W padded to a multiple of SCRATCH_THREADS lanes each
    (``band_scratch.cuh::pair_bytes``)."""
    if W <= SHARED_FORM_W:
        return 0
    size = torch.finfo(dtype).bits // 8
    lanes = -(-W // SCRATCH_THREADS) * SCRATCH_THREADS
    return lanes * 2 * (3 * size + 4)


def scratch(B: int, W: int, dtype, device) -> torch.Tensor:
    """The scratch form's per-pair state (:func:`scratch_bytes`), or an
    empty tensor below it (the kernels then take a null pointer)."""
    n = B * scratch_bytes(W, dtype)
    return torch.empty(n, dtype=torch.uint8, device=device)


def _shr(x, n=1):
    """x[:, k] -> x[:, k-n] (0 fill)."""
    return torch.nn.functional.pad(x[:, :-n], (n, 0))


def _shl(x, n=1):
    """x[:, k] -> x[:, k+n] (0 fill)."""
    return torch.nn.functional.pad(x[:, n:], (0, n))


def _tree_row_sum(x):
    """Row sums (B, 1) of ``x`` (B, W) by a pairwise tree of elementwise
    adds over W padded with zeros to a power of two: the same order for
    every row however many rows share the call (the library's reduction on
    the card splits a row by the number of rows)."""
    n = 1 << max(0, (x.shape[1] - 1).bit_length())
    x = torch.nn.functional.pad(x, (0, n - x.shape[1]))
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return x


def _shr3(x):
    """(B, 3, W): lane k reads k-1 (0 fill)."""
    return torch.nn.functional.pad(x[..., :-1], (1, 0))


def _shl3(x):
    """(B, 3, W): lane k reads k+1 (0 fill)."""
    return torch.nn.functional.pad(x[..., 1:], (0, 1))


def _linrec(c, a, rev: bool = False):
    """y[k] = c[k] + a * y[k-1] (or y[k+1] when ``rev``) along dim 1, by
    Hillis-Steele doubling."""
    W = c.shape[1]
    y = c
    A = a.expand_as(c)
    roll = _shl if rev else _shr
    s = 1
    while s < W:
        y = y + A * roll(y, s)
        A = A * roll(A, s)
        s *= 2
    return y


def _trans_cols(strand, trans, trans2, dtype=torch.float32):
    """Per-pair strand-selected transitions: 9 (B, 1) columns in the order
    mm, mi, md, im, ii, id, dm, di, dd, in the tables' ``dtype`` (the Del
    chain's powers of dd keep its range)."""
    sel = (strand > 0)[:, None]
    return [torch.where(sel, trans2[a, b], trans[a, b]).to(dtype)
            for a in range(3) for b in range(3)]


def _emis_rows(emis, Q):
    """(B, 5Q) streams -> (B, 5, Q) match emissions by ref code 0..4 (code
    4 = pad, emission 0) and (B, Q) insertion emissions."""
    B = emis.shape[0]
    e = emis.view(B, 5, Q)
    em5 = torch.cat([e[:, :4], torch.zeros_like(e[:, :1])], 1)
    return em5, e[:, 4]


def _last_row(qlen) -> int:
    """Rows past every pair's q_len only repeat the frozen state."""
    return int(qlen.max()) if qlen.numel() else 0


def fwd_tables_plain(emis, shifts, inc, rc0, j0, m0, i0, d0, qlen, tlen,
                     strand, trans, trans2):
    """Plain PyTorch version of the forward-tables kernel (the M, I, D rows
    move together as one (B, 3, W) state)."""
    B, W = rc0.shape
    Q = shifts.shape[1]
    mm, mi, md, im, ii, id_, dm, di, dd = _trans_cols(strand, trans, trans2,
                                                      m0.dtype)
    tM = torch.stack([mm, im, dm], 1)          # (B, 3, 1) into M
    tI = torch.stack([mi, ii, di], 1)          # (B, 3, 1) into I
    em5, ei = _emis_rows(emis, Q)
    tl = tlen[:, None]
    ql = qlen[:, None]
    F = torch.stack([m0, i0, d0], 1)
    j, rc = j0, rc0.to(torch.int64)
    inc = inc.to(torch.int64)
    dt = m0.dtype
    outF = torch.empty((B, Q, 3, W), dtype=dt, device=rc0.device)
    outLs = torch.zeros((B, Q), dtype=dt, device=rc0.device)
    Qe = _last_row(qlen)
    for r in range(Qe):
        sv = shifts[:, r:r + 1]
        one = sv == 1
        one3 = one[:, :, None]
        Fd = torch.where(one3, F, _shr3(F))
        Fu = torch.where(one3, _shl3(F), F)
        rc_n = torch.where(one, torch.cat([rc[:, 1:], inc[:, r:r + 1]], 1),
                           rc)
        j_n = j + sv
        ok = (j_n >= 1) & (j_n <= tl)
        em = torch.where(ok, torch.gather(em5[:, :, r], 1, rc_n), 0.0)
        Mrow = em * (Fd * tM).sum(1)
        Irow = torch.where(j_n <= tl, ei[:, r:r + 1] * (Fu * tI).sum(1), 0.0)
        c = _shr(md * Mrow + id_ * Irow)
        Drow = torch.where(ok, _linrec(c, dd), 0.0)
        sc = (Mrow + Irow + Drow).sum(1, keepdim=True) + EPS
        live = (r + 1) <= ql
        F = torch.where(live[:, :, None],
                        torch.stack([Mrow, Irow, Drow], 1) / sc[:, :, None], F)
        j = torch.where(live, j_n, j)
        rc = torch.where(live, rc_n, rc)
        outF[:, r] = F
        outLs[:, r] = torch.where(live[:, 0], torch.log(sc[:, 0]), 0.0)
    outF[:, Qe:] = F[:, None]
    return (outF[:, :, 0].contiguous(), outF[:, :, 1].contiguous(),
            outF[:, :, 2].contiguous(), outLs)


def bwd_tables_plain(emis, shifts, inc, rcq, jq, bm0, bi0, bd0, qlen, tlen,
                     strand, trans, trans2):
    """Plain PyTorch version of the backward-tables kernel."""
    B, W = rcq.shape
    Q = shifts.shape[1]
    mm, mi, md, im, ii, id_, dm, di, dd = _trans_cols(strand, trans, trans2,
                                                      bm0.dtype)
    em5, ei = _emis_rows(emis, Q)
    tl = tlen[:, None]
    ql = qlen[:, None]
    bM, bI, bD, j = bm0, bi0, bd0, jq
    rc = rcq.to(torch.int64)
    inc = inc.to(torch.int64)
    dt = bm0.dtype
    outF = torch.empty((B, Q, 3, W), dtype=dt, device=rcq.device)
    outLs = torch.zeros((B, Q), dtype=dt, device=rcq.device)
    Qe = _last_row(qlen)
    outF[:, Qe:] = torch.stack([bM, bI, bD], 1)[:, None]
    for i in range(Qe - 1, -1, -1):
        sv = shifts[:, i:i + 1]
        one = sv == 1
        rc_i = torch.where(one, torch.cat([inc[:, i:i + 1], rc[:, :-1]], 1),
                           rc)
        j_i = j - sv
        em = torch.where(j_i + 1 <= tl, torch.gather(em5[:, :, i], 1, rc_i),
                         0.0)
        u = em * torch.where(one, bM, _shl(bM))
        v = ei[:, i:i + 1] * torch.where(one, _shr(bI), bI)
        bDrow = _linrec(dm * u + di * v, dd, rev=True)
        w = _shl(bDrow)
        ok = j_i <= tl
        bMrow = torch.where(ok, mm * u + mi * v + md * w, 0.0)
        bIrow = torch.where(ok, im * u + ii * v + id_ * w, 0.0)
        bDrow = torch.where(ok, bDrow, 0.0)
        sc = (bMrow + bIrow + bDrow).max(1, keepdim=True).values + EPS
        live = i < ql
        bM = torch.where(live, bMrow / sc, bM)
        bI = torch.where(live, bIrow / sc, bI)
        bD = torch.where(live, bDrow / sc, bD)
        rc = torch.where(live, rc_i, rc)
        j = torch.where(live, j_i, j)
        outF[:, i] = torch.stack([bM, bI, bD], 1)
        outLs[:, i] = torch.where(live[:, 0], torch.log(sc[:, 0]), 0.0)
    return (outF[:, :, 0].contiguous(), outF[:, :, 1].contiguous(),
            outF[:, :, 2].contiguous(), outLs)


def _launch_tables(kind, emis, shifts, inc, rc0, j0, m0, i0, d0, qlen, tlen,
                   strand, trans, trans2):
    B, W = rc0.shape
    Q = shifts.shape[1]
    dt_t = m0.dtype
    if dt_t not in (torch.float32, torch.float64):
        raise ValueError(f"{kind}_tables: expected float32 or float64 state, "
                         f"got {dt_t}")
    geometry = tables_geometry(W, f"{kind}_tables", dt_t)
    f32, i32 = torch.float32, torch.int32
    for t, name, dt, shape in (
            (emis, "emis", f32, (B, 5 * Q)), (shifts, "shifts", i32, (B, Q)),
            (inc, "inc", i32, (B, Q)), (rc0, "rc", i32, (B, W)),
            (j0, "j", i32, (B, W)), (m0, "M0", dt_t, (B, W)),
            (i0, "I0", dt_t, (B, W)), (d0, "D0", dt_t, (B, W)),
            (qlen, "qlen", i32, (B,)), (tlen, "tlen", i32, (B,)),
            (strand, "strand", i32, (B,)), (trans, "trans", f32, (8, 8)),
            (trans2, "trans2", f32, (8, 8))):
        check(t, dt, shape, f"{kind}_tables {name}", device=rc0.device)
    dev = rc0.device
    outM = torch.empty((B, Q, W), dtype=dt_t, device=dev)
    outI = torch.empty_like(outM)
    outD = torch.empty_like(outM)
    outLs = torch.empty((B, Q), dtype=dt_t, device=dev)
    entry = f"{kind}_tables{'64' if dt_t == torch.float64 else ''}_launch"
    launch("phmm_tables", entry, emis, shifts, inc, rc0, j0, m0, i0, d0,
           qlen, tlen, strand, trans, trans2, outM, outI, outD, outLs, B, Q,
           W, *geometry, scratch(B, W, dt_t, dev))
    return outM, outI, outD, outLs


def fwd_tables(emis, shifts, inc, rc0, j0, m0, i0, d0, qlen, tlen, strand,
               trans, trans2):
    """Forward tables of a batch of pairs.

    emis (B, 5Q) f32 = [me(A) | me(C) | me(G) | me(T) | ie] per row;
    shifts, inc (B, Q) int32; rc0, j0 (B, W) int32; m0, i0, d0 (B, W) f32
    row 0 (f32, or f64 for float64 tables); qlen, tlen, strand (B,) int32;
    trans, trans2 (8, 8) f32 padded transition tables (strand 1 selects
    trans2).  Returns M, I, D (B, Q, W) for rows 1..Q and log scales
    (B, Q), in m0's type."""
    if rc0.device.type == "cpu":
        return fwd_tables_plain(emis, shifts, inc, rc0, j0, m0, i0, d0, qlen,
                                tlen, strand, trans, trans2)
    out = _launch_tables("fwd", emis, shifts, inc, rc0, j0, m0, i0, d0, qlen,
                         tlen, strand, trans, trans2)
    FWD_LAUNCHES.add((rc0.shape[0], shifts.shape[1], rc0.shape[1],
                      _type_name(m0.dtype)))
    return out


def bwd_tables(emis, shifts, inc, rcq, jq, bm0, bi0, bd0, qlen, tlen, strand,
               trans, trans2):
    """Backward tables of a batch of pairs (rows Q-1..0 from the frozen init
    at row Q); same layout as :func:`fwd_tables` with the band chars and
    columns of row Q in place of row 0's."""
    if rcq.device.type == "cpu":
        return bwd_tables_plain(emis, shifts, inc, rcq, jq, bm0, bi0, bd0,
                                qlen, tlen, strand, trans, trans2)
    out = _launch_tables("bwd", emis, shifts, inc, rcq, jq, bm0, bi0, bd0,
                         qlen, tlen, strand, trans, trans2)
    BWD_LAUNCHES.add((rcq.shape[0], shifts.shape[1], rcq.shape[1],
                      _type_name(bm0.dtype)))
    return out


def _type_name(dtype) -> str:
    return "f64" if dtype == torch.float64 else "f32"


def _tables8(par):
    """PHMMParams -> padded (8, 8) trans, mat_emit, ins_emit numpy tables."""
    t = np.zeros((8, 8), np.float32)
    t[:3, :3] = _np(par.trans)
    me = np.zeros((8, 8), np.float32)
    me[:4, :4] = _np(par.mat_emit)
    ie = np.zeros((8, 8), np.float32)
    ie[:5, :4] = _np(par.ins_emit)
    return t, me, ie


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def prep_tables_inputs(qs, template, offsets, q_lens, t_len, params, W: int,
                       strands=None, params_rev=None, device=None):
    """Host-side prep of a batch of (read, template) pairs, moved to the
    device.  ``template`` is one (T,) array shared by the batch or per-pair
    (B, T) rows with ``t_len`` a (B,) vector.  Codes past q_len / t_len
    become 4; an in-length N (code 4) is scored as A.  ``strands`` (bool per
    read, True = forward) select ``params_rev`` for reverse reads."""
    from ..runtime import resolve
    dev = resolve(device)
    qs = np.asarray(qs)
    B, Qpad = qs.shape
    q_lens = np.asarray(q_lens, np.int64)
    template = np.asarray(template, np.int8)
    if template.ndim == 1:
        t_lens = np.full(B, int(t_len), np.int64)
        templates = np.broadcast_to(template, (B, len(template)))
    else:
        t_lens = np.asarray(t_len, np.int64)
        templates = template
    T = templates.shape[1]
    qc = np.where(np.arange(Qpad) < q_lens[:, None],
                  np.clip(qs, 0, 3), 4).astype(np.int32)
    rc = np.where(np.arange(T) < t_lens[:, None],
                  np.clip(templates, 0, 3), 4).astype(np.int32)
    trans, me8, ie8 = _tables8(params)
    trans2, me28, ie28 = _tables8(params_rev) if params_rev is not None \
        else (trans, me8, ie8)
    strand = np.zeros(B, np.int32)
    if strands is not None:
        # flag 1 selects the SECOND (reverse-strand) parameter set
        strand[:] = (~np.asarray(strands, bool)).astype(np.int32)

    def t(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=dev)

    return dict(qs=t(qc, torch.int32), r=t(rc, torch.int32),
                offs=t(np.asarray(offsets), torch.int64),
                q_lens=t(q_lens, torch.int64), t_lens=t(t_lens, torch.int64),
                strand=t(strand, torch.int32),
                trans=t(trans, torch.float32), me8=t(me8, torch.float32),
                ie8=t(ie8, torch.float32), trans2=t(trans2, torch.float32),
                me28=t(me28, torch.float32), ie28=t(ie28, torch.float32))


def kernel_inputs(prep, W: int, dtype=torch.float32, lk_init: bool = False):
    """The two table kernels' arguments for a prepared batch: (fwd_args,
    bwd_args, aux) — the emission streams, band streams, the closed-form
    forward row 0 and backward init, in ``dtype`` (float32, or float64 for
    the gradient's tables); ``aux`` keeps what stitching needs.

    The backward init is d(end-cell mass) / d(cell) at the last row; with
    ``lk_init`` it is d(end-cell mass + EPS * row mass) / d(cell), the
    backward of lk = log(fin + EPS) + fcum itself: where the end cell holds
    less than EPS of its row, lk is floored and its gradient is that of
    the row's whole mass (the gradient's tables)."""
    p = prep
    qs = p["qs"]
    B, Q = qs.shape
    dev = qs.device
    q_lens, t_lens = p["q_lens"], p["t_lens"]
    offs = p["offs"]
    sf = p["strand"].to(torch.float32)[:, None]
    tr1, tr2 = p["trans"], p["trans2"]
    tmd = ((1.0 - sf) * tr1[0, 2] + sf * tr2[0, 2]).to(dtype)
    tdd = ((1.0 - sf) * tr1[2, 2] + sf * tr2[2, 2]).to(dtype)
    tid = ((1.0 - sf) * tr1[1, 2] + sf * tr2[1, 2]).to(dtype)
    ks = torch.arange(W, dtype=torch.int64, device=dev)
    kf = ks.to(dtype)
    i32 = torch.int32
    shifts = (offs[:, 1:] - offs[:, :-1]).to(i32).contiguous()
    # r_pad[x] = 4 for x == 0, r[x-1] after (front sentinel); r_pad2[x] =
    # r[x] (the char of column x+1); both padded with 4s
    pad_tail = torch.full((B, W + Q + 3), 4, dtype=i32, device=dev)
    four = torch.full((B, 1), 4, dtype=i32, device=dev)
    r_pad = torch.cat([four, p["r"], pad_tail], 1)
    r_pad2 = torch.cat([p["r"], pad_tail, four], 1)
    inc_f = torch.gather(r_pad, 1, offs[:, 1:] + W - 1).contiguous()
    j0 = offs[:, :1] + ks[None]
    rc0 = torch.gather(r_pad, 1, j0).contiguous()
    tl_col = t_lens[:, None]
    # forward row 0 (closed form: M at j = 0, D chain along the row)
    M0 = (j0 == 0).to(dtype)
    logtdd = torch.log(torch.clamp(tdd, min=1e-30))
    D0 = torch.where(ks[None] >= 1,
                     tmd * torch.exp(logtdd * torch.clamp(kf[None] - 1, min=0)),
                     0.0) * (j0 <= tl_col)
    D0 = torch.where(j0 >= 1, D0, 0.0)
    if dtype == torch.float64:
        # the gradient's tables run per shard of a batch
        # (:mod:`jtk_tpu_torch.parallel`): a pair's row 0 must not depend
        # on how many pairs share the launch
        s0 = _tree_row_sum(M0) + _tree_row_sum(D0) + EPS
    else:
        s0 = M0.sum(1, keepdim=True) + D0.sum(1, keepdim=True) + EPS
    M0n = (M0 / s0).contiguous()
    D0n = (D0 / s0).contiguous()
    I0n = torch.zeros_like(M0n)
    qlp = q_lens.to(i32).contiguous()
    tlp = t_lens.to(i32).contiguous()
    strand = p["strand"].contiguous()
    # per-row emission streams: stream v < 4 at row x = emit(ref v, q[x]),
    # stream 4 = ins_emit(q[x-1], q[x]); strand selection folded in here
    me_mix = (1.0 - sf) * p["me8"].reshape(1, -1) + sf * p["me28"].reshape(1, -1)
    ie_mix = (1.0 - sf) * p["ie8"].reshape(1, -1) + sf * p["ie28"].reshape(1, -1)
    qcq = qs.clamp(0, 3).to(torch.int64)
    qpv = torch.cat([four, qs[:, :-1]], 1).clamp(0, 4).to(torch.int64)
    emis = torch.cat(
        [torch.gather(me_mix, 1, r * 8 + qcq) for r in range(4)]
        + [torch.gather(ie_mix, 1, qpv * 8 + qcq)], 1).contiguous()
    # backward init at the frozen row (offsets beyond q_len are constant)
    bidx = torch.arange(B, device=dev)
    offQ = offs[bidx, q_lens]
    jQ = offQ[:, None] + ks[None]
    kT = (t_lens - offQ)[:, None].to(dtype)
    bD0 = torch.where(kf[None] <= kT,
                      torch.exp(logtdd * torch.clamp(kT - kf[None], min=0)),
                      0.0)
    bD_next = torch.cat([bD0[:, 1:], torch.zeros((B, 1), dtype=dtype,
                                                 device=dev)], 1)
    bM0 = torch.where(kf[None] == kT, 1.0, tmd * bD_next)
    bI0 = torch.where(kf[None] == kT, 1.0, tid * bD_next)
    valid = jQ <= tl_col
    if lk_init:
        # every cell of the row: a path ends there, or goes on along the
        # Del chain (the valid lanes are a prefix, j <= t_len)
        aD = _linrec(valid.to(dtype), tdd, rev=True)
        aD_next = _shl(aD)
        bM0 = bM0 + EPS * (1.0 + tmd * aD_next)
        bI0 = bI0 + EPS * (1.0 + tid * aD_next)
        bD0 = bD0 + EPS * aD
    bM0 = torch.where(valid, bM0, 0.0)
    bI0 = torch.where(valid, bI0, 0.0)
    bD0 = torch.where(valid, bD0, 0.0)
    sI = (bM0 + bI0 + bD0).max(1, keepdim=True).values + EPS
    bM0n = (bM0 / sI).contiguous()
    bI0n = (bI0 / sI).contiguous()
    bD0n = (bD0 / sI).contiguous()
    inc_b = torch.gather(r_pad2, 1, offs[:, :-1].clamp(min=0)).contiguous()
    rcq = torch.gather(r_pad2, 1, offs[:, -1:] + ks[None]).contiguous()
    jq = (offs[:, -1:] + ks[None]).to(i32).contiguous()
    fwd_args = (emis, shifts, inc_f, rc0, j0.to(i32).contiguous(), M0n, I0n,
                D0n, qlp, tlp, strand, tr1, tr2)
    bwd_args = (emis, shifts, inc_b, rcq, jq, bM0n, bI0n, bD0n, qlp, tlp,
                strand, tr1, tr2)
    aux = dict(r_pad=r_pad, offQ=offQ, ls0=torch.log(s0[:, 0]),
               lsI=torch.log(sI[:, 0]))
    return fwd_args, bwd_args, aux


def tables_batch(prep, W: int, backward: bool = True,
                 dtype=torch.float32, lk_init: bool = False):
    """Both table passes + stitching for a prepared batch, in ``dtype``
    (float32; float64 only for the gradient, :mod:`.phmm_grad`, which also
    asks for the backward of lk itself, ``lk_init``: see
    :func:`kernel_inputs`).

    Returns (lk (B,), (fM, fI, fD) (B, Q+1, W), fcum (B, Q+1),
    rcs (B, Q+1, W), (bM, bI, bD), bcum, offs); the backward members are
    None when ``backward`` is False."""
    fwd_args, bwd_args, aux = kernel_inputs(prep, W, dtype, lk_init)
    q_lens, t_lens, offs = prep["q_lens"], prep["t_lens"], prep["offs"]
    B, Q = prep["qs"].shape
    dev = offs.device
    bidx = torch.arange(B, device=dev)
    ks = torch.arange(W, dtype=torch.int64, device=dev)
    M0n, I0n, D0n = fwd_args[5:8]
    fM_r, fI_r, fD_r, f_ls = fwd_tables(*fwd_args)
    fM = torch.cat([M0n[:, None], fM_r], 1)
    fI = torch.cat([I0n[:, None], fI_r], 1)
    fD = torch.cat([D0n[:, None], fD_r], 1)
    del fM_r, fI_r, fD_r
    fcum = torch.cumsum(torch.cat([aux["ls0"][:, None], f_ls], 1), 1)
    k_end = (t_lens - aux["offQ"]).clamp(0, W - 1)
    fin = fM[bidx, q_lens, k_end] + fI[bidx, q_lens, k_end] \
        + fD[bidx, q_lens, k_end]
    lk = torch.log(fin + EPS) + fcum[bidx, q_lens]
    rcs = torch.gather(aux["r_pad"], 1, (offs[:, :, None] + ks[None, None])
                       .reshape(B, -1)).reshape(B, Q + 1, W)
    if not backward:
        return lk, (fM, fI, fD), fcum, rcs, None, None, offs
    bM0n, bI0n, bD0n = bwd_args[5:8]
    bM_r, bI_r, bD_r, b_ls = bwd_tables(*bwd_args)
    bM = torch.cat([bM_r, bM0n[:, None]], 1)
    bI = torch.cat([bI_r, bI0n[:, None]], 1)
    bD = torch.cat([bD_r, bD0n[:, None]], 1)
    del bM_r, bI_r, bD_r
    bM[bidx, q_lens] = bM0n
    bI[bidx, q_lens] = bI0n
    bD[bidx, q_lens] = bD0n
    b_lss = torch.cat([b_ls, torch.zeros((B, 1), dtype=dtype, device=dev)],
                      1)
    b_lss[bidx, q_lens] = aux["lsI"]
    bcum = torch.flip(torch.cumsum(torch.flip(b_lss, [1]), 1), [1])
    return lk, (fM, fI, fD), fcum, rcs, (bM, bI, bD), bcum, offs


def tables_from_arrays(qs, template, offsets, q_lens, t_len, params, W: int,
                       device=None):
    """Counterpart of ``pallas_phmm.pallas_tables_batch``: (lk, (fM, fI,
    fD), fcum, rcs, (bM, bI, bD), bcum) for numpy inputs, shaped like the
    batched ``phmm.forward_banded`` / ``backward_banded`` outputs."""
    prep = prep_tables_inputs(qs, template, offsets, q_lens, t_len, params,
                              W, device=device)
    lk, f_tabs, fcum, rcs, b_tabs, bcum, _offs = tables_batch(prep, W)
    return lk, f_tabs, fcum, rcs, b_tabs, bcum
