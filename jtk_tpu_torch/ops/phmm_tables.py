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
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_build import Launches, check, launch

EPS = 1e-30

FWD_LAUNCHES = Launches("fwd_tables")
BWD_LAUNCHES = Launches("bwd_tables")

MAX_W = 2048            # 8 x 256, the widest band ``band_buckets`` reaches
MAX_LANES = 4           # band lanes a thread keeps in registers


def tables_geometry(W: int, kernel: str = "tables") -> tuple[int, int, int]:
    """Launch geometry of the table kernels, and of K1l (``csrc/phmm_lk.cu``),
    for band width ``W``: (lanes per thread, warps per pair, pairs per
    block).  A thread holds
    up to MAX_LANES lanes (the cost of a row is the instructions one
    thread issues, so wide bands take more warps, 1 to 16, rather than more
    lanes); a block holds 4 warps, or one pair of more.  Both counts are
    powers of two (the kernels are built for those)."""
    if not 1 <= W <= MAX_W:
        raise ValueError(f"{kernel}: band width {W} outside 1..{MAX_W}")
    lanes = 1
    while lanes < MAX_LANES and 32 * lanes < W:
        lanes *= 2
    warps = 1
    while 32 * lanes * warps < W:
        warps *= 2
    return lanes, warps, max(1, 4 // warps)


def _shr(x, n=1):
    """x[:, k] -> x[:, k-n] (0 fill)."""
    return torch.nn.functional.pad(x[:, :-n], (n, 0))


def _shl(x, n=1):
    """x[:, k] -> x[:, k+n] (0 fill)."""
    return torch.nn.functional.pad(x[:, n:], (0, n))


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


def _trans_cols(strand, trans, trans2):
    """Per-pair strand-selected transitions: 9 (B, 1) columns in the order
    mm, mi, md, im, ii, id, dm, di, dd."""
    sel = (strand > 0)[:, None]
    return [torch.where(sel, trans2[a, b], trans[a, b])
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
    mm, mi, md, im, ii, id_, dm, di, dd = _trans_cols(strand, trans, trans2)
    tM = torch.stack([mm, im, dm], 1)          # (B, 3, 1) into M
    tI = torch.stack([mi, ii, di], 1)          # (B, 3, 1) into I
    em5, ei = _emis_rows(emis, Q)
    tl = tlen[:, None]
    ql = qlen[:, None]
    F = torch.stack([m0, i0, d0], 1)
    j, rc = j0, rc0.to(torch.int64)
    inc = inc.to(torch.int64)
    outF = torch.empty((B, Q, 3, W), dtype=torch.float32, device=rc0.device)
    outLs = torch.zeros((B, Q), dtype=torch.float32, device=rc0.device)
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
    mm, mi, md, im, ii, id_, dm, di, dd = _trans_cols(strand, trans, trans2)
    em5, ei = _emis_rows(emis, Q)
    tl = tlen[:, None]
    ql = qlen[:, None]
    bM, bI, bD, j = bm0, bi0, bd0, jq
    rc = rcq.to(torch.int64)
    inc = inc.to(torch.int64)
    outF = torch.empty((B, Q, 3, W), dtype=torch.float32, device=rcq.device)
    outLs = torch.zeros((B, Q), dtype=torch.float32, device=rcq.device)
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
    geometry = tables_geometry(W)
    f32, i32 = torch.float32, torch.int32
    for t, name, dt, shape in (
            (emis, "emis", f32, (B, 5 * Q)), (shifts, "shifts", i32, (B, Q)),
            (inc, "inc", i32, (B, Q)), (rc0, "rc", i32, (B, W)),
            (j0, "j", i32, (B, W)), (m0, "M0", f32, (B, W)),
            (i0, "I0", f32, (B, W)), (d0, "D0", f32, (B, W)),
            (qlen, "qlen", i32, (B,)), (tlen, "tlen", i32, (B,)),
            (strand, "strand", i32, (B,)), (trans, "trans", f32, (8, 8)),
            (trans2, "trans2", f32, (8, 8))):
        check(t, dt, shape, f"{kind}_tables {name}")
    dev = rc0.device
    outM = torch.empty((B, Q, W), dtype=f32, device=dev)
    outI = torch.empty_like(outM)
    outD = torch.empty_like(outM)
    outLs = torch.empty((B, Q), dtype=f32, device=dev)
    launch("phmm_tables", f"{kind}_tables_launch", emis, shifts, inc, rc0,
           j0, m0, i0, d0, qlen, tlen, strand, trans, trans2, outM, outI,
           outD, outLs, B, Q, W, *geometry)
    return outM, outI, outD, outLs


def fwd_tables(emis, shifts, inc, rc0, j0, m0, i0, d0, qlen, tlen, strand,
               trans, trans2):
    """Forward tables of a batch of pairs.

    emis (B, 5Q) f32 = [me(A) | me(C) | me(G) | me(T) | ie] per row;
    shifts, inc (B, Q) int32; rc0, j0 (B, W) int32; m0, i0, d0 (B, W) f32
    row 0; qlen, tlen, strand (B,) int32; trans, trans2 (8, 8) f32 padded
    transition tables (strand 1 selects trans2).
    Returns M, I, D (B, Q, W) f32 for rows 1..Q and log scales (B, Q)."""
    if rc0.device.type == "cpu":
        return fwd_tables_plain(emis, shifts, inc, rc0, j0, m0, i0, d0, qlen,
                                tlen, strand, trans, trans2)
    out = _launch_tables("fwd", emis, shifts, inc, rc0, j0, m0, i0, d0, qlen,
                         tlen, strand, trans, trans2)
    FWD_LAUNCHES.add((rc0.shape[0], shifts.shape[1], rc0.shape[1]))
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
    BWD_LAUNCHES.add((rcq.shape[0], shifts.shape[1], rcq.shape[1]))
    return out


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


def kernel_inputs(prep, W: int):
    """The two table kernels' arguments for a prepared batch: (fwd_args,
    bwd_args, aux) — the emission streams, band streams, the closed-form
    forward row 0 and backward init; ``aux`` keeps what stitching needs."""
    p = prep
    qs = p["qs"]
    B, Q = qs.shape
    dev = qs.device
    q_lens, t_lens = p["q_lens"], p["t_lens"]
    offs = p["offs"]
    sf = p["strand"].to(torch.float32)[:, None]
    tr1, tr2 = p["trans"], p["trans2"]
    tmd = (1.0 - sf) * tr1[0, 2] + sf * tr2[0, 2]
    tdd = (1.0 - sf) * tr1[2, 2] + sf * tr2[2, 2]
    tid = (1.0 - sf) * tr1[1, 2] + sf * tr2[1, 2]
    ks = torch.arange(W, dtype=torch.int64, device=dev)
    kf = ks.to(torch.float32)
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
    M0 = (j0 == 0).to(torch.float32)
    logtdd = torch.log(torch.clamp(tdd, min=1e-30))
    D0 = torch.where(ks[None] >= 1,
                     tmd * torch.exp(logtdd * torch.clamp(kf[None] - 1, min=0)),
                     0.0) * (j0 <= tl_col)
    D0 = torch.where(j0 >= 1, D0, 0.0)
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
    kT = (t_lens - offQ)[:, None].to(torch.float32)
    bD0 = torch.where(kf[None] <= kT,
                      torch.exp(logtdd * torch.clamp(kT - kf[None], min=0)),
                      0.0)
    bD_next = torch.cat([bD0[:, 1:], torch.zeros((B, 1), device=dev)], 1)
    bM0 = torch.where(kf[None] == kT, 1.0, tmd * bD_next)
    bI0 = torch.where(kf[None] == kT, 1.0, tid * bD_next)
    valid = jQ <= tl_col
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


def tables_batch(prep, W: int, backward: bool = True):
    """Both table passes + stitching for a prepared batch.

    Returns (lk (B,), (fM, fI, fD) (B, Q+1, W), fcum (B, Q+1),
    rcs (B, Q+1, W), (bM, bI, bD), bcum, offs); the backward members are
    None when ``backward`` is False."""
    fwd_args, bwd_args, aux = kernel_inputs(prep, W)
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
    b_lss = torch.cat([b_ls, torch.zeros((B, 1), device=dev)], 1)
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
