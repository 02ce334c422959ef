"""K2 — modification table: LK(read | 1-edit of template) for every edit.

Counterpart of ``jtk_tpu/ops/modtable.py`` (see its docstring for the
closed forms).  The banded forward/backward tables come from the K1
kernels (:mod:`jtk_tpu_torch.ops.phmm_tables`); the closed-form assembly
below is batched PyTorch over pairs with per-pair (strand-selected)
parameters, and the band-to-column sums are scatter-free (row cumsum +
boundary gather + a strided diagonal sum), so they are deterministic.

Output layout per pair: (Tpad+1, 14) with columns
[sub A,C,G,T | ins A,C,G,T | copy len 1..3 | del len 1..3]; row j holds
sub/del/copy at template position j and ins-before-position j.
Copy edits of length >= 2 drop query insertions between the copied columns
— the reference's deliberate approximation, kept as is.

The two engines run their pair slices (:func:`_slices`) over the device set
(:func:`jtk_tpu_torch.runtime.devices`): slice i on entry i mod n, each
whole, so every launch has the shape it has on one device, and the
per-slice results are merged on the primary in slice order, as one device
merges them.  (``jtk_tpu`` splits the rows inside a slice instead; in the
port that would change the launches' batch sizes with the device count.)
"""

from __future__ import annotations

import collections
import logging
import time

import numpy as np
import torch

from .phmm import EPS, PHMMParams, _np
from .phmm_tables import prep_tables_inputs, tables_batch

logger = logging.getLogger(__name__)

COPY_SIZE = 3
DEL_SIZE = 3
NUM_EDIT = 8 + COPY_SIZE + DEL_SIZE  # 4 sub + 4 ins + copies + dels = 14
MAXB = 192           # pairs per fused slice at W <= 256
POS_THR_DEV = 1e-5   # == ops.cluster.POS_THR (variant-support threshold)
# engine calls by their number of slices (how many could use a device set)
SLICE_CALLS: collections.Counter = collections.Counter()


def _shl2(tab, fill=0.0):
    """index k reads old k+1 along the lane axis (last)."""
    return torch.cat([tab[..., 1:],
                      torch.full_like(tab[..., :1], fill)], -1)


def _shr2(tab, fill=0.0):
    """index k reads old k-1 along the lane axis (last)."""
    return torch.cat([torch.full_like(tab[..., :1], fill),
                      tab[..., :-1]], -1)


def _row_shift_unit(tab, one_col, minus: bool):
    """tab[b, i, k] -> tab[b, i, k + s_i - (1 if minus else 0)], s_i in
    {0, 1}; one_col is (B, Q+1, 1) bool (s_i == 1)."""
    if minus:
        return torch.where(one_col, tab, _shr2(tab))
    return torch.where(one_col, _shl2(tab), tab)


def _diag_sum(G):
    """out[b, j] = sum_k G[b, j-k, k] (rows before 0 read as 0)."""
    B, T1, W = G.shape
    Gp = torch.cat([torch.zeros((B, W, W), dtype=G.dtype, device=G.device),
                    G], 1)
    Gf = torch.flip(Gp, [2]).contiguous()
    # Gf[b, r, k'] = G[b, r - W, W-1-k']: out[j] = sum_k' Gf[b, j+1+k', k']
    view = Gf.as_strided((B, T1, W), (Gf.stride(0), W, W + 1),
                         Gf.storage_offset() + W)
    return view.sum(-1)


def modification_table_from_tables(q, offsets, q_len, t_len, trans, mat_emit,
                                   W: int, Tpad: int, lk, f_tabs, fcum, rcs,
                                   b_tabs, bcum):
    """The closed-form edit-table assembly for a batch of pairs from their
    banded forward/backward tables.

    q (B, Q) codes; offsets (B, Q+1); q_len, t_len (B,); trans (B, 3, 3)
    and mat_emit (B, 4, 4) per-pair parameters; tables (B, Q+1, W).
    Returns (lk (B,), log-LK table (B, Tpad+1, NUM_EDIT)); invalid positions
    hold -1e30."""
    B, Q = q.shape
    dev = q.device
    fM, fI, fD = f_tabs
    bM, bI, bD = b_tabs
    f32 = torch.float32

    def tc(a, b):
        return trans[:, a, b].view(B, 1, 1)

    tmm, tmi, tmd = tc(0, 0), tc(0, 1), tc(0, 2)
    tim, tid = tc(1, 0), tc(1, 2)
    tdm, tdd = tc(2, 0), tc(2, 2)
    me_pad = torch.zeros((B, 5, 5), dtype=f32, device=dev)
    me_pad[:, :4, :4] = mat_emit
    offsets = offsets.to(torch.int64)
    q_len = q_len.to(torch.int64)
    t_len = t_len.to(torch.int64)
    ks = torch.arange(W, dtype=torch.int64, device=dev)
    rows = torch.arange(Q + 1, dtype=torch.int64, device=dev)
    bidx = torch.arange(B, device=dev)
    jc = offsets[:, :, None] + ks                       # (B, Q+1, W)
    live_row = (rows[None] <= q_len[:, None])[..., None]
    s = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                   offsets[:, 1:] - offsets[:, :-1]], 1)
    one_col = (s == 1)[..., None]
    zrow = torch.zeros((B, 1, W), dtype=f32, device=dev)

    def prev_row(tab):
        return torch.cat([zrow, tab[:, :-1]], 1)

    # previous-row tables aligned to current rows: f*(i-1, jc-1), f*(i-1, jc)
    fMp, fIp, fDp = prev_row(fM), prev_row(fI), prev_row(fD)
    A = (tmm * _row_shift_unit(fMp, one_col, True)
         + tim * _row_shift_unit(fIp, one_col, True)
         + tdm * _row_shift_unit(fDp, one_col, True))      # arrive in M at jc
    Anext = (tmm * _row_shift_unit(fMp, one_col, False)
             + tim * _row_shift_unit(fIp, one_col, False)
             + tdm * _row_shift_unit(fDp, one_col, False))  # at inserted col
    del fMp, fIp, fDp
    Dnew = tmd * _shr2(fM) + tid * _shr2(fI) + tdd * _shr2(fD)
    Dnext = tmd * fM + tid * fI + tdd * fD

    # row-scale corrections: A-terms use fcum[i-1]+bcum[i], fD/Dnext-terms
    # fcum[i]+bcum[i]; all are ~lk, so shift by lk
    lkc = lk[:, None]
    neg_inf = torch.full((B, 1), -np.inf, dtype=f32, device=dev)
    fcum_p = torch.cat([neg_inf, fcum[:, :-1]], 1)

    def cscale(fc):
        c = torch.exp(torch.clamp(fc + bcum - lkc, -80.0, 80.0))[..., None]
        return torch.where(live_row, c, 0.0)

    cA = cscale(fcum_p)
    cB = cscale(fcum)

    # per-row query emission row: em_q5[b, i, v] = me[v, q[i-1]]
    qprev = torch.cat([torch.full((B, 1), 4, dtype=torch.int64, device=dev),
                       q.to(torch.int64)], 1)
    em_q5 = torch.gather(me_pad.transpose(1, 2), 1,
                         qprev[..., None].expand(B, Q + 1, 5))
    em_q5 = em_q5 * (rows >= 1)[None, :, None]
    em_q = em_q5[..., :4]

    valid = (jc >= 0) & (jc <= t_len[:, None, None])
    o_vals = torch.arange(Tpad + 1, dtype=torch.int64, device=dev) \
        .expand(B, Tpad + 1).contiguous()
    offs_c = offsets.contiguous()
    hi = torch.searchsorted(offs_c, o_vals, right=True)[..., None] \
        .expand(B, Tpad + 1, W)
    lo = torch.searchsorted(offs_c, o_vals, right=False)[..., None] \
        .expand(B, Tpad + 1, W)
    zc = torch.zeros((B, 1, W), dtype=f32, device=dev)

    def colsum(x):
        """sum over band cells of each template column jc -> (B, Tpad+1):
        rows sharing an offset are contiguous, so G[o, k] is a difference
        of row cumsums, then out[j] = sum_k G[j-k, k]."""
        C = torch.cat([zc, torch.cumsum(torch.where(valid, x, 0.0), 1)], 1)
        G = torch.gather(C, 1, hi) - torch.gather(C, 1, lo)
        return _diag_sum(G)

    def em_of(rc_codes):
        return torch.gather(em_q5, 2, rc_codes.to(torch.int64))

    # --- substitutions ---
    AbM = A * bM * cA
    sub_cols = [colsum(em_q[..., b:b + 1] * AbM) for b in range(4)]
    del AbM
    sub_base = colsum(fD * bD * cB)
    # --- deletions of t[j..j+d], d = 1..DEL_SIZE (jc = j+1) ---
    del_cols = []
    lk_del_last = []
    bM_d, bD_d, rc_d = bM, bD, rcs
    qcol = q_len[:, None]
    off_q = offsets[bidx, q_len]
    for d in range(1, DEL_SIZE + 1):
        bM_d = _shl2(bM_d)
        bD_d = _shl2(bD_d)
        rc_d = _shl2(rc_d, fill=4)
        term = em_of(rc_d) * A * bM_d * cA + Dnew * bD_d * cB
        del_cols.append(colsum(term))
        # deleting a block that ends the template: f-sum at (q_len, t_len-d)
        k_last = (t_len - d - off_q).clamp(0, W - 1)
        f_last = (fM[bidx, q_len, k_last] + fI[bidx, q_len, k_last]
                  + fD[bidx, q_len, k_last])
        lk_del_last.append(torch.log(f_last + EPS)
                           + torch.gather(fcum, 1, qcol)[:, 0])
    del bM_d, bD_d, rc_d, Dnew
    # --- insertion before position j (jc = j) ---
    AnbM = Anext * bM * cA
    ins_cols = [colsum(em_q[..., b:b + 1] * AnbM) for b in range(4)]
    del AnbM
    ins_base = colsum(Dnext * bD * cB)
    # --- tandem copies of t[j..j+c], anchored at column J = j + c ---
    # bucket u of consumed query chars joins fcum[i-u] with bcum[i]
    cU = [cB, cA]
    fcum_u = fcum_p
    for _u in range(2, COPY_SIZE + 1):
        fcum_u = torch.cat([neg_inf, fcum_u[:, :-1]], 1)
        cU.append(cscale(fcum_u))

    def row_down(tab):
        """value at (i, k) = tab(i-1, k + s_i)."""
        return _row_shift_unit(prev_row(tab), one_col, False)

    copy_cols = []
    for c in range(1, COPY_SIZE + 1):
        Mb: dict = {}
        Db: dict = {}
        for m in range(1, c + 1):
            rc_m = rcs
            for _ in range(c - m):
                rc_m = _shr2(rc_m, fill=4)
            em_m = em_of(rc_m)
            if m == 1:
                Mb = {1: em_m * Anext}
                Db = {0: Dnext}
            else:
                newM: dict = {}
                for u, tab in Mb.items():
                    newM[u + 1] = newM.get(u + 1, 0.0) + tmm * row_down(tab)
                for u, tab in Db.items():
                    newM[u + 1] = newM.get(u + 1, 0.0) + tdm * row_down(tab)
                newM = {u: em_m * tab for u, tab in newM.items()}
                newD = {u: tmd * Mb.get(u, 0.0) + tdd * Db.get(u, 0.0)
                        for u in set(Mb) | set(Db)}
                Mb, Db = newM, newD
        term = 0.0
        for u, tab in Mb.items():
            term = term + tab * bM * cU[u]
        for u, tab in Db.items():
            term = term + tab * bD * cU[u]
        copy_cols.append(colsum(term))
    T1 = Tpad + 1
    # sub at position j corresponds to jc = j+1 -> shift by one
    sub_tab = torch.stack(sub_cols, 2) + sub_base[..., None]
    sub_tab = torch.cat([sub_tab[:, 1:], torch.zeros((B, 1, 4), device=dev)],
                        1)
    ins_tab = torch.stack(ins_cols, 2) + ins_base[..., None]
    del_arrs = [torch.cat([h[:, 1:], torch.zeros((B, 1), device=dev)], 1)
                for h in del_cols]
    copy_arrs = [torch.cat([h[:, c + 1:],
                            torch.zeros((B, c + 1), device=dev)], 1)
                 for c, h in enumerate(copy_cols)]
    table = torch.cat([sub_tab, ins_tab, torch.stack(copy_arrs, 2),
                       torch.stack(del_arrs, 2)], 2)
    ltable = torch.log(torch.clamp(table, min=EPS)) + lk[:, None, None]
    pos = torch.arange(T1, dtype=torch.int64, device=dev)[None]
    tl = t_len[:, None]
    for d in range(1, DEL_SIZE + 1):
        ci = 8 + COPY_SIZE + d - 1
        ltable[:, :, ci] = torch.where(pos == tl - d,
                                       lk_del_last[d - 1][:, None],
                                       ltable[:, :, ci])
    mask = torch.cat(
        [(pos < tl)[..., None].expand(B, T1, 4),
         (pos <= tl)[..., None].expand(B, T1, 4)]
        + [(pos + c <= tl)[..., None] for c in range(1, COPY_SIZE + 1)]
        + [(pos + d <= tl)[..., None] for d in range(1, DEL_SIZE + 1)], 2)
    ltable = torch.where(mask, ltable, -1e30)
    return lk, ltable


def _modtable_slice(qs, tpl, offs, q_lens, t_len, params, W: int, Tpad: int,
                    strands, params_rev, device=None):
    """Both table passes + the assembly for one slice of pairs on
    ``device``, with per-pair strand-selected parameters (reverse-strand
    reads are scored with the reverse-strand HMM)."""
    prep = prep_tables_inputs(qs, tpl, offs, q_lens, t_len, params, W,
                              strands=strands, params_rev=params_rev,
                              device=device)
    lk, f_tabs, fcum, rcs, b_tabs, bcum, offs_t = tables_batch(prep, W)
    sf = prep["strand"].to(torch.float32)[:, None, None]
    trans_b = (1.0 - sf) * prep["trans"][:3, :3] + sf * prep["trans2"][:3, :3]
    me_b = (1.0 - sf) * prep["me8"][:4, :4] + sf * prep["me28"][:4, :4]
    return modification_table_from_tables(
        prep["qs"], offs_t, prep["q_lens"], prep["t_lens"], trans_b, me_b, W,
        Tpad, lk, f_tabs, fcum, rcs, b_tabs, bcum)


def _slices(n: int, W: int):
    """Pair slices bounding the O(B * Q * W) tables in device memory: the
    cap scales inversely with the band."""
    cap = max(16, min(MAXB, (MAXB * 256 // W) // 8 * 8))
    return [slice(s, min(n, s + cap)) for s in range(0, n, cap)]


def _slice_inputs(tpl, t_len, strands, sl):
    tpl_s = tpl if tpl.ndim == 1 else tpl[sl]
    tl_s = t_len if np.ndim(t_len) == 0 else np.asarray(t_len)[sl]
    st_s = None if strands is None else np.asarray(strands)[sl]
    return tpl_s, tl_s, st_s


def _host_params(p):
    """PHMMParams as numpy tables (read back once, not in a slice's prep)."""
    return None if p is None else PHMMParams(*(_np(x) for x in p))


def _device_slices(n: int, W: int):
    """The primary and (entry, device, slice) of each pair slice, slice i
    on entry i mod the device set's size; counts the call in
    SLICE_CALLS."""
    from ..runtime import devices
    devs = devices()
    slices = _slices(n, W)
    SLICE_CALLS[len(slices)] += 1
    return devs[0], [(i % len(devs), devs[i % len(devs)], sl)
                     for i, sl in enumerate(slices)]


def modification_table_pileup_pallas(qs, tpl, offs, q_lens, t_len, params,
                                     W: int, Tpad: int, strands=None,
                                     params_rev=None, seg_ids=None,
                                     n_seg=None, sparse_k=None,
                                     min_gain=0.0, finish=True):
    """Modification tables of a pileup (counterpart of the JAX package's
    production engine of the same name).

    ``tpl`` is one template (T,) with scalar ``t_len`` or per-pair templates
    (B, T) with a (B,) ``t_len``.  Returns (lk numpy (B,), tables numpy
    (B, Tpad+1, NUM_EDIT)); with ``seg_ids``/``n_seg`` the per-pair gains
    are summed per segment on the device instead and the second result is
    the dense totals (numpy), a :class:`SparseGains` (``sparse_k``), or —
    with ``finish=False`` — the tensor of totals on the primary."""
    from ..parallel import on_entry
    # the band is rounded up to a multiple of 128, as in the production
    # engine of the JAX package (the extra lanes only add paths)
    W = ((int(W) + 127) // 128) * 128
    tpl = np.asarray(tpl)
    tpl = tpl[:Tpad] if tpl.ndim == 1 else tpl[:, :Tpad]
    qs = np.asarray(qs)
    offs = np.asarray(offs)
    q_lens = np.asarray(q_lens, np.int32)
    params, params_rev = _host_params(params), _host_params(params_rev)
    reduce = seg_ids is not None
    lks, tabs, totals = [], [], None
    primary, parts = _device_slices(qs.shape[0], W)
    for entry, dev, sl in parts:
        tpl_s, tl_s, st_s = _slice_inputs(tpl, t_len, strands, sl)
        with on_entry(entry):
            lk, tab = _modtable_slice(qs[sl], tpl_s, offs[sl], q_lens[sl],
                                      tl_s, params, W, Tpad, st_s,
                                      params_rev, device=dev)
            lks.append(lk)
            if reduce:
                seg = torch.as_tensor(np.asarray(seg_ids)[sl],
                                      dtype=torch.int64, device=dev)
                tot = _gain_segments(lk, tab, seg, n_seg).to(primary)
                totals = tot if totals is None else totals + tot
            else:
                tabs.append(tab)
    lk_all = torch.cat([lk.to(primary) for lk in lks]).cpu().numpy() \
        if lks else np.zeros(0, np.float32)
    tabs = [tab.cpu().numpy() for tab in tabs]
    if reduce:
        if not finish:
            return lk_all, totals
        return lk_all, finish_gains(totals, n_seg, sparse_k, min_gain)
    return lk_all, np.concatenate(tabs)


class SparseGains:
    """Top-k edit-gain candidates per template (host arrays, desc by gain)
    with the dense totals kept on the device for templates whose
    above-min_gain candidate count exceeds k (``dense_row(i)`` fetches that
    row only)."""

    def __init__(self, vals, idx, ev, counts, dense_dev):
        self.vals = vals
        self.idx = idx
        self.ev = ev
        self.counts = counts
        self._dense_dev = dense_dev

    @property
    def k(self):
        return self.vals.shape[1]

    def dense_row(self, i):
        return self._dense_dev[i].cpu().numpy().astype(np.float64)


def finish_gains(tot_dev, n_seg, sparse_k, min_gain):
    """Materialize accumulated device gain totals: dense (numpy float64),
    or as SparseGains when ``sparse_k`` is set."""
    if sparse_k is None:
        return tot_dev.cpu().numpy().astype(np.float64)[:n_seg]
    vals, idx, ev, counts = _topk_gain(tot_dev, float(min_gain),
                                       int(sparse_k))
    return SparseGains(vals.cpu().numpy()[:n_seg], idx.cpu().numpy()[:n_seg],
                       ev.cpu().numpy()[:n_seg], counts.cpu().numpy()[:n_seg],
                       tot_dev)


def _segsum_matmul(x, seg, n_rows: int):
    """Segment sum over the leading axis as an fp32 one-hot matmul (full
    fp32: TF32 is off for the port).  Float index_add_/scatter_add_ on the
    card would add in an order that changes from run to run."""
    B = x.shape[0]
    oh = (seg[None, :] == torch.arange(n_rows, device=x.device)[:, None]) \
        .to(torch.float32)
    out = oh @ x.reshape(B, -1)
    return out.reshape((n_rows,) + tuple(x.shape[1:]))


def _gain_segments(lk, tab, seg, n_seg: int):
    """Per-pair gain (tab - lk, masked entries pinned at -1e30) summed per
    template segment on the device: (n_seg, Tpad+1, NUM_EDIT)."""
    gain = torch.where(tab < -1e29, -1e30, tab - lk[:, None, None])
    return _segsum_matmul(gain, seg, n_seg)


def _first_argmax(x):
    """Index of the first maximum along the last axis."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    mx = x.max(-1, keepdim=True).values
    return torch.where(x == mx, idx, n).min(-1).values


def _topk_gain(tot, min_gain: float, k: int):
    """Per-template top-k edit candidates from the device gain totals:
    (vals desc, position idx, edit code, count of positions whose best gain
    clears ``min_gain``).  Ties break to the lower position (a stable
    descending sort), so when count <= k the sparse result is exact."""
    best_g = tot.max(-1).values                         # (n_seg, Tpad+1)
    best_e = _first_argmax(tot)
    kk = min(k, best_g.shape[-1])
    vals, idx = torch.sort(best_g, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :kk], idx[:, :kk]
    ev = torch.gather(best_e, 1, idx)
    counts = (best_g > min_gain).sum(-1)
    return vals, idx.to(torch.int32), ev.to(torch.int32), \
        counts.to(torch.int32)


def _compressed_prof(tab, lk, seg, exp_mat):
    """Per-pair gain profile and its small-gain-compressed form (masked
    entries -> 0; |gain| below half the homopolymer-conditioned expectation
    -> 0)."""
    prof = torch.where(tab < -1e29, 0.0, tab - lk[:, None, None])
    comp = torch.where(prof.abs() < 0.5 * exp_mat[seg], 0.0, prof)
    return prof, comp


def _stats_planes(tab, lk, seg, exp_mat, fwd):
    """(B, Tpad+1, NUM_EDIT, 6) variant-stat planes: [support count,
    supported gain, rev-, rev+, fwd-, fwd+]."""
    _prof, comp = _compressed_prof(tab, lk, seg, exp_mat)
    pos = comp > POS_THR_DEV
    nz = comp.abs() > 1e-4
    sgn = comp > 0.0
    f = (fwd > 0.5)[:, None, None]
    return torch.stack([
        pos.to(torch.float32),
        torch.where(pos, comp, 0.0),
        (nz & ~f & ~sgn).to(torch.float32),
        (nz & ~f & sgn).to(torch.float32),
        (nz & f & ~sgn).to(torch.float32),
        (nz & f & sgn).to(torch.float32),
    ], -1)


def modtable_pileup_stats_pallas(qs, tpl, offs, q_lens, t_len, params,
                                 W: int, Tpad: int, strands, params_rev,
                                 seg_ids, n_seg: int, exp_mat):
    """Variant-stats flavour of :func:`modification_table_pileup_pallas`:
    per slice, the modification tables are reduced on the device to
    per-template variant statistics; the per-pair tables stay on their
    slice's device so candidate columns can be gathered afterwards.

    Returns (lks (B,), stats (n_seg, Tpad+1, NUM_EDIT, 6) float64,
    gather(flat_cols) -> (raw (B, U), comp (B, U)))."""
    from ..parallel import on_entry
    W = ((int(W) + 127) // 128) * 128
    tpl = np.asarray(tpl)
    tpl = tpl[:Tpad] if tpl.ndim == 1 else tpl[:, :Tpad]
    qs = np.asarray(qs)
    offs = np.asarray(offs)
    q_lens = np.asarray(q_lens, np.int32)
    seg_ids = np.asarray(seg_ids, np.int64)
    params, params_rev = _host_params(params), _host_params(params_rev)
    t0 = time.time()
    kept = []   # (entry, tab, lk, seg, exp_mat) per slice, on its device
    sts = []
    exp_dev = {}
    primary, parts = _device_slices(qs.shape[0], W)
    for entry, dev, sl in parts:
        tpl_s, tl_s, st_s = _slice_inputs(tpl, t_len, strands, sl)
        with on_entry(entry):
            lk, tab = _modtable_slice(qs[sl], tpl_s, offs[sl], q_lens[sl],
                                      tl_s, params, W, Tpad, st_s,
                                      params_rev, device=dev)
            if entry not in exp_dev:
                exp_dev[entry] = torch.as_tensor(
                    np.asarray(exp_mat, np.float32), device=dev)
            seg = torch.as_tensor(seg_ids[sl], device=dev)
            fwd = torch.ones(len(seg), dtype=torch.float32, device=dev)
            if st_s is not None:
                fwd = torch.as_tensor(
                    np.asarray(st_s, bool).astype(np.float32), device=dev)
            sts.append(_segsum_matmul(_stats_planes(tab, lk, seg,
                                                    exp_dev[entry], fwd),
                                      seg, n_seg))
        kept.append((entry, tab, lk, seg, exp_dev[entry]))
    # the slices' stats summed in float64 in slice order, as one device
    # sums them
    stats = None
    for st in sts:
        st = st.cpu().numpy().astype(np.float64)
        stats = st if stats is None else stats + st
    lks = torch.cat([k[2].to(primary) for k in kept]).cpu().numpy()
    logger.info("modtable stats: %d pairs, %d slices, W=%d, %.1fs",
                qs.shape[0], len(kept), W, time.time() - t0)

    def gather(flat_cols):
        cols = np.asarray(flat_cols, np.int64)
        raws, comps = [], []
        for entry, tab, lk, seg, exp in kept:
            with on_entry(entry):
                c = torch.as_tensor(cols, device=tab.device)
                prof, comp = _compressed_prof(tab, lk, seg, exp)
                raws.append(prof.reshape(prof.shape[0], -1)[:, c])
                comps.append(comp.reshape(comp.shape[0], -1)[:, c])
        return (np.concatenate([r.cpu().numpy() for r in raws]),
                np.concatenate([c.cpu().numpy() for c in comps]))

    return lks, stats, gather
