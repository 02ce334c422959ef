"""Template polishing: iterate best-edit search over a read pileup.

Counterpart of ``jtk_tpu/ops/polish.py`` (production engine).  Each round:
per-read modification tables (K2, on the K1 kernels) are summed per
template on the device; every edit with total gain > ``min_gain`` is
applied, greedily by descending gain with a minimum spacing so independent
per-edit estimates stay valid; repeat until no improving edit remains.
"""

from __future__ import annotations

import numpy as np

from .. import trace
from .banded_align import linear_offsets
from .modtable import finish_gains, modtable_pileup_gains
from .phmm import PHMMParams


SPARSE_K = 512  # top-k gain candidates fetched per template (polish_many)


def effective_band(W: int, q_lens, t_len: int) -> int:
    """Widen the band so unit-step offsets can reach (q_len, t_len) even for
    reads shorter than the template (rounded up to 128, as in the
    reference)."""
    deficit = max(0, int(t_len) - int(np.min(q_lens)))
    return max(W, ((W // 2 + deficit + 127) // 128) * 128)


BAND_MULTS = (1, 2, 4, 8)


def pad_bucket(n: int, step: int = 256, knee: int = 2304) -> int:
    """Padded read length (the K1 kernels' Q): fine ``step`` multiples
    through the hot ~2 kb chunk region, then doubling buckets, as in the
    reference.  Rows past a read's length are frozen, so the padding
    changes no result."""
    if n <= knee:
        return max(step, ((n + step - 1) // step) * step)
    b = knee * 2
    while b < n:
        b *= 2
    return b


def band_buckets(q_lens, t_lens, W: int):
    """Partition pair indices by the band each pair actually needs.

    ``effective_band``'s batch-max let ONE short read (t_len - q_len large)
    inflate the band for every pair in a batch — at 1 Mb consensus scale a
    single truncated segment tripled the whole polish round's kernel cost
    (the fused modtable is O(B·Q·W)).  Pairs are instead grouped into the
    smallest band from {W, 2W, 4W, 8W} (lane-rounded) covering their own
    deficit; pairs beyond 8W are returned as ``dropped`` (pathological —
    the reference's purge_largeindel removes >100 bp indel encodings, so a
    multi-hundred-bp deficit means a broken anchor, not signal).

    Returns (list of (W_bucket, idx ndarray), dropped_idx ndarray)."""
    q_lens = np.asarray(q_lens, np.int64)
    t_lens = np.asarray(t_lens, np.int64)
    deficit = np.maximum(t_lens - q_lens, 0)
    req = np.maximum(W, ((W // 2 + deficit + 127) // 128) * 128)
    out = []
    assigned = np.zeros(len(req), bool)
    for m in BAND_MULTS:
        wb = ((W * m + 127) // 128) * 128
        sel = (~assigned) & (req <= wb)
        if sel.any():
            out.append((int(wb), np.nonzero(sel)[0]))
            assigned |= sel
    dropped = np.nonzero(~assigned)[0]
    # a wider band is a superset of a narrower one, so small tail buckets
    # merge UPWARD into the widest, as in the reference (the band changes
    # the likelihoods, so the grouping is part of the result)
    merged = []
    carry = None  # (W, idx) pending upward merge
    for wb, idx in out:
        if carry is not None:
            idx = np.concatenate([carry[1], idx])
            carry = None
        if len(idx) < 16 and wb != out[-1][0]:
            carry = (wb, idx)
        else:
            merged.append((wb, idx))
    if carry is not None:  # unreachable (the last bucket never carries)
        merged.append(carry)
    return merged, dropped


def choose_edits_sparse(idx, ev, vals, t_len: int, min_gain: float,
                        spacing: int = 8):
    """choose_edits from top-k (position, edit, gain) triples already sorted
    by descending gain (ops.modtable.SparseGains rows).  Exact match of
    choose_edits whenever every above-min_gain position is present."""
    chosen = []
    used = np.zeros(t_len + 2, bool)
    for j, e, g in zip(idx, ev, vals):
        if g <= min_gain:
            break
        if j > t_len:
            continue
        lo, hi = max(0, j - spacing), min(t_len + 1, j + spacing + 1)
        if used[lo:hi].any():
            continue
        used[j] = True
        chosen.append((int(j), int(e), float(g)))
    return chosen


def choose_edits(total_gain: np.ndarray, t_len: int, min_gain: float,
                 spacing: int = 8):
    """Greedy non-interacting edit selection: best edit per position, positions
    at least ``spacing`` apart, gain > min_gain."""
    tg = total_gain[: t_len + 1].copy()
    best_e = np.argmax(tg, axis=1)
    best_g = tg[np.arange(len(tg)), best_e]
    order = np.argsort(-best_g)
    chosen = []
    used = np.zeros(len(tg), bool)
    for j in order:
        if best_g[j] <= min_gain:
            break
        lo, hi = max(0, j - spacing), min(len(tg), j + spacing + 1)
        if used[lo:hi].any():
            continue
        used[j] = True
        chosen.append((int(j), int(best_e[j]), float(best_g[j])))
    return chosen


def apply_edits(template: np.ndarray, edits) -> np.ndarray:
    """Apply (pos, edit_code, gain) edits; edit codes follow the modtable
    layout [sub 0-3 | ins 4-7 | copy len 1..3 | del len 1..3]."""
    from .modtable import COPY_SIZE
    t = template
    for j, e, _ in sorted(edits, reverse=True):
        if e < 4:  # substitution
            t = np.concatenate([t[:j], [e], t[j + 1:]])
        elif e < 8:  # insertion before j
            t = np.concatenate([t[:j], [e - 4], t[j:]])
        elif e < 8 + COPY_SIZE:  # tandem copy of t[j..j+c]
            c = e - 8 + 1
            t = np.concatenate([t[:j + c], t[j:j + c], t[j + c:]])
        else:  # deletion of t[j..j+d]
            d = e - 8 - COPY_SIZE + 1
            t = np.concatenate([t[:j], t[j + d:]])
    return t.astype(np.int8)


@trace.span("polish", device=True)
def polish_many(templates: list, pileups: list, params: PHMMParams,
                W: int = 128, max_rounds: int = 20, min_gain: float = 0.1,
                spacing: int = 8, strands: list | None = None,
                params_rev: PHMMParams | None = None):
    """Polish MANY templates against their own pileups simultaneously.

    One batched device pass per round covers every (read, its-template) pair
    across all pileups; per-template gain totals are summed on the device
    and only the top-k candidates per template come back.  Templates
    converge independently and drop out of later rounds.  Returns
    (polished_templates, per_read_lks): lks[i][rj] is read rj's
    log-likelihood against pileup i's template from the last round that
    evaluated it."""
    n = len(templates)
    tpls = [np.asarray(t, np.int8) for t in templates]
    active = [len(p) > 0 and len(t) > 0 for p, t in zip(pileups, tpls)]
    lks = [np.zeros(len(p)) for p in pileups]
    if strands is None:
        strands = [None] * n
    Tpad = pad_bucket(max((len(t) for t in tpls), default=1)
                      + 128, step=128)
    for _ in range(max_rounds):
        idxs = [i for i in range(n) if active[i]]
        if not idxs:
            break
        with trace.span("polish.prep"):
            while any(len(tpls[i]) + 8 > Tpad for i in idxs):
                Tpad = pad_bucket(max(len(tpls[i]) for i in idxs) + 128,
                                  step=128)
            # flat batch of (read, template-of-its-pileup) pairs
            pair_tpl_idx, pair_reads, pair_strand = [], [], []
            pair_read_idx = []
            for i in idxs:
                for rj, r in enumerate(pileups[i]):
                    pair_tpl_idx.append(i)
                    pair_read_idx.append(rj)
                    pair_reads.append(r)
                    pair_strand.append(True if strands[i] is None
                                       else bool(strands[i][rj]))
            q_lens = np.array([len(r) for r in pair_reads], np.int32)
            t_lens = np.array([len(tpls[i]) for i in pair_tpl_idx], np.int32)
            pair_strand = np.asarray(pair_strand, bool)
            loc = {i: pos for pos, i in enumerate(idxs)}
            buckets, dropped = band_buckets(q_lens, t_lens, W)
            # pathological pairs (deficit beyond 8W) are excluded; their
            # reads keep an effectively -inf likelihood
            for b in dropped:
                lks[pair_tpl_idx[b]][pair_read_idx[b]] = -1e30
        tot_dev = None
        for Wb, bidx in buckets:
            with trace.span("polish.prep"):
                qlb = q_lens[bidx]
                tlb = t_lens[bidx]
                Qpad = pad_bucket(int(qlb.max()))
                nb = len(bidx)
                qs = np.full((nb, Qpad), 4, np.int8)
                tpl_mat = np.full((nb, Tpad), 4, np.int8)
                for p, b in enumerate(bidx):
                    r = pair_reads[b]
                    qs[p, :len(r)] = r
                    t = tpls[pair_tpl_idx[b]]
                    tpl_mat[p, :len(t)] = t
                offs = np.stack([linear_offsets(int(ql), int(tl), Qpad, Wb)
                                 for ql, tl in zip(qlb, tlb)])
                seg_ids = np.array([loc[pair_tpl_idx[b]] for b in bidx],
                                   np.int32)
            # per-template gain totals reduce on the device and accumulate
            # across band buckets; the final fetch is the top-k candidates
            lk, tot = modtable_pileup_gains(
                qs, tpl_mat, offs, qlb, tlb, params, Wb, Tpad, seg_ids,
                len(idxs), strands=pair_strand[bidx], params_rev=params_rev)
            for p, b in enumerate(bidx):
                lks[pair_tpl_idx[b]][pair_read_idx[b]] = float(lk[p])
            tot_dev = tot if tot_dev is None else tot_dev + tot
        sparse = None
        if tot_dev is not None:
            sparse = finish_gains(tot_dev, len(idxs), SPARSE_K, min_gain)
        progressed = False
        with trace.span("polish.edits"):
            for i in idxs:
                edits = []
                if sparse is not None:
                    p = loc[i]
                    if sparse.counts[p] <= sparse.k:
                        edits = choose_edits_sparse(
                            sparse.idx[p], sparse.ev[p], sparse.vals[p],
                            len(tpls[i]), min_gain, spacing)
                    else:  # rare: more candidates than k — fetch that row
                        edits = choose_edits(sparse.dense_row(p),
                                             len(tpls[i]), min_gain, spacing)
                if edits:
                    tpls[i] = apply_edits(tpls[i], edits)
                    progressed = True
                else:
                    active[i] = False
        if not progressed:
            break
    return tpls, lks


def polish_until_converge(template: np.ndarray, reads: list[np.ndarray],
                          params: PHMMParams, W: int = 128,
                          max_rounds: int = 20):
    """Polish ``template`` against ``reads`` until no improving edit remains:
    :func:`polish_many` of the one template.

    Returns (polished_template, final_lks).
    """
    if not reads:
        return template, np.zeros(0)
    tpls, lks = polish_many([template], [reads], params, W=W,
                            max_rounds=max_rounds)
    return tpls[0], lks[0]
