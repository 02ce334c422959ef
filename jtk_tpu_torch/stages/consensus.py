"""Contig consensus polishing — windowed pair-HMM polish of spelled contigs.

Reference: ``haplotyper/src/assemble/consensus/mod.rs`` — re-map every read to
the contigs *in chunk space* by chaining node matches against the contig's
tile encoding (enumerate_chain :734-845), extend to bp alignments through the
tiles (:1056-1520), then polish in 2 kbp windows with the trained pair-HMM,
re-stitching between rounds (:270-561).

TPU-native structure: chunk-space anchors come free from the assembly tiles
(graph spell records them); read segments per window are cut by linear
interpolation between anchors; every window pileup is polished by the K1/K2
device kernels.  Windows overlap and are stitched by aligning neighbouring
polished windows in their overlap (removing boundary artifacts without the
reference's iterative re-alignment rounds).
"""

from __future__ import annotations

import logging

import numpy as np

from .. import seq as seqmod
from ..datamodel import DataSet, ReadType
from ..ops.banded_align import edit_align, linear_offsets
from ..ops.phmm import PHMMParams
from ..ops.polish import polish_until_converge

logger = logging.getLogger(__name__)


def _read_anchors(ds: DataSet, contigs):
    """Per contig: list of (read_idx, sign, [(read_pos, read_end, cstart, cend)])
    coarse alignments from node<->tile matches, chained monotonically."""
    tile_ix = {}
    for ci, c in enumerate(contigs):
        for t in c.get("tiles", []):
            # cloned nodes carry (chunk, cluster, dup) keys; anchor on the
            # (chunk, cluster) identity
            tile_ix.setdefault(tuple(t["node"][:2]), []).append((ci, t))
    per_contig = {ci: [] for ci in range(len(contigs))}
    for ri, er in enumerate(ds.encoded_reads):
        cands = {}
        for n in er.nodes:
            key = (n.chunk, n.cluster)
            for ci, t in tile_ix.get(key, []):
                sign = 1 if (n.is_forward == t["fwd"]) else -1
                rs = n.position_from_start
                re_ = rs + n.query_length()
                cands.setdefault((ci, sign), []).append(
                    (rs, re_, t["start"], t["end"]))
        for (ci, sign), anchors in cands.items():
            anchors.sort()
            chain = _best_monotone_chain(anchors, sign)
            if len(chain) >= 1:
                per_contig[ci].append((ri, sign, chain))
    return per_contig


def _best_monotone_chain(anchors, sign):
    """Max-weight monotone subsequence over contig coordinates (weight =
    contig span), so a spurious first anchor (repeat hit) cannot lock the
    chain to a wrong placement — counterpart of the reference's scored
    chaining (consensus/mod.rs:734-845)."""
    n = len(anchors)
    if n <= 1:
        return list(anchors)
    w = [a[3] - a[2] for a in anchors]
    best = list(w)
    prev = [-1] * n
    for i in range(n):
        for j in range(i):
            ok = (anchors[j][2] <= anchors[i][2]) if sign > 0 \
                else (anchors[j][2] >= anchors[i][2])
            if ok and best[j] + w[i] > best[i]:
                best[i] = best[j] + w[i]
                prev[i] = j
    i = max(range(n), key=lambda t: best[t])
    chain = []
    while i != -1:
        chain.append(anchors[i])
        i = prev[i]
    chain.reverse()
    return chain


def _window_segment(read_codes, sign, chain, w0, w1, margin):
    """Approximate read segment covering contig window [w0, w1)."""
    # anchor arrays in contig coords
    cs = np.array([a[2] for a in chain], float)
    ce = np.array([a[3] for a in chain], float)
    rs = np.array([a[0] for a in chain], float)
    re_ = np.array([a[1] for a in chain], float)

    def to_read(cpos):
        # find nearest anchor; linear interpolation within it, extrapolate
        # between anchors by matching proportional position
        if sign > 0:
            idx = np.clip(np.searchsorted(cs, cpos) - 1, 0, len(cs) - 1)
            frac = (cpos - cs[idx]) / max(ce[idx] - cs[idx], 1)
            return rs[idx] + frac * (re_[idx] - rs[idx])
        else:
            idx = np.clip(np.searchsorted(-ce[::-1], -cpos) - 1, 0,
                          len(cs) - 1)
            idx = len(cs) - 1 - idx
            frac = (ce[idx] - cpos) / max(ce[idx] - cs[idx], 1)
            return rs[idx] + frac * (re_[idx] - rs[idx])

    lo = int(min(to_read(w0), to_read(w1)))
    hi = int(max(to_read(w0), to_read(w1)))
    lo = max(lo - margin, 0)
    hi = min(hi + margin, len(read_codes))
    if hi - lo < (w1 - w0) // 3:
        return None
    seg = read_codes[lo:hi]
    if sign < 0:
        seg = seqmod.revcomp(seg)
    return seg


def _stitch(a: np.ndarray, b: np.ndarray, ov: int):
    """Join two polished windows that overlap by ~ov bp: locate b's head
    inside a's tail by infix alignment and cut there.  Returns
    (joined, start_of_b_in_joined)."""
    if len(a) == 0:
        return b, 0
    if len(b) == 0:
        return a, len(a)
    head = b[:min(ov, len(b))]
    tail = a[-min(2 * ov, len(a)):]
    if len(head) < 8 or len(tail) < 16:
        cut_b = min(ov, len(b))
        return np.concatenate([a, b[cut_b:]]), len(a) - cut_b
    try:
        # head is expected to start ~ov before a's end
        diag = max(len(tail) - ov, 0)
        _, _cigar, rs, _re = edit_align(head, tail, W=128, mode="infix",
                                        diag=diag)
    except AssertionError:
        cut_b = min(ov, len(b))
        return np.concatenate([a, b[cut_b:]]), len(a) - cut_b
    cut_a = len(a) - len(tail) + rs
    return np.concatenate([a[:cut_a], b]), cut_a


def trim_segments_multi(jobs: list, margin: int, max_err: float = 0.4,
                        batch: int = 2048):
    """Batched read-splitting across MANY windows: ``jobs`` is a list of
    (template, segs) pairs; every (window-template, segment) alignment rides
    a few fixed-shape infix dispatches instead of one per window
    (consensus/mod.rs:620-707 is rayon-per-window; at 1 Mb+ scale the
    per-window dispatch count was the consensus bottleneck).

    Returns, per job, the list of (trimmed_seg, original_index)."""
    from ..ops.banded_align import (collect_align_cigar, diagonal_offsets,
                                    dispatch_align_cigar)
    flat = []  # (job_idx, seg_idx, template, seg)
    for ji, (template, segs) in enumerate(jobs):
        for si, s in enumerate(segs):
            flat.append((ji, si, np.asarray(template, np.int8), s))
    out = [[] for _ in jobs]
    if not flat:
        return out
    Q = ((max(len(t) for _ji, _si, t, _s in flat) + 63) // 64) * 64
    Tpad = ((max(len(s) for _ji, _si, _t, s in flat) + 63) // 64) * 64
    W = ((2 * margin + Q // 8 + 127) // 128) * 128
    # dispatch every batch before collecting any: device compute and the
    # result transfers overlap instead of serializing per batch (at 1 Mb
    # scale round 0 trims ~30k segments = ~15 batches)
    handles = []
    for s0 in range(0, len(flat), batch):
        grp = flat[s0:s0 + batch]
        B = len(grp)
        qs = np.full((B, Q), 4, np.int8)
        rs = np.full((B, Tpad), 4, np.int8)
        q_lens = np.zeros(B, np.int32)
        t_lens = np.zeros(B, np.int32)
        offs = np.zeros((B, Q + 1), np.int32)
        for b, (_ji, _si, t, s) in enumerate(grp):
            qs[b, :len(t)] = t
            q_lens[b] = len(t)
            rs[b, :len(s)] = s
            t_lens[b] = len(s)
            diag = max((len(s) - len(t)) // 2, 0)
            offs[b] = diagonal_offsets(len(t), diag, len(s), Q, W)
        handles.append((grp, dispatch_align_cigar(qs, rs, offs, q_lens,
                                                  t_lens, W, "infix")))
    for grp, handle in handles:
        res = collect_align_cigar(handle)
        for b, (ji, si, t, s) in enumerate(grp):
            d = int(res["score"][b])
            if d > max_err * len(t):
                continue
            lo, hi = int(res["start_j"][b]), int(res["end_j"][b])
            if hi - lo < len(t) // 2:
                continue
            out[ji].append((s[lo:hi], si))
    return out


def trim_segments(template: np.ndarray, segs: list, margin: int,
                  max_err: float = 0.4, return_index: bool = False):
    """Cut each (longer) segment to exactly the template's span via one
    batched infix alignment (template as query, free segment ends) — the
    counterpart of the reference's per-window read splitting
    (consensus/mod.rs:620-707)."""
    from ..ops.banded_align import align_with_cigar_batch, diagonal_offsets
    if not segs:
        return []
    t = np.asarray(template, np.int8)
    Q = ((len(t) + 63) // 64) * 64
    Tpad = ((max(len(s) for s in segs) + 63) // 64) * 64
    W = ((2 * margin + len(t) // 8 + 127) // 128) * 128
    B = len(segs)
    qs = np.tile(np.concatenate([t, np.full(Q - len(t), 4, np.int8)]),
                 (B, 1))
    rs = np.full((B, Tpad), 4, np.int8)
    t_lens = np.zeros(B, np.int32)
    offs = np.zeros((B, Q + 1), np.int32)
    for i, s in enumerate(segs):
        rs[i, :len(s)] = s
        t_lens[i] = len(s)
        diag = max((len(s) - len(t)) // 2, 0)
        offs[i] = diagonal_offsets(len(t), diag, len(s), Q, W)
    res = align_with_cigar_batch(qs, rs, offs,
                                 np.full(B, len(t), np.int32), t_lens, W,
                                 "infix")
    out = []
    for i, s in enumerate(segs):
        d = int(res["score"][i])
        if d > max_err * len(t):
            continue
        lo, hi = int(res["start_j"][i]), int(res["end_j"][i])
        if hi - lo < len(t) // 2:
            continue
        out.append((s[lo:hi], i) if return_index else s[lo:hi])
    return out


def dump_coverage(ds: DataSet, contigs, path: str, window: int = 1000,
                  names=None):
    """{prefix}.coverage.tsv — smoothed per-window read coverage per contig
    (consensus/mod.rs:140-250)."""
    per_contig = _read_anchors(ds, contigs)
    with open(path, "w") as f:
        f.write("contig\tposition\tcoverage\n")
        for ci, contig in enumerate(contigs):
            L = len(contig["seq"])
            cov = np.zeros(max(L // window + 1, 1))
            for _ri, _sign, chain in per_contig.get(ci, []):
                lo = min(a[2] for a in chain)
                hi = max(a[3] for a in chain)
                cov[max(lo // window, 0): hi // window + 1] += 1
            name = names[ci] if names else f"tig_{ci:04d}"
            for w, c in enumerate(cov):
                f.write(f"{name}\t{w * window}\t{int(c)}\n")


def dump_sam(ds: DataSet, contigs, path: str, names=None, W: int = 128,
             max_reads: int | None = None, cell_budget: int = 1 << 31,
             max_batch: int = 512):
    """{prefix}.sam — read-to-contig alignments re-derived from the chunk-space
    anchors, refined by banded global alignments.

    Alignments are gathered ACROSS contigs, grouped by (query-pad,
    template-pad, band) POWER-OF-TWO buckets, and all batches are async-
    dispatched before any is collected.  The previous per-contig batch=64
    loop recomputed pads from each batch's max length — at 1 Mb scale (~4k
    full-length reads) that meant dozens of distinct compiled shapes and a
    serial RPC round-trip per batch: the SAM dump cost ~50 min of the
    assemble phase.  Bucketing holds the compiled-shape count at ~a dozen
    and lets device compute overlap host decode."""
    from ..ops.banded_align import collect_align_cigar, dispatch_align_cigar
    import time as _time
    t0 = _time.time()
    per_contig = _read_anchors(ds, contigs)
    # ---- gather every candidate alignment across contigs ----
    entries = []  # (ci, rid, sign, seg, cs, tpl)
    for ci, contig in enumerate(contigs):
        cseq = seqmod.encode(contig["seq"])
        aligns = per_contig.get(ci, [])
        if max_reads:
            aligns = aligns[:max_reads]
        for ri, sign, chain in aligns:
            er = ds.encoded_reads[ri]
            codes = seqmod.encode(er.recover_raw_read())
            rs = min(a[0] for a in chain)
            re_ = max(a[1] for a in chain)
            cs = min(a[2] for a in chain)
            ce = min(max(a[3] for a in chain), len(cseq))
            seg = codes[rs:re_]
            if sign < 0:
                seg = seqmod.revcomp(seg)
            tpl = cseq[cs:ce]
            if len(seg) < 32 or len(tpl) < 32 or \
                    len(tpl) - len(seg) > len(tpl) // 3:
                continue
            entries.append((ci, er.id, sign, seg, cs, tpl))
    # ---- group by padded-shape bucket ----
    def bucket(n, lo=2048):
        b = lo
        while b < n:
            b *= 2
        return b

    groups: dict = {}
    for ei, (_ci, _rid, _sign, seg, _cs, tpl) in enumerate(entries):
        deficit = max(len(tpl) - len(seg), 0)
        wb = max(W, 128)
        while wb - 64 < deficit and wb < 2048:
            wb *= 2
        if len(tpl) - len(seg) >= wb - 1:
            continue  # pathological; no SAM line (matches old ok=False skip)
        groups.setdefault((bucket(len(seg)), bucket(len(tpl)), wb),
                          []).append(ei)
    # ---- dispatch all batches, then collect ----
    cigars: dict = {}
    handles = []
    for (Qpad, Tpad, band), eis in sorted(groups.items()):
        B = max(8, min(max_batch, cell_budget // (Qpad * band)))
        for s0 in range(0, len(eis), B):
            grp = eis[s0:s0 + B]
            qs = np.full((len(grp), Qpad), 4, np.int8)
            rs_arr = np.full((len(grp), Tpad), 4, np.int8)
            offs = np.zeros((len(grp), Qpad + 1), np.int32)
            q_lens = np.zeros(len(grp), np.int32)
            t_lens = np.zeros(len(grp), np.int32)
            for b, ei in enumerate(grp):
                seg, tpl = entries[ei][3], entries[ei][5]
                qs[b, :len(seg)] = seg
                rs_arr[b, :len(tpl)] = tpl
                q_lens[b], t_lens[b] = len(seg), len(tpl)
                offs[b] = linear_offsets(len(seg), len(tpl), Qpad, band)
            handles.append((grp, dispatch_align_cigar(
                qs, rs_arr, offs, q_lens, t_lens, band, "global")))
    for grp, h in handles:
        res = collect_align_cigar(h)
        for b, ei in enumerate(grp):
            cigars[ei] = res["cigar"][b]
    logger.info("dump_sam: %d alignments, %d shape buckets (%.1fs)",
                len(entries), len(groups), _time.time() - t0)
    # ---- emit in per-contig order ----
    with open(path, "w") as f:
        f.write("@HD\tVN:1.6\tSO:unsorted\n")
        for ci, contig in enumerate(contigs):
            name = names[ci] if names else f"tig_{ci:04d}"
            f.write(f"@SQ\tSN:{name}\tLN:{len(contig['seq'])}\n")
        for ei, (ci, rid, sign, seg, cs, _tpl) in enumerate(entries):
            if ei not in cigars:
                continue
            name = names[ci] if names else f"tig_{ci:04d}"
            cigar = "".join(f"{l}{k}" for k, l in cigars[ei])
            flag = 0 if sign > 0 else 16
            seq_str = seqmod.decode(seg).decode()
            f.write(f"{rid}\t{flag}\t{name}\t{cs + 1}\t60\t{cigar}"
                    f"\t*\t0\t0\t{seq_str}\t*\n")


def _remap_tiles(contig, part_old_starts, part_new_starts, old_len, new_len):
    """Piecewise-linear old->new coordinate map from window start anchors so
    the chunk-space tiles stay in sync with the polished sequence — the
    coarse first pass of the reference's fix_alignment between rounds
    (consensus/mod.rs:498-561); :func:`_reanchor_tiles` then refines each
    tile by banded re-alignment."""
    xs = np.asarray(part_old_starts + [old_len], float)
    ys = np.asarray(part_new_starts + [new_len], float)
    order = np.argsort(xs)
    xs, ys = xs[order], ys[order]
    for t in contig.get("tiles", []):
        t["start"] = int(np.interp(t["start"], xs, ys))
        t["end"] = int(np.interp(t["end"], xs, ys))


def _reanchor_tiles(contig, old_cseq, new_cseq, margin: int = 200,
                    batch: int = 48, max_err: float = 0.35):
    """Re-align every tile's OLD sequence into the polished contig around its
    interpolated position — the banded-DP counterpart of the reference's
    fix_alignment window-boundary re-alignment (consensus/mod.rs:498-561).

    ``contig['tiles']`` must already hold the interpolated guesses (call
    :func:`_remap_tiles` first); each guess is refined by one batched infix
    alignment of ``old_seq[tile]`` against ``new_seq[guess±margin]``.  Tiles
    whose alignment fails (edit distance > max_err·len, or degenerate spans)
    keep the interpolated coordinates."""
    from ..ops.banded_align import align_with_cigar_batch, diagonal_offsets
    tiles = contig.get("tiles", [])
    jobs = []  # (tile, old_start, old_end, slice_off, slice_seq)
    for t in tiles:
        os_, oe = t.get("_old_start"), t.get("_old_end")
        if os_ is None or oe is None or oe - os_ < 64 or os_ < 0:
            continue
        g0, g1 = t["start"], t["end"]
        lo = max(g0 - margin, 0)
        hi = min(g1 + margin, len(new_cseq))
        if hi - lo < (oe - os_) // 2:
            continue
        jobs.append((t, os_, oe, lo, new_cseq[lo:hi]))
    for s0 in range(0, len(jobs), batch):
        grp = jobs[s0:s0 + batch]
        Qpad = ((max(e[2] - e[1] for e in grp) + 63) // 64) * 64
        Tpad = ((max(len(e[4]) for e in grp) + 63) // 64) * 64
        W = ((2 * margin + Qpad // 8 + 127) // 128) * 128
        B = len(grp)
        qs = np.full((B, Qpad), 4, np.int8)
        rs = np.full((B, Tpad), 4, np.int8)
        q_lens = np.zeros(B, np.int32)
        t_lens = np.zeros(B, np.int32)
        offs = np.zeros((B, Qpad + 1), np.int32)
        for i, (_t, os_, oe, _lo, sl) in enumerate(grp):
            q = old_cseq[os_:oe]
            qs[i, :len(q)] = q
            q_lens[i] = len(q)
            rs[i, :len(sl)] = sl
            t_lens[i] = len(sl)
            offs[i] = diagonal_offsets(len(q), max((len(sl) - len(q)) // 2, 0),
                                       len(sl), Qpad, W)
        res = align_with_cigar_batch(qs, rs, offs, q_lens, t_lens, W, "infix")
        for i, (t, os_, oe, lo, _sl) in enumerate(grp):
            d = int(res["score"][i])
            s_j, e_j = int(res["start_j"][i]), int(res["end_j"][i])
            if d > max_err * (oe - os_) or e_j - s_j < (oe - os_) // 2:
                continue
            t["start"], t["end"] = lo + s_j, lo + e_j
    for t in tiles:
        t.pop("_old_start", None)
        t.pop("_old_end", None)


def _terminal_shrink(spans, ext0, ext1, w0, w1, n_win, wi, min_cov):
    """At contig ends the reads taper off, so the window-complete filter
    (reads must span ext0+50..ext1-50) would leave terminal windows
    unpolished.  Shrink the FIRST window's start (resp. LAST window's end) to
    the coordinate still covered by >= min_cov reads — the counterpart of the
    reference's partial-window tolerance (consensus/mod.rs:445-496).
    Returns the adjusted (ext0, ext1)."""
    if wi == 0 and spans:
        ends_ok = [s for s in spans if s[1] >= ext1 - 50]
        if len(ends_ok) >= min_cov:
            starts = sorted(s[0] for s in ends_ok)
            s = starts[min(min_cov - 1, len(starts) - 1)]
            if s > ext0 + 50:
                ext0 = min(s, ext1 - 200)
    if wi == n_win - 1 and spans:
        starts_ok = [s for s in spans if s[0] <= ext0 + 50]
        if len(starts_ok) >= min_cov:
            ends = sorted((s[1] for s in starts_ok), reverse=True)
            e = ends[min(min_cov - 1, len(ends) - 1)]
            if e < ext1 - 50:
                ext1 = max(e, ext0 + 200)
    return ext0, ext1


def _stitch_cuts_batch(parts: list, overlap: int):
    """Pairwise boundary cuts for consecutive polished windows: for each
    boundary, locate part i+1's head inside part i's tail by ONE batched
    infix alignment (the sequential _stitch paid a device call per
    boundary).  Returns (tail_cut per part, head_chop per part)."""
    from ..ops.banded_align import align_with_cigar_batch, diagonal_offsets
    n = len(parts)
    tail_cut = [len(p) for p in parts]
    head_chop = [0] * n
    ov = 2 * overlap
    jobs = []  # (boundary index, head, tail)
    for i in range(n - 1):
        a, b = parts[i], parts[i + 1]
        head = b[:min(ov, len(b))]
        tail = a[-min(2 * ov, len(a)):]
        if len(head) < 8 or len(tail) < 16 or len(tail) - len(head) < 1:
            head_chop[i + 1] = min(ov, len(b))
            continue
        jobs.append((i, head, tail))
    if jobs:
        Q = ((max(len(h) for _i, h, _t in jobs) + 63) // 64) * 64
        Tp = ((max(len(t) for _i, _h, t in jobs) + 63) // 64) * 64
        W = 128
        B = len(jobs)
        qs = np.full((B, Q), 4, np.int8)
        rs = np.full((B, Tp), 4, np.int8)
        q_lens = np.zeros(B, np.int32)
        t_lens = np.zeros(B, np.int32)
        offs = np.zeros((B, Q + 1), np.int32)
        ok = np.ones(B, bool)
        for b, (_i, h, t) in enumerate(jobs):
            qs[b, :len(h)] = h
            rs[b, :len(t)] = t
            q_lens[b], t_lens[b] = len(h), len(t)
            try:
                offs[b] = diagonal_offsets(len(h), max(len(t) - ov, 0),
                                           len(t), Q, W)
            except AssertionError:
                ok[b] = False
        res = align_with_cigar_batch(qs, rs, offs, q_lens, t_lens, W,
                                     "infix")
        for b, (i, h, t) in enumerate(jobs):
            if not ok[b]:
                head_chop[i + 1] = len(h)
                continue
            rs_j = int(res["start_j"][b])
            tail_cut[i] = len(parts[i]) - len(t) + rs_j
    return tail_cut, head_chop


def polish_contigs(ds: DataSet, contigs, window: int = 2000,
                   overlap: int = 100, margin: int = 150, cap: int = 30,
                   min_cov: int = 4, rounds: int = 3, seed: int = 42,
                   polish_group: int = 400) -> list:
    """Polish contig dicts in place (seq replaced); returns the contigs.

    Three rounds by default (consensus/mod.rs:300).  EVERY window across
    every contig is gathered per round: segment trimming, the strand-specific
    HMM polish (polish_many) and the boundary stitches each ride a handful of
    batched dispatches — the reference rayon-parallelizes per window
    (consensus/mod.rs:316-331); per-window device calls would be the
    bottleneck at COX_PGF scale (thousands of windows)."""
    from ..ops.polish import polish_many
    params_f = PHMMParams.from_hmmparam(ds.model_param.forward)
    params_r = PHMMParams.from_hmmparam(ds.model_param.reverse)
    read_codes = [seqmod.encode(er.recover_raw_read())
                  for er in ds.encoded_reads]
    rng = np.random.default_rng(seed)
    cseqs = {}
    import time as _time
    # windows whose template changed in the previous round, per contig:
    # {ci: (n_win, set(wi))}.  A window is re-polished only while it or a
    # neighbour is still moving — converged regions of the contig drop out
    # of rounds 1+ entirely (the reference's per-window
    # polish_until_converge achieves the same, consensus/mod.rs:445-496;
    # whole-round re-polish of stable windows was ~2/3 of round-1/2 cost
    # at 1 Mb scale)
    changed_prev = None
    for _round in range(rounds):
        t_round = _time.time()
        per_contig = _read_anchors(ds, contigs)
        any_change = False
        # ---- 1. gather every window of every contig (host) ----
        win_jobs = []
        nwin_ci = {}
        for ci, contig in enumerate(contigs):
            cseq = seqmod.encode(contig["seq"])
            cseqs[ci] = cseq
            if len(cseq) < 100:
                continue
            aligns = per_contig.get(ci, [])
            if not aligns:
                continue
            n_win = max((len(cseq) + window - 1) // window, 1)
            nwin_ci[ci] = n_win
            prev = changed_prev.get(ci) if changed_prev is not None else None
            stable_grid = prev is not None and prev[0] == n_win
            spans = [(min(a[2] for a in chain), max(a[3] for a in chain))
                     for _ri, _sign, chain in aligns]
            for wi in range(n_win):
                w0 = wi * window
                w1 = min(w0 + window, len(cseq))
                ext0 = max(w0 - overlap, 0)
                ext1 = min(w1 + overlap, len(cseq))
                skip = stable_grid and \
                    not ({wi - 1, wi, wi + 1} & prev[1])
                # terminal windows: polish only the min_cov-covered
                # subrange and keep the uncovered flanks raw
                s0, s1 = _terminal_shrink(
                    [s for s in spans if s[1] > ext0 and s[0] < ext1],
                    ext0, ext1, w0, w1, n_win, wi, min_cov)
                template = cseq[s0:s1]
                segs, strands = [], []
                if not skip:
                    for (ri, sign, chain), (cs0, ce1) in zip(aligns, spans):
                        if ce1 <= s0 or cs0 >= s1:
                            continue
                        if cs0 > s0 + 50 or ce1 < s1 - 50:
                            continue
                        seg = _window_segment(read_codes[ri], sign, chain,
                                              s0, s1, margin)
                        if seg is not None:
                            segs.append(seg)
                            strands.append(sign > 0)
                    if len(segs) > cap:
                        idx = rng.permutation(len(segs))[:cap]
                        segs = [segs[i] for i in idx]
                        strands = [strands[i] for i in idx]
                win_jobs.append(dict(ci=ci, wi=wi, ext0=ext0, ext1=ext1,
                                     s0=s0, s1=s1, template=template,
                                     segs=segs, strands=strands,
                                     skip=skip, was_changed=False))
        if not win_jobs:
            break
        n_skip = sum(j["skip"] for j in win_jobs)
        logger.info("consensus round %d: %d windows gathered, %d converged-"
                    "skipped (%.1fs)", _round, len(win_jobs), n_skip,
                    _time.time() - t_round)
        # ---- 2. batched segment trimming across all active windows ----
        t_trim = _time.time()
        act = [j for j in win_jobs if not j["skip"]]
        kept = trim_segments_multi(
            [(j["template"], j["segs"]) for j in act], margin)
        for j, kp in zip(act, kept):
            j["segs"] = [s for s, _i in kp]
            j["strands"] = [j["strands"][i] for _s, i in kp]
        logger.info("consensus round %d: trim done (%.1fs)",
                    _round, _time.time() - t_trim)
        # ---- 3. batched polish (grouped to bound host-side prep) ----
        poll = [j for j in act if len(j["segs"]) >= min_cov]
        if poll:
            t_pol = _time.time()
            band = max(ReadType.band_width(
                ds.read_type, max(len(j["template"]) for j in poll)), 64)
            band = ((band + 127) // 128) * 128
            for g0 in range(0, len(poll), polish_group):
                grp = poll[g0:g0 + polish_group]
                tpls, _ = polish_many(
                    [j["template"] for j in grp],
                    [j["segs"] for j in grp], params_f, W=band,
                    max_rounds=6,
                    strands=[np.array(j["strands"], bool) for j in grp],
                    params_rev=params_r)
                for j, t in zip(grp, tpls):
                    t = np.asarray(t, np.int8)
                    if len(t) != len(j["template"]) or \
                            not np.array_equal(t, j["template"]):
                        j["was_changed"] = True
                    j["template"] = t
                logger.info("consensus round %d: polished %d/%d windows "
                            "(%.1fs)", _round, min(g0 + polish_group,
                                                   len(poll)), len(poll),
                            _time.time() - t_pol)
        # ---- 4. per contig: raw flanks + batched stitches + re-anchor ----
        by_ci: dict[int, list] = {}
        for j in win_jobs:
            cseq = cseqs[j["ci"]]
            tpl = j["template"]
            if j["s0"] > j["ext0"]:
                tpl = np.concatenate([cseq[j["ext0"]:j["s0"]], tpl])
            if j["s1"] < j["ext1"]:
                tpl = np.concatenate([tpl, cseq[j["s1"]:j["ext1"]]])
            j["template"] = tpl
            by_ci.setdefault(j["ci"], []).append(j)
        for ci, jobs in by_ci.items():
            contig = contigs[ci]
            cseq = cseqs[ci]
            parts = [j["template"] for j in jobs]
            tail_cut, head_chop = _stitch_cuts_batch(parts, overlap)
            pieces, old_starts, new_starts = [], [], []
            pos = 0
            for j, p, tc, hc in zip(jobs, parts, tail_cut, head_chop):
                old_starts.append(j["ext0"])
                new_starts.append(pos - hc)
                pieces.append(p[hc:tc])
                pos += tc - hc
            out = np.concatenate(pieces) if pieces else cseq
            new_seq = seqmod.decode(out).decode()
            if new_seq != contig["seq"]:
                any_change = True
            for t in contig.get("tiles", []):
                t["_old_start"], t["_old_end"] = t["start"], t["end"]
            _remap_tiles(contig, old_starts, new_starts, len(cseq),
                         len(out))
            _reanchor_tiles(contig, cseq, out)
            contig["seq"] = new_seq
        changed_prev = {ci: (nwin_ci[ci],
                             {j["wi"] for j in jobs if j["was_changed"]})
                        for ci, jobs in by_ci.items()}
        n_changed = sum(len(v[1]) for v in changed_prev.values())
        logger.info("consensus round %d: done (%.1fs, changed=%s, "
                    "%d windows moved)", _round, _time.time() - t_round,
                    any_change, n_changed)
        if not any_change:
            break
    ds.push_stage("PolishContigs", [])
    return contigs
