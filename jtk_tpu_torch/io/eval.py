"""Truth-based evaluation helpers (compare_haplotypes counterpart).

Reference: ``sandbox/src/bin/compare_haplotypes.rs`` + ``script/see_metric.sh``
— align assembled contigs to truth haplotypes and report identity/coverage.
"""

from __future__ import annotations

import numpy as np

from .. import seq as seqmod
from ..mapper import ChunkIndex
from ..ops.banded_align import diagonal_offsets, banded_align_batch


def locate_and_align(query: np.ndarray, ref: np.ndarray, W: int = 512,
                     k: int = 15):
    """Find the best placement of ``query`` (either strand) in ``ref`` via
    k-mer diagonal voting, then banded infix alignment.

    Returns (edit_dist, strand, ref_span) or None if no seed found."""
    index = ChunkIndex({0: query}, k=k, max_occ=256)
    best = None
    for strand, rseq in ((1, ref), (-1, seqmod.revcomp(ref))):
        cands = index.candidates_one_strand(rseq, 0, True, min_hits=3,
                                            margin=0, stride=1)
        # candidates place query in rseq coords: diag = rseq_pos - query_pos
        for c in cands:
            diag = c.window_start  # margin=0 -> window_start == diag estimate
            Q = ((len(query) + 63) // 64) * 64
            off = diagonal_offsets(len(query), diag, len(rseq), Q, W)
            qp = np.full(Q, 4, np.int8)
            qp[:len(query)] = query
            res = banded_align_batch(qp[None], rseq[None].astype(np.int8),
                                     off[None], np.array([len(query)]),
                                     np.array([len(rseq)]), W, "infix")
            d = int(res["score"][0])
            if best is None or d < best[0]:
                best = (d, strand, int(res["end_j"][0]))
    return best


def contig_error_rate(contig_seq: str, haplotypes: list[np.ndarray],
                      W: int = 512) -> float:
    """Min edit-distance fraction of the contig against any haplotype."""
    cseq = seqmod.encode(contig_seq)
    best = np.inf
    for hap in haplotypes:
        r = locate_and_align(cseq, np.asarray(hap, np.int8), W=W)
        if r is not None:
            best = min(best, r[0] / max(len(cseq), 1))
    return float(best)


def _vote_strand_diag(piece: np.ndarray, index: "ChunkIndex"):
    """Best (strand, ref_start) placement of ``piece`` against the indexed
    reference by k-mer diagonal voting (strand=-1 means the piece matches
    the reverse complement of the reference)."""
    best = None
    for strand, p in ((1, piece), (-1, seqmod.revcomp(piece))):
        cands = index.candidates_one_strand(p, 0, True, min_hits=5,
                                            margin=0, stride=4)
        for c in cands:
            # index holds the REF as chunk 0 scanned by the piece:
            # window_start = ref placement diag inside the piece
            # => piece starts at -window_start in ref coords
            if best is None or c.n_hits > best[2]:
                best = (strand, -c.window_start, c.n_hits)
    return best


def contig_error_blockwise(contig_seqs: dict, haplotypes,
                           block: int = 50_000, W: int = 1024,
                           margin: int = 2000, batch: int = 24):
    """Per-contig error rate for LARGE contigs: each contig is cut into
    ~``block``-sized pieces, every piece is placed on each haplotype by
    k-mer voting and infix-aligned against the ±margin cropped window, and
    the per-hap piece distances sum per contig (min over haps — so
    haplotype switching inside a contig is still penalized).  The
    whole-contig path (``contig_error_rate``) runs a (len x W) DP per
    CANDIDATE — at 1 Mb that is hours; this is a handful of fixed-shape
    batched dispatches.  Unplaced pieces cost their full length."""
    from .gfa import parse_gfa  # noqa: F401  (callers pass parsed seqs)
    indexes = [ChunkIndex({0: np.asarray(h, np.int8)}, k=15, max_occ=64)
               for h in haplotypes]
    jobs = []  # (contig, hap_i, piece_i, piece, crop, diag_in_crop)
    pieces_of: dict = {}
    for name, cseq in contig_seqs.items():
        n_p = max(int(round(len(cseq) / block)), 1)
        bounds = np.linspace(0, len(cseq), n_p + 1).astype(int)
        pieces_of[name] = []
        for pi in range(n_p):
            piece = cseq[bounds[pi]:bounds[pi + 1]]
            pieces_of[name].append(len(piece))
            for hi, (hap, index) in enumerate(zip(haplotypes, indexes)):
                hap = np.asarray(hap, np.int8)
                got = _vote_strand_diag(piece, index)
                if got is None:
                    continue
                strand, start, _hits = got
                # voting already scanned rc(piece) against the raw hap for
                # strand<0, so ``start`` is directly the hap coordinate of p
                p = piece if strand > 0 else seqmod.revcomp(piece)
                lo = max(start - margin, 0)
                hi_ = min(start + len(piece) + margin, len(hap))
                if hi_ - lo < len(piece) // 2:
                    continue
                jobs.append([name, hi, pi, p, hap[lo:hi_], start - lo])
    # one fixed-shape dispatch per batch
    Q = ((max((len(j[3]) for j in jobs), default=1) + 255) // 256) * 256
    Tp = ((max((len(j[4]) for j in jobs), default=1) + 255) // 256) * 256
    dists: dict = {}
    for s0 in range(0, len(jobs), batch):
        grp = jobs[s0:s0 + batch]
        B = len(grp)
        qs = np.full((B, Q), 4, np.int8)
        rs = np.full((B, Tp), 4, np.int8)
        q_lens = np.zeros(B, np.int32)
        t_lens = np.zeros(B, np.int32)
        offs = np.zeros((B, Q + 1), np.int32)
        for b, (_n, _hi, _pi, p, crop, diag) in enumerate(grp):
            qs[b, :len(p)] = p
            rs[b, :len(crop)] = crop
            q_lens[b], t_lens[b] = len(p), len(crop)
            offs[b] = diagonal_offsets(len(p), max(diag, 0), len(crop), Q, W)
        res = banded_align_batch(qs, rs, offs, q_lens, t_lens, W, "infix")
        for b, (name, hi, pi, p, _crop, _diag) in enumerate(grp):
            dists.setdefault((name, hi), {})[pi] = int(res["score"][b])
    out = {}
    for name, plens in pieces_of.items():
        per_hap = []
        for hi in range(len(haplotypes)):
            got = dists.get((name, hi), {})
            tot = sum(got.get(pi, plens[pi]) for pi in range(len(plens)))
            per_hap.append(tot)
        out[name] = min(per_hap) / max(sum(plens), 1)
    return out


def assembly_metrics(gfa_text: str, haplotypes, min_len: int = 300,
                     W: int = 512, block: int = 50_000):
    """Per-contig error rates + haplotype coverage summary.  Contigs longer
    than ~2 blocks take the blockwise path (batched, scales to Mbp)."""
    from .gfa import parse_gfa
    segs, _ = parse_gfa(gfa_text)
    out = {}
    total, err_sum = 0, 0.0
    big = {name: seqmod.encode(rec["seq"]) for name, rec in segs.items()
           if len(rec["seq"]) >= 2 * block}
    big_err = contig_error_blockwise(big, haplotypes, block=block) \
        if big else {}
    for name, rec in segs.items():
        if len(rec["seq"]) < min_len:
            continue
        if name in big_err:
            e = big_err[name]
        else:
            e = contig_error_rate(rec["seq"], haplotypes, W=W)
        out[name] = {"len": len(rec["seq"]), "error": e}
        if np.isfinite(e):
            total += len(rec["seq"])
            err_sum += e * len(rec["seq"])
    mean_err = err_sum / total if total else float("nan")
    return {"contigs": out, "total_len": total, "mean_error": mean_err}
