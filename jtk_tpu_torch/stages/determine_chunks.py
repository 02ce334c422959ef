"""Chunk selection: sample ~2 kbp windows, de-overlap, encode, polish.

Reference: ``haplotyper/src/determine_chunks.rs`` — weighted window sampling
(pick_random :229-253, window split :717-729), overlap removal via all-vs-all
mapping + greedy approx vertex cover (:255-355, :776-794), iterative
encode/filter/polish rounds (select_chunks :79-188), frequent-chunk removal
(:191-208), id compaction (:211-226), auto error threshold calc_sim_thr
(:806-823).

Round-1 subset (SURVEY.md §7.2 step 4): sampling + overlap removal + one
encode/polish round + frequent-chunk purge + compaction; the sparse-region /
tip filling iterations arrive with the quality loop.
"""

from __future__ import annotations

import logging
from collections import defaultdict

import numpy as np

from .. import seq as seqmod
from ..datamodel import Chunk, DataSet, ReadType
from ..mapper import ChunkIndex
from ..ops.phmm import PHMMParams
from ..ops.polish import polish_until_converge
from .encode import encode
from .util import update_coverage

logger = logging.getLogger(__name__)


def _windows(ds: DataSet, chunk_len: int, margin: int):
    """Split reads into candidate windows with repeat-aware weights
    (weight = fraction of unmasked (uppercase) bases)."""
    wins = []
    for r in ds.raw_reads:
        seq = r.seq
        n = (len(seq) - 2 * margin) // chunk_len
        for i in range(max(n, 0)):
            s = margin + i * chunk_len
            w = seq[s:s + chunk_len]
            upper_frac = sum(1 for c in w if c.isupper()) / max(len(w), 1)
            wins.append((w.upper(), upper_frac))
    return wins


def pick_random_windows(ds: DataSet, chunk_len: int, take_num: int,
                        margin: int, rng: np.random.Generator):
    wins = _windows(ds, chunk_len, margin)
    if not wins:
        return []
    weights = np.array([w for _, w in wins], float) + 1e-6
    weights /= weights.sum()
    k = min(take_num, len(wins))
    idx = rng.choice(len(wins), size=k, replace=False, p=weights)
    return [wins[i][0] for i in idx]


def remove_overlapping_chunks(seqs: list[str], k: int = 15,
                              min_hits: int = 10):
    """All-vs-all overlap detection + greedy approx vertex cover
    (determine_chunks.rs:310-355, :776-794)."""
    codes = {i: seqmod.encode(s) for i, s in enumerate(seqs)}
    index = ChunkIndex(codes, k=k)
    adj = {i: set() for i in range(len(seqs))}
    for i, c in codes.items():
        for cand in index.candidates(c, i, min_hits=min_hits, margin=100):
            if cand.chunk_id != i:
                adj[i].add(cand.chunk_id)
                adj[cand.chunk_id].add(i)
    removed = set()
    while True:
        deg = {i: len(adj[i] - removed) for i in adj if i not in removed}
        if not deg:
            break
        worst, d = max(deg.items(), key=lambda kv: kv[1])
        if d == 0:
            break
        removed.add(worst)
    return [s for i, s in enumerate(seqs) if i not in removed]


def remove_frequent_chunks(ds: DataSet, purge_copy_num: int):
    """determine_chunks.rs:191-208: drop chunks with pileup count far above
    coverage * (purge_copy_num + 3)."""
    cov = ds.coverage.unwrap() if ds.coverage.is_available else update_coverage(ds)
    counts: dict[int, int] = {}
    for er in ds.encoded_reads:
        for n in er.nodes:
            counts[n.chunk] = counts.get(n.chunk, 0) + 1
    thr = cov * (purge_copy_num + 3)
    drop = {c.id for c in ds.selected_chunks
            if counts.get(c.id, 0) > thr}
    if drop:
        purge_chunks(ds, drop)
    return drop


def purge_chunks(ds: DataSet, drop: set):
    """Remove chunks and strip their nodes from reads (lossless)."""
    ds.selected_chunks = [c for c in ds.selected_chunks if c.id not in drop]
    kept_reads = []
    for er in ds.encoded_reads:
        while True:
            bad = next((i for i, n in enumerate(er.nodes) if n.chunk in drop),
                       None)
            if bad is None:
                break
            er.remove(bad)
        if er.nodes:
            kept_reads.append(er)
    ds.encoded_reads = kept_reads


def compaction_chunks(ds: DataSet):
    """Renumber chunk ids to 0..n-1 (determine_chunks.rs:211-226)."""
    mapping = {}
    for new_id, c in enumerate(sorted(ds.selected_chunks, key=lambda c: c.id)):
        mapping[c.id] = new_id
        c.id = new_id
    ds.selected_chunks.sort(key=lambda c: c.id)
    for er in ds.encoded_reads:
        for n in er.nodes:
            n.chunk = mapping[n.chunk]
        for e in er.edges:
            e.from_ = mapping[e.from_]
            e.to = mapping[e.to]
    return mapping


def calc_sim_thr(ds: DataSet, quantile: float = 0.999) -> float:
    """99.9-percentile node error rate (determine_chunks.rs:806-823)."""
    chunks = {c.id: c.seq for c in ds.selected_chunks}
    errs = []
    for er in ds.encoded_reads:
        for n in er.nodes:
            mat, mism, ins, dele = n.aln_stats(chunks[n.chunk])
            aln = mat + mism + ins + dele
            if aln:
                errs.append((mism + ins + dele) / aln)
    if not errs:
        return ReadType.sim_thr(ds.read_type)
    return float(np.quantile(errs, quantile))


def polish_chunks(ds: DataSet, filter_size: int = 2, cap: int = 40,
                  seed: int = 42):
    """Per-chunk pileup consensus (polish_chunks.rs:36-90): polish each chunk
    against its pileup; drop chunks with pileup <= filter_size."""
    params = PHMMParams.from_hmmparam(ds.model_param.forward)
    pileups: dict[int, list] = {c.id: [] for c in ds.selected_chunks}
    for er in ds.encoded_reads:
        for n in er.nodes:
            if n.chunk in pileups:
                pileups[n.chunk].append(seqmod.encode(n.seq))
    rng = np.random.default_rng(seed)
    drop = set()
    for c in ds.selected_chunks:
        pu = pileups[c.id]
        if len(pu) <= filter_size:
            drop.add(c.id)
            continue
        sel = [pu[i] for i in rng.permutation(len(pu))[:cap]]
        band = max(ReadType.band_width(ds.read_type, len(c.seq)), 64)
        band = ((band + 63) // 64) * 64
        polished, _ = polish_until_converge(c.codes(), sel, params, W=band,
                                            max_rounds=6)
        c.seq = seqmod.decode(polished).decode()
    if drop:
        purge_chunks(ds, drop)
    return drop


# ---------------- chunk-set densification (fill_sparse_region / fill_tips) --

SKIP_OFFSET = 5            # determine_chunks.rs:386
MIN_REQ_NEW_CHUNK = 10     # determine_chunks.rs:2


def _normalize_edge(a, b):
    """determine_chunks.rs:371-383: strand-canonical edge key + direction."""
    fwd = ((a.chunk, a.is_forward), (b.chunk, b.is_forward))
    rev = ((b.chunk, not b.is_forward), (a.chunk, not a.is_forward))
    return (fwd, True) if fwd <= rev else (rev, False)


def _fill_count_thr(ds: DataSet) -> int:
    """Median chunk pileup count / 4 (determine_chunks.rs:452-460)."""
    counts: dict[int, int] = {}
    for er in ds.encoded_reads:
        for n in er.nodes:
            counts[n.chunk] = counts.get(n.chunk, 0) + 1
    if not counts:
        return 1
    vals = sorted(counts.values())
    return vals[len(vals) // 2] // 4


def _consensus_chunks(groups: dict, ds: DataSet, start_id: int,
                      cap: int = 30, seed: int = 42) -> dict:
    """Per key: median-length draft + pileup polish -> new Chunk
    (take_consensus, determine_chunks.rs:429-450)."""
    params = PHMMParams.from_hmmparam(ds.model_param.forward)
    rng = np.random.default_rng(seed)
    out = {}
    next_id = start_id
    for key, seqs in groups.items():
        lens = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
        draft = seqs[lens[len(lens) // 2]]
        sel = [seqs[i] for i in rng.permutation(len(seqs))[:cap]]
        band = max(ReadType.band_width(ds.read_type, len(draft)), 64)
        band = ((band + 63) // 64) * 64
        cons, _ = polish_until_converge(draft, sel, params, W=band,
                                        max_rounds=4)
        out[key] = Chunk(next_id, seqmod.decode(cons).decode(), 1, 2)
        next_id += 1
    return out


def _batched_infix_place(cands, sim_thr: float):
    """Place chunks into read-gap segments with one batched infix alignment.

    cands: [(chunk_codes, seg_codes)]; returns [(ok, rs, re, cigar)] where
    the cigar is node-seq-as-query (I/D flipped from the chunk-as-query DP).
    """
    from ..mapper import flip_cigar
    from ..ops.banded_align import align_with_cigar_batch, diagonal_offsets
    if not cands:
        return []
    W = 256
    Q = max(len(c) for c, _s in cands)
    Q = ((Q + 127) // 128) * 128
    T = max(len(s) for _c, s in cands)
    T = ((T + 127) // 128) * 128
    B = len(cands)
    qs = np.full((B, Q), 4, np.int8)
    rs_arr = np.full((B, T), 4, np.int8)
    q_lens = np.zeros(B, np.int32)
    t_lens = np.zeros(B, np.int32)
    offs = np.zeros((B, Q + 1), np.int32)
    for i, (c, s) in enumerate(cands):
        qs[i, :len(c)] = c
        rs_arr[i, :len(s)] = s
        q_lens[i] = len(c)
        t_lens[i] = len(s)
        diag = max((len(s) - len(c)) // 2, 0)
        offs[i] = diagonal_offsets(len(c), diag, len(s), Q, W)
    res = align_with_cigar_batch(qs, rs_arr, offs, q_lens, t_lens, W, "infix")
    out = []
    for i, (c, _s) in enumerate(cands):
        err = int(res["score"][i]) / max(len(c), 1)
        out.append((err < sim_thr, int(res["start_j"][i]),
                    int(res["end_j"][i]), flip_cigar(res["cigar"][i])))
    return out


def _node_error(n, chunk_seqs) -> float:
    cs = chunk_seqs.get(n.chunk)
    if cs is None:
        return 1.0
    mat, mism, ins, dele = n.aln_stats(cs)
    aln = mat + mism + ins + dele
    return (mism + ins + dele) / aln if aln else 1.0


def rebuild_encoded_read(er, read_ascii: str, nodes, chunk_seqs) -> None:
    """re_encode_read (determine_chunks.rs:548-563): sort, drop slippy /
    contained encodings, rebuild edges and gaps in place."""
    from ..datamodel import Edge
    nodes = sorted(nodes, key=lambda n: (n.position_from_start,
                                         -n.query_length()))
    out = []
    for n in nodes:
        drop = False
        conflict = True
        while conflict and not drop:
            conflict = False
            for m in out:
                m_end = m.position_from_start + m.query_length()
                if m.chunk == n.chunk and m.is_forward == n.is_forward \
                        and n.position_from_start < m_end:
                    if _node_error(n, chunk_seqs) < _node_error(m, chunk_seqs):
                        out.remove(m)
                        conflict = True
                    else:
                        drop = True
                    break
                if m.position_from_start <= n.position_from_start and \
                        n.position_from_start + n.query_length() <= m_end:
                    drop = True
                    break
        if not drop:
            out.append(n)
    out.sort(key=lambda n: n.position_from_start)
    er.nodes = out
    er.edges = [Edge.from_nodes(a, b, read_ascii)
                for a, b in zip(out, out[1:])]
    if out:
        er.leading_gap = read_ascii[:out[0].position_from_start]
        last_end = out[-1].position_from_start + out[-1].query_length()
        er.trailing_gap = read_ascii[last_end:]


def fill_sparse_region(ds: DataSet, annot, chunk_len: int = 2000,
                       exclude_repeats: float = 0.8, seed: int = 42) -> int:
    """Create consensus chunks for long read-gap labels between the same
    chunk pair and re-encode the supporting reads through them
    (determine_chunks.rs:388-500, :564-590)."""
    from ..datamodel import Node
    if not ds.selected_chunks:
        return 0
    groups: dict = defaultdict(list)
    for er in ds.encoded_reads:
        for a, e, b in zip(er.nodes, er.edges, er.nodes[1:]):
            lab = e.label
            if len(lab) > chunk_len + SKIP_OFFSET:
                key, fwd = _normalize_edge(a, b)
                if fwd:
                    piece = lab[SKIP_OFFSET:SKIP_OFFSET + chunk_len]
                else:
                    piece = seqmod.revcomp_ascii(
                        lab[len(lab) - SKIP_OFFSET - chunk_len:
                            len(lab) - SKIP_OFFSET].encode()).decode()
                groups[key].append(seqmod.encode(piece.upper()))
    thr = _fill_count_thr(ds)
    groups = {k: v for k, v in groups.items() if len(v) > max(thr, 1)}
    if annot is not None:
        groups = {k: v for k, v in groups.items()
                  if all(annot.repetitiveness(s) < exclude_repeats
                         for s in v)}
    if not groups:
        return 0
    start_id = max(c.id for c in ds.selected_chunks) + 1
    new_chunks = _consensus_chunks(groups, ds, start_id, seed=seed)
    if annot is not None:
        new_chunks = {k: c for k, c in new_chunks.items()
                      if annot.repetitiveness(c.codes()) < exclude_repeats}
    sim_thr = ReadType.sim_thr(ds.read_type)
    read_ascii = {r.id: r.seq for r in ds.raw_reads}
    # candidate placements across all reads, one device batch
    cands, places = [], []
    for ri, er in enumerate(ds.encoded_reads):
        seq = read_ascii.get(er.id)
        if seq is None:
            continue
        for i in range(len(er.nodes) - 1):
            a, b = er.nodes[i], er.nodes[i + 1]
            key, fwd = _normalize_edge(a, b)
            chunk = new_chunks.get(key)
            if chunk is None:
                continue
            start = a.position_from_start + a.query_length()
            end = b.position_from_start
            if end <= start:
                continue
            clen = len(chunk.seq)
            if fwd:
                s0, e0 = start, min(start + clen + SKIP_OFFSET, end)
            else:
                s0, e0 = max(end - clen - SKIP_OFFSET, start), end
            seg_ascii = seq[s0:e0].upper()
            seg = seqmod.encode(seg_ascii)
            if not fwd:
                seg = seqmod.revcomp(seg)
            if len(seg) < clen // 2:
                continue
            cands.append((chunk.codes(), seg))
            places.append((ri, chunk, fwd, s0, e0))
    results = _batched_infix_place(cands, sim_thr)
    touched: dict[int, list] = defaultdict(list)
    for (ri, chunk, fwd, s0, e0), (ok, rs, re_, cigar) in zip(places, results):
        if not ok or re_ <= rs:
            continue
        seq = read_ascii[ds.encoded_reads[ri].id]
        if fwd:
            pos = s0 + rs
            node_seq = seq[pos:s0 + re_].upper()
        else:
            seg_len = e0 - s0
            pos = s0 + seg_len - re_
            node_seq = seqmod.revcomp_ascii(
                seq[pos:s0 + seg_len - rs].upper().encode()).decode()
        touched[ri].append(Node.new(chunk.id, fwd, node_seq, cigar, pos, 2))
    for ri, new_nodes in touched.items():
        er = ds.encoded_reads[ri]
        rebuild_encoded_read(er, read_ascii[er.id],
                             list(er.nodes) + new_nodes,
                             {c.id: c.seq for c in ds.selected_chunks}
                             | {c.id: c.seq for c in new_chunks.values()})
    ds.selected_chunks.extend(new_chunks.values())
    logger.info("fill_sparse_region: %d new edge chunks, %d reads touched",
                len(new_chunks), len(touched))
    return len(new_chunks)


def fill_tips(ds: DataSet, annot, chunk_len: int = 2000,
              exclude_repeats: float = 0.8, seed: int = 43) -> int:
    """Create consensus chunks for long leading/trailing read gaps keyed by
    the boundary (chunk, strand) and encode them back
    (determine_chunks.rs:592-714)."""
    from ..datamodel import Node
    if not ds.selected_chunks:
        return 0
    take_len = chunk_len + SKIP_OFFSET
    groups: dict = defaultdict(list)
    for er in ds.encoded_reads:
        if not er.nodes:
            continue
        head = er.nodes[0]
        if len(er.leading_gap) > take_len:
            tip = er.leading_gap
            piece = seqmod.revcomp_ascii(
                tip[len(tip) - take_len:len(tip) - SKIP_OFFSET]
                .encode()).decode()
            groups[(head.chunk, not head.is_forward)].append(
                seqmod.encode(piece.upper()))
        tail = er.nodes[-1]
        if len(er.trailing_gap) > take_len:
            piece = er.trailing_gap[SKIP_OFFSET:take_len]
            groups[(tail.chunk, tail.is_forward)].append(
                seqmod.encode(piece.upper()))
    thr = _fill_count_thr(ds)
    groups = {k: v for k, v in groups.items() if len(v) > max(thr, 1)}
    if not groups:
        return 0
    start_id = max(c.id for c in ds.selected_chunks) + 1
    new_chunks = _consensus_chunks(groups, ds, start_id, seed=seed)
    if annot is not None:
        new_chunks = {k: c for k, c in new_chunks.items()
                      if annot.repetitiveness(c.codes()) < exclude_repeats}
    sim_thr = ReadType.sim_thr(ds.read_type)
    read_ascii = {r.id: r.seq for r in ds.raw_reads}
    cands, places = [], []
    for ri, er in enumerate(ds.encoded_reads):
        seq = read_ascii.get(er.id)
        if seq is None or not er.nodes:
            continue
        head = er.nodes[0]
        chunk = new_chunks.get((head.chunk, not head.is_forward))
        if chunk is not None and head.position_from_start > SKIP_OFFSET:
            s0, e0 = 0, head.position_from_start
            clen = len(chunk.seq)
            s0 = max(e0 - clen - SKIP_OFFSET, 0)
            seg = seqmod.revcomp(seqmod.encode(seq[s0:e0].upper()))
            if len(seg) >= clen // 2:
                cands.append((chunk.codes(), seg))
                places.append((ri, chunk, False, s0, e0))
        tail = er.nodes[-1]
        chunk = new_chunks.get((tail.chunk, tail.is_forward))
        tail_end = tail.position_from_start + tail.query_length()
        if chunk is not None and tail_end < len(seq) - SKIP_OFFSET:
            clen = len(chunk.seq)
            s0 = tail_end
            e0 = min(s0 + clen + SKIP_OFFSET, len(seq))
            seg = seqmod.encode(seq[s0:e0].upper())
            if len(seg) >= clen // 2:
                cands.append((chunk.codes(), seg))
                places.append((ri, chunk, True, s0, e0))
    results = _batched_infix_place(cands, sim_thr)
    touched: dict[int, list] = defaultdict(list)
    for (ri, chunk, fwd, s0, e0), (ok, rs, re_, cigar) in zip(places, results):
        if not ok or re_ <= rs:
            continue
        seq = read_ascii[ds.encoded_reads[ri].id]
        if fwd:
            pos = s0 + rs
            node_seq = seq[pos:s0 + re_].upper()
        else:
            seg_len = e0 - s0
            pos = s0 + seg_len - re_
            node_seq = seqmod.revcomp_ascii(
                seq[pos:s0 + seg_len - rs].upper().encode()).decode()
        touched[ri].append(Node.new(chunk.id, fwd, node_seq, cigar, pos, 2))
    for ri, new_nodes in touched.items():
        er = ds.encoded_reads[ri]
        rebuild_encoded_read(er, read_ascii[er.id],
                             list(er.nodes) + new_nodes,
                             {c.id: c.seq for c in ds.selected_chunks}
                             | {c.id: c.seq for c in new_chunks.values()})
    ds.selected_chunks.extend(new_chunks.values())
    logger.info("fill_tips: %d new tip chunks, %d reads touched",
                len(new_chunks), len(touched))
    return len(new_chunks)


def filter_chunk_by_ovlp(ds: DataSet, chunk_len: int = 2000) -> int:
    """Conflict graph over chunks whose encodings overlap on a read by more
    than chunk_len/3 (chunk_len/2 for HiFi); approx vertex cover decides the
    survivors (determine_chunks.rs:731-775)."""
    thr = chunk_len // 2 if ds.read_type == ReadType.CCS else chunk_len // 3
    adj: dict[int, set] = defaultdict(set)
    for er in ds.encoded_reads:
        for i, n1 in enumerate(er.nodes):
            n1_end = n1.position_from_start + n1.query_length()
            for n2 in er.nodes[i + 1:]:
                ovl = n1_end - n2.position_from_start
                if ovl > thr and n1.chunk != n2.chunk:
                    adj[n1.chunk].add(n2.chunk)
                    adj[n2.chunk].add(n1.chunk)
    removed = set()
    while True:
        deg = {i: len(adj[i] - removed) for i in adj if i not in removed}
        if not deg:
            break
        worst, d = max(deg.items(), key=lambda kv: (kv[1], kv[0]))
        if d == 0:
            break
        removed.add(worst)
    if removed:
        purge_chunks(ds, removed)
    return len(removed)


def _get_repeat_annot(ds: DataSet):
    """Recompute the masked-kmer annotation (get_repetitive_kmer)."""
    from .repeat_masking import DEFAULT_K, RepeatAnnot, count_kmers
    k = ds.masked_kmers.k or DEFAULT_K
    uniq, counts = count_kmers(ds, k)
    if len(uniq) == 0:
        return RepeatAnnot(set(), k)
    thr = ds.masked_kmers.thr or max(int(np.quantile(counts, 0.999)), 10)
    return RepeatAnnot(set(uniq[counts > thr].tolist()), k)


def select_chunks(ds: DataSet, chunk_len: int = 2000, take_num: int = 500,
                  margin: int = 500, seed: int = 42, purge_copy_num: int = 10,
                  exclude_repeats: float = 0.8,
                  encode_kwargs: dict | None = None) -> DataSet:
    """Three-round chunk selection (select_chunks, determine_chunks.rs:79-188):
    relaxed encode + first polish; densification loop (fill_sparse_region +
    fill_tips + deletion-fill, up to 10 iterations) + overlap filters +
    second polish; final re-encode + filters + third polish + repetitiveness
    screen; then in-select purge_largeindel + id compaction."""
    import time as _time

    _marks = [("start", _time.time())]

    def _mark(label):
        _marks.append((label, _time.time()))
        logger.info("select_chunks: %s %.1fs", label,
                    _marks[-1][1] - _marks[-2][1])

    rng = np.random.default_rng(seed)
    encode_kwargs = encode_kwargs or {}
    seqs = pick_random_windows(ds, chunk_len, take_num, margin, rng)
    seqs = remove_overlapping_chunks(seqs)
    ds.selected_chunks = [Chunk(i, s, 1, 2) for i, s in enumerate(seqs)]
    logger.info("select_chunks: %d windows after overlap removal", len(seqs))
    annot = _get_repeat_annot(ds)
    _mark("windows")
    # round 1: relaxed encode + coverage + frequent-chunk purge + polish
    relaxed = 2 * ReadType.sim_thr(ds.read_type)
    encode(ds, sim_thr=relaxed, **encode_kwargs)
    _mark("encode1")
    update_coverage(ds)
    remove_frequent_chunks(ds, purge_copy_num)
    polish_chunks(ds)
    compaction_chunks(ds)
    _mark("polish1")
    # round 2: encode + densification loop + overlap filters + polish
    encode(ds, sim_thr=None, **encode_kwargs)
    _mark("encode2")
    thr = max(calc_sim_thr(ds), ReadType.sim_thr(ds.read_type))
    logger.info("select_chunks: calibrated sim_thr=%.3f", thr)
    from .deletion_fill import correct_deletion
    for _ in range(10):
        new = fill_sparse_region(ds, annot, chunk_len, exclude_repeats,
                                 seed=seed) \
            + fill_tips(ds, annot, chunk_len, exclude_repeats, seed=seed + 1)
        correct_deletion(ds)
        if new < MIN_REQ_NEW_CHUNK:
            break
    _mark("densify")
    compaction_chunks(ds)
    update_coverage(ds)
    remove_frequent_chunks(ds, purge_copy_num)
    filter_chunk_by_ovlp(ds, chunk_len)
    polish_chunks(ds)
    compaction_chunks(ds)
    _mark("polish2")
    # round 3: re-encode against polished chunks with calibrated threshold
    encode(ds, sim_thr=thr, **encode_kwargs)
    _mark("encode3")
    thr = max(calc_sim_thr(ds), ReadType.sim_thr(ds.read_type))
    update_coverage(ds)
    remove_frequent_chunks(ds, purge_copy_num)
    filter_chunk_by_ovlp(ds, chunk_len)
    compaction_chunks(ds)
    encode(ds, sim_thr=thr, **encode_kwargs)
    update_coverage(ds)
    _mark("encode4")
    # repetitiveness screen (determine_chunks.rs:170-172)
    rep_drop = {c.id for c in ds.selected_chunks
                if annot.repetitiveness(c.codes()) >= exclude_repeats}
    if rep_drop:
        purge_chunks(ds, rep_drop)
        compaction_chunks(ds)
    # in-select purge of half-pileup-supported large indels (:182-188)
    from .purge_diverged import purge_largeindel
    purge_largeindel(ds, occupy_fraction=0.5)
    compaction_chunks(ds)
    ds.push_stage("DetermineChunks", [f"take_num={take_num}"])
    return ds
