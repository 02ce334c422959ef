"""Deletion fill — recover chunk occurrences that encoding missed.

Reference: ``haplotyper/src/encode/deletion_fill.rs`` — aligns other reads'
chunk strings to each read (chunk-space Gotoh DP :738-827 with the
chunk-match prefilter :611-637), votes for missing (chunk, cluster)
insertions in per-position pileups (:642-698, :863-982), re-encodes the
candidates at bp resolution, accepting when the alignment error is below
expected(read) + expected(chunk) + 10 sigma (:369), and iterates 3 outer x
12 inner rounds with per-read failed-trial memoization and liveness
gating (:136-214).

TPU-repo structure: the Gotoh DP runs *batch-vectorized across all read
pairs at once* (numpy; the alphabet is chunk symbols, reads are ~tens of
nodes, so this is bookkeeping, not FLOPs — the bp-level verification is the
device part).  Affine gaps with zero extension cost reduce the in-row
dependency to a running max, so each DP row is one vector op over the whole
pair batch.  Candidate insertions are then verified by ONE batched K3 infix
alignment on device per round.
"""

from __future__ import annotations

import logging
from collections import defaultdict

import numpy as np

from .. import seq as seqmod
from ..datamodel import DataSet, Node
from ..mapper import Candidate, extend_candidates
from .encode import _node_from_result
from .error_rate import estimate_error_rate

logger = logging.getLogger(__name__)

SIGMA_FACTOR = 10.0   # THR, deletion_fill.rs:369
MIN_MATCH = 2
SCORE_THR = 1
INS_THR = 2
MIN_ALN = -(10 ** 7)
OUTER_LOOP = 3
INNER_LOOP = 12
MAX_SKEL = 160        # pairs needing longer skeletons are skipped


# ---------------- skeletons ----------------

def _skeleton(er):
    """(chunk, cluster, dir, prev_off, after_off) arrays for one read."""
    n = len(er.nodes)
    ch = np.fromiter((x.chunk for x in er.nodes), np.int64, n)
    cl = np.fromiter((x.cluster for x in er.nodes), np.int64, n)
    dr = np.fromiter((x.is_forward for x in er.nodes), bool, n)
    starts = np.fromiter((x.position_from_start for x in er.nodes),
                         np.int64, n)
    ends = starts + np.fromiter((x.query_length() for x in er.nodes),
                                np.int64, n)
    prev_off = np.full(n, -(10 ** 9), np.int64)
    after_off = np.full(n, -(10 ** 9), np.int64)
    if n > 1:
        prev_off[1:] = starts[1:] - ends[:-1]
        after_off[:-1] = starts[1:] - ends[:-1]
    return ch, cl, dr, prev_off, after_off


def _rev_skeleton(sk):
    ch, cl, dr, po, ao = sk
    return ch[::-1], cl[::-1], ~dr[::-1], ao[::-1], po[::-1]


# ---------------- batched chunk-space Gotoh ----------------

def _gotoh_batch(r_sk, q_sk, r_lens, q_lens, L):
    """3-state Gotoh over chunk symbols, vectorized across pairs.

    r_sk/q_sk: (B, L) padded (chunk, cluster, dir) triples as three arrays.
    Free leading/trailing gaps on both sides (dovetail), match +1 on cluster
    agreement, -1 on disagreement, forbidden across different chunks
    (score(), deletion_fill.rs:727-736).  Returns (scores, ops_list) where
    ops_list[b] is [(op, len)] with op in {'M','I','D'} (I consumes query).
    """
    (rc, rl, rd), (qc, ql_, qd) = r_sk, q_sk
    B = rc.shape[0]
    same = (rc[:, :, None] == qc[:, None, :]) \
        & (rd[:, :, None] == qd[:, None, :]) & (rc[:, :, None] >= 0)
    S = np.where(same,
                 np.where(rl[:, :, None] == ql_[:, None, :], 1, -1),
                 MIN_ALN).astype(np.int32)
    H = np.full((B, L + 1, L + 1), MIN_ALN, np.int32)
    I = np.full_like(H, MIN_ALN)
    D = np.full_like(H, MIN_ALN)
    H[:, 0, 0] = 0
    I[:, 0, :] = 0   # free leading query gap
    D[:, :, 0] = 0   # free leading read gap
    I[:, 0, 0] = MIN_ALN
    D[:, 0, 0] = MIN_ALN
    for i in range(1, L + 1):
        prev_best = np.maximum(np.maximum(H[:, i - 1], I[:, i - 1]),
                               D[:, i - 1])
        H[:, i, 1:] = prev_best[:, :-1] + S[:, i - 1, :]
        D[:, i, 1:] = np.maximum(H[:, i - 1, 1:] - 1, D[:, i - 1, 1:])
        I[:, i, 1:] = np.maximum.accumulate(H[:, i, :-1] - 1, axis=1)
    # endpoint: best over last row/col (within actual lengths), all states
    bidx = np.arange(B)
    best_sc = np.full(B, MIN_ALN, np.int64)
    best_i = np.zeros(B, np.int64)
    best_j = np.zeros(B, np.int64)
    best_st = np.zeros(B, np.int64)
    stacked = np.stack([H, I, D])  # (3, B, L+1, L+1)
    for st in range(3):
        col = stacked[st][bidx, :, q_lens]  # (B, L+1) -> j = q_len
        ii = np.arange(L + 1)[None, :]
        colm = np.where(ii <= r_lens[:, None], col, MIN_ALN)
        am = colm.argmax(1)
        sc = colm[bidx, am]
        upd = sc > best_sc
        best_sc = np.where(upd, sc, best_sc)
        best_i = np.where(upd, am, best_i)
        best_j = np.where(upd, q_lens, best_j)
        best_st = np.where(upd, st, best_st)
        row = stacked[st][bidx, r_lens, :]
        rowm = np.where(ii <= q_lens[:, None], row, MIN_ALN)
        am = rowm.argmax(1)
        sc = rowm[bidx, am]
        upd = sc > best_sc
        best_sc = np.where(upd, sc, best_sc)
        best_i = np.where(upd, r_lens, best_i)
        best_j = np.where(upd, am, best_j)
        best_st = np.where(upd, st, best_st)
    # batched traceback
    max_steps = 2 * L + 2
    out = np.zeros((B, max_steps), np.uint8)  # 1=M, 2=I, 3=D
    i_cur = best_i.copy()
    j_cur = best_j.copy()
    st = best_st.copy()
    # trailing free gaps recorded separately
    trail_del = r_lens - best_i
    trail_ins = q_lens - best_j
    active = (i_cur > 0) & (j_cur > 0)
    step = 0
    while active.any() and step < max_steps:
        ii = np.clip(i_cur, 1, L)
        jj = np.clip(j_cur, 1, L)
        h_cur = H[bidx, ii, jj]
        i_val = I[bidx, ii, jj]
        d_val = D[bidx, ii, jj]
        s_prev = S[bidx, ii - 1, jj - 1]
        # state 0 (H): predecessor = whichever of H/I/D equals H - s
        want = h_cur - s_prev
        ph = H[bidx, ii - 1, jj - 1]
        pi = I[bidx, ii - 1, jj - 1]
        pd = D[bidx, ii - 1, jj - 1]
        nxt_h = np.where(ph == want, 0, np.where(pi == want, 1, 2))
        # state 1 (I): from H[i, j-1]-1 (0) or I extension (1)
        nxt_i = np.where(H[bidx, ii, jj - 1] - 1 == i_val, 0, 1)
        # state 2 (D): from H[i-1, j]-1 (0) or D extension (2)
        nxt_d = np.where(H[bidx, ii - 1, jj] - 1 == d_val, 0, 2)
        op = np.where(st == 0, 1, np.where(st == 1, 2, 3)).astype(np.uint8)
        di = np.where(st != 1, 1, 0)
        dj = np.where(st != 2, 1, 0)
        nxt = np.where(st == 0, nxt_h, np.where(st == 1, nxt_i, nxt_d))
        out[:, step] = np.where(active, op, 0)
        i_cur = np.where(active, i_cur - di, i_cur)
        j_cur = np.where(active, j_cur - dj, j_cur)
        st = np.where(active, nxt, st)
        active = (i_cur > 0) & (j_cur > 0)
        step += 1
    ops_list = []
    for b in range(B):
        ops = []
        if i_cur[b] > 0:
            ops.append(("D", int(i_cur[b])))
        if j_cur[b] > 0:
            ops.append(("I", int(j_cur[b])))
        km = {1: "M", 2: "I", 3: "D"}
        for code in out[b, :step][::-1]:
            if code == 0:
                continue
            k = km[int(code)]
            if ops and ops[-1][0] == k:
                ops[-1] = (k, ops[-1][1] + 1)
            else:
                ops.append((k, 1))
        if trail_del[b] > 0:
            ops.append(("D", int(trail_del[b])))
        if trail_ins[b] > 0:
            ops.append(("I", int(trail_ins[b])))
        # merge possible adjacent same-kind runs at the boundaries
        merged = []
        for k, l in ops:
            if merged and merged[-1][0] == k:
                merged[-1] = (k, merged[-1][1] + l)
            else:
                merged.append((k, l))
        ops_list.append(merged)
    return best_sc, ops_list


def _is_proper(ops):
    """No Ins directly against Del (deletion_fill.rs:722-726)."""
    for (k1, _), (k2, _) in zip(ops, ops[1:]):
        if {k1, k2} == {"I", "D"}:
            return False
    return True


# ---------------- pileup voting ----------------

class _Pileup:
    __slots__ = ("head", "tail", "coverage")

    def __init__(self):
        self.head = []   # (key, prev_off, after_off)
        self.tail = []
        self.coverage = 0


def _vote_pileups(er_nodes_len, aligned):
    """aligned: [(q_skel_oriented, ops)] for one target read.  Returns
    pileups[i] = insertions before the i-th node (get_pileup,
    deletion_fill.rs:642-698)."""
    pileups = [_Pileup() for _ in range(er_nodes_len + 1)]
    for (qc, ql_, qd, qpo, qao), ops in aligned:
        pos = 0   # read node index
        qi = 0    # query node index
        for k, l in ops:
            if k == "I":
                take = []
                if pos == 0:
                    take = [(l - 1, "tail")]
                elif pos == er_nodes_len:
                    take = [(0, "head")]
                else:
                    take = [(0, "head")]
                    if l >= 2:
                        take.append((l - 1, "tail"))
                for off, side in take:
                    q = qi + off
                    item = ((int(qc[q]), int(ql_[q]), bool(qd[q])),
                            int(qpo[q]), int(qao[q]))
                    if side == "head":
                        pileups[pos].head.append(item)
                    else:
                        pileups[pos].tail.append(item)
                qi += l
            elif k == "D":
                pos += l
            else:  # M
                qi += l
                for _ in range(l):
                    pileups[pos].coverage += 1
                    pos += 1
    return pileups


def _collect_candidates(er, pileups, ins_thr, failed):
    """check_insertion_head/tail (deletion_fill.rs:939-982): vote counts ->
    (key, est_position) candidates per slot."""
    nodes = er.nodes
    out = []
    bad_off = -(10 ** 9)
    for idx, pu in enumerate(pileups):
        if idx > 0:
            counts = defaultdict(list)
            for key, po, _ao in pu.head:
                counts[key].append(po)
            for key, offs in counts.items():
                if len(offs) < ins_thr or (idx, key) in failed:
                    continue
                good = [o for o in offs if o != bad_off]
                if not good:
                    continue
                start = nodes[idx - 1].position_from_start \
                    + nodes[idx - 1].query_length()
                pos = start + int(np.mean(good))
                out.append((idx, key, max(pos, 0)))
        if idx < len(nodes):
            counts = defaultdict(list)
            for key, _po, ao in pu.tail:
                counts[key].append(ao)
            for key, offs in counts.items():
                if len(offs) < ins_thr or (idx, key) in failed:
                    continue
                good = [o for o in offs if o != bad_off]
                if not good:
                    continue
                end_pos = nodes[idx].position_from_start
                pos = end_pos - int(np.mean(good))
                out.append((idx, key, max(pos, 0)))
    return out


# ---------------- the stage ----------------

def _rebuild(er, ascii_seq, nodes, chunk_ascii):
    from .determine_chunks import rebuild_encoded_read
    rebuild_encoded_read(er, ascii_seq, nodes, chunk_ascii)


def correct_deletion(ds: DataSet, re_cluster: bool = False,
                     margin: int = 100, W: int = 256) -> DataSet:
    chunk_seqs = {c.id: c.codes() for c in ds.selected_chunks}
    chunk_ascii = {c.id: c.seq for c in ds.selected_chunks}
    erm = estimate_error_rate(ds)
    changed_chunks: set = set()
    failed = [set() for _ in ds.encoded_reads]
    alive = [True] * len(ds.encoded_reads)
    read_ascii = [er.recover_raw_read() for er in ds.encoded_reads]
    read_codes = [seqmod.encode(s) for s in read_ascii]
    for outer in range(OUTER_LOOP):
        for f in failed:
            f.clear()
        alive = [True] * len(ds.encoded_reads)
        any_update = False
        for inner in range(INNER_LOOP):
            added = _fill_once(ds, chunk_seqs, chunk_ascii, erm, failed,
                               alive, read_ascii, read_codes, margin, W,
                               changed_chunks)
            if added == 0:
                break
            any_update = True
        if not any_update:
            break
    if re_cluster and changed_chunks:
        from .local_clustering import local_clustering
        from .multiplicity import estimate_multiplicity
        estimate_multiplicity(ds)
        local_clustering(ds, selection=changed_chunks)
    ds.push_stage("CorrectDeletion", [f"re_cluster={re_cluster}"])
    return ds


def _fill_once(ds, chunk_seqs, chunk_ascii, erm, failed, alive, read_ascii,
               read_codes, margin, W, changed_chunks) -> int:
    import time as _time
    _t0 = _time.time()
    skels = [_skeleton(er) for er in ds.encoded_reads]
    n_reads = len(skels)
    # chunk-match prefilter: shared (chunk, cluster, dir) keys
    by_key = defaultdict(list)
    for ri, (ch, cl, dr, _po, _ao) in enumerate(skels):
        for c, l, d in zip(ch, cl, dr):
            by_key[(int(c), int(l), bool(d))].append(ri)
    pairs = []   # (target, query, is_forward)
    for ri in range(n_reads):
        if not alive[ri] or not ds.encoded_reads[ri].nodes:
            continue
        ch, cl, dr, _po, _ao = skels[ri]
        if len(ch) > MAX_SKEL:
            continue
        fwd_hits = defaultdict(int)
        rev_hits = defaultdict(int)
        seen = set()
        for c, l, d in zip(ch, cl, dr):
            k = (int(c), int(l), bool(d))
            if k in seen:
                continue
            seen.add(k)
            for qi in by_key.get(k, ()):  # same-dir partner
                fwd_hits[qi] += 1
            for qi in by_key.get((int(c), int(l), not bool(d)), ()):
                rev_hits[qi] += 1
        min_match = min(MIN_MATCH, len(ch))
        for qi in set(fwd_hits) | set(rev_hits):
            if qi == ri or len(skels[qi][0]) > MAX_SKEL:
                continue
            f, r = fwd_hits.get(qi, 0), rev_hits.get(qi, 0)
            if max(f, r) >= min_match:
                pairs.append((ri, qi, r <= f))
    if not pairs:
        return 0
    _t1 = _time.time()
    per_read_aligned = defaultdict(list)
    if _align_pairs_native(skels, pairs, per_read_aligned):
        logger.info("deletion_fill: pair build %.1fs, native dp %.1fs",
                    _t1 - _t0, _time.time() - _t1)
        return _apply_alignments(ds, chunk_seqs, chunk_ascii, erm, failed,
                                 alive, read_ascii, read_codes, margin, W,
                                 changed_chunks, pairs, per_read_aligned)
    # batched DP over pair chunks (numpy fallback)
    L = min(max((len(skels[r][0]) for r, _q, _d in pairs), default=1),
            MAX_SKEL)
    L = max(L, max((len(skels[q][0]) for _r, q, _d in pairs), default=1))
    BATCH = 512
    for s0 in range(0, len(pairs), BATCH):
        grp = pairs[s0:s0 + BATCH]
        B = len(grp)
        rc = np.full((B, L), -1, np.int64)
        rl = np.zeros((B, L), np.int64)
        rd = np.zeros((B, L), bool)
        qc = np.full((B, L), -1, np.int64)
        ql_ = np.zeros((B, L), np.int64)
        qd = np.zeros((B, L), bool)
        r_lens = np.zeros(B, np.int64)
        q_lens = np.zeros(B, np.int64)
        q_skel_or = []
        for b, (ri, qi, is_fwd) in enumerate(grp):
            ch, cl, dr, _po, _ao = skels[ri]
            n = len(ch)
            rc[b, :n], rl[b, :n], rd[b, :n] = ch, cl, dr
            r_lens[b] = n
            qs = skels[qi] if is_fwd else _rev_skeleton(skels[qi])
            qch, qcl, qdr, _qpo, _qao = qs
            m = len(qch)
            qc[b, :m], ql_[b, :m], qd[b, :m] = qch, qcl, qdr
            q_lens[b] = m
            q_skel_or.append(qs)
        scores, ops_list = _gotoh_batch((rc, rl, rd), (qc, ql_, qd),
                                        r_lens, q_lens, L)
        for b, (ri, qi, _f) in enumerate(grp):
            ops = ops_list[b]
            match_num = sum(l for k, l in ops if k == "M")
            min_match = min(MIN_MATCH, int(r_lens[b]), int(q_lens[b]))
            if match_num < min_match or scores[b] < SCORE_THR \
                    or not _is_proper(ops):
                continue
            per_read_aligned[ri].append((q_skel_or[b], ops))
    return _apply_alignments(ds, chunk_seqs, chunk_ascii, erm, failed,
                             alive, read_ascii, read_codes, margin, W,
                             changed_chunks, pairs, per_read_aligned)


def _align_pairs_native(skels, pairs, per_read_aligned) -> bool:
    """Run the pair DP through the threaded C++ core (native/gotoh_skel.cc).

    Fills ``per_read_aligned`` with (oriented_query_skeleton, ops) for every
    pair passing the score/match/proper filters — identical to the numpy
    batch path.  Returns False when the native library is unavailable (the
    caller then uses the numpy fallback)."""
    from ..native_ext import gotoh_skel_native
    n_reads = len(skels)
    offs = np.zeros(n_reads + 1, np.int64)
    for i, sk in enumerate(skels):
        offs[i + 1] = offs[i] + len(sk[0])
    ch = np.empty(offs[-1], np.int32)
    cl = np.empty(offs[-1], np.int32)
    dr = np.empty(offs[-1], np.uint8)
    for i, (c, l, d, _po, _ao) in enumerate(skels):
        ch[offs[i]:offs[i + 1]] = c
        cl[offs[i]:offs[i + 1]] = l
        dr[offs[i]:offs[i + 1]] = d
    parr = np.asarray([(ri, qi, 1 if f else 0) for ri, qi, f in pairs],
                      np.int32).reshape(-1, 3)
    res = gotoh_skel_native(ch, cl, dr, offs, parr, MIN_MATCH, SCORE_THR)
    if res is None:
        return False
    passed, kinds, lens, starts, counts = res
    km = {1: "M", 2: "I", 3: "D"}
    rev_cache: dict = {}
    for p, (ri, qi, is_fwd) in enumerate(pairs):
        if not passed[p]:
            continue
        s0, n = int(starts[p]), int(counts[p])
        ops = [(km[int(kinds[s0 + t])], int(lens[s0 + t])) for t in range(n)]
        if is_fwd:
            qs = skels[qi]
        else:
            qs = rev_cache.get(qi)
            if qs is None:
                qs = rev_cache[qi] = _rev_skeleton(skels[qi])
        per_read_aligned[ri].append((qs, ops))
    return True


def _apply_alignments(ds, chunk_seqs, chunk_ascii, erm, failed, alive,
                      read_ascii, read_codes, margin, W, changed_chunks,
                      pairs, per_read_aligned) -> int:
    import time as _time
    _tv = _time.time()
    # votes -> candidates
    cands, meta = [], []
    for ri, aligned in per_read_aligned.items():
        er = ds.encoded_reads[ri]
        pileups = _vote_pileups(len(er.nodes), aligned)
        covs = [p.coverage for p in pileups]
        mean_cov = sum(covs) // max(len(covs), 1)
        ins_thr = max(min(mean_cov // 5, INS_THR), 1)
        for idx, key, pos in _collect_candidates(er, pileups, ins_thr,
                                                 failed[ri]):
            chunk_id, _cluster, dz = key
            if chunk_id not in chunk_seqs:
                continue
            zlen = len(chunk_seqs[chunk_id])
            codes = read_codes[ri]
            if pos > len(codes):
                continue
            if dz:
                wstart = pos - margin
            else:
                wstart = len(codes) - (pos + zlen) - margin
            cands.append(Candidate(ri, chunk_id, dz, wstart,
                                   zlen + 2 * margin, 0))
            meta.append((ri, idx, key))
    if not cands:
        for ri in range(len(alive)):
            if ri not in per_read_aligned:
                continue
            alive[ri] = False
        return 0
    _te = _time.time()
    results = extend_candidates(cands, read_codes, chunk_seqs, W=W,
                                margin=margin)
    _tr = _time.time()
    got_insert = set()
    pending = defaultdict(list)
    for res, (ri, idx, key) in zip(results, meta):
        c = res["cand"]
        clen = len(chunk_seqs[c.chunk_id])
        aln_len = max(res["span_end"] - res["span_start"], 1)
        err = res["dist"] / max(aln_len, clen)
        thr = (erm.read_of(ds.encoded_reads[ri].id)
               + erm.chunk_of(c.chunk_id, 0)
               + SIGMA_FACTOR * max(erm.median_abs_dev, 0.005))
        if err > thr:
            failed[ri].add((idx, key))
            continue
        n = _node_from_result(res, read_codes, read_ascii)
        if n is None:
            failed[ri].add((idx, key))
            continue
        pending[ri].append(n)
    added = 0
    for ri in per_read_aligned:
        new = pending.get(ri)
        if not new:
            alive[ri] = False
            continue
        er = ds.encoded_reads[ri]
        prev_n = len(er.nodes)
        new_nodes = [Node.new(d["chunk"], d["is_forward"], d["seq"],
                              d["cigar"], d["start"], 1) for d in new]
        _rebuild(er, read_ascii[ri], list(er.nodes) + new_nodes, chunk_ascii)
        gained = len(er.nodes) - prev_n
        if gained > 0:
            added += gained
            failed[ri].clear()
            alive[ri] = True
            changed_chunks.update(d["chunk"] for d in new)
        else:
            alive[ri] = False
    logger.info("deletion_fill: %d pairs, %d candidates, %d inserted "
                "(vote %.1fs, extend %.1fs, rebuild %.1fs)",
                len(pairs), len(cands), added, _te - _tv, _tr - _te,
                _time.time() - _tr)
    return added
