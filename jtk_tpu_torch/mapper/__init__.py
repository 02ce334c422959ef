"""K4 — seed-chain-extend read↔chunk mapper (replaces minimap2).

The reference shells out to minimap2 for read->chunk mapping (`-c --eqx -P`,
``encode/mod.rs:315-355``) and chunk-overlap detection (`-X -P ava`,
``determine_chunks.rs:255-287``).  The chunk set here is tiny (<=~1000 units of
~2 kbp), so an accelerator-first design needs no general-purpose mapper:

  1. host: packed k-mer index (uint64 2-bit codes) over all chunks, sorted for
     vectorized ``np.searchsorted`` lookup; high-occurrence k-mers are skipped
     (repeat masking, mirroring minimap2's frequency filter);
  2. host: per (chunk, strand) diagonal-bin voting picks candidate placements;
  3. device: every candidate is verified by the K3 banded-alignment kernel
     (chunk globally aligned inside a read window, free window ends), batched
     across all candidates of all reads.

Counterpart of ``jtk_tpu/mapper``: the host seeding and voting are the same
code; candidate verification runs through the port's K3 kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import seq as seqmod
from ..ops.banded_align import (align_with_cigar_batch, decode_indexed,
                                diagonal_offsets)


def pack_kmers(codes: np.ndarray, k: int):
    """All k-mers of ``codes`` packed into uint64; returns (vals, valid).

    Doubling construction: s-mer tables for power-of-two s are combined into
    the k-mer table, so the whole pack is ~2*log2(k) vector passes instead
    of k (the naive per-base loop dominated encode's host time)."""
    codes = np.asarray(codes, np.int8)
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    # k <= 16 fits 2k bits in uint32: half the memory traffic (this matters —
    # the candidate sweep is bandwidth-bound on the host)
    dt = np.uint32 if k <= 16 else np.uint64
    cu = codes.astype(dt) & dt(3)
    bad1 = (codes > 3) | (codes < 0)
    pk = {1: cu}
    bd = {1: bad1}
    s = 1
    while s * 2 <= k:
        a, b_ = pk[s], bd[s]
        pk[2 * s] = (a[:len(a) - s] << dt(2 * s)) | a[s:]
        bd[2 * s] = b_[:len(b_) - s] | b_[s:]
        s *= 2
    val = None
    badv = None
    off, rem = 0, k
    p = 1 << (max(k.bit_length() - 1, 0))
    while rem and p:
        if rem >= p:
            seg = pk[p][off:off + n]
            sb = bd[p][off:off + n]
            if val is None:
                val, badv = seg.copy(), sb.copy()
            else:
                val = (val << dt(2 * p)) | seg
                badv |= sb
            off += p
            rem -= p
        p >>= 1
    return val, ~badv


def hpc_compress(codes: np.ndarray):
    """Homopolymer-compress ``codes``: (compressed, raw_start_positions).

    minimap2's ``-H`` seeds on the HPC sequence (reference invokes it for
    CCS/CLR, encode/mod.rs:344-349); positions map back to raw coordinates
    so diagonal voting still happens in raw space."""
    codes = np.asarray(codes, np.int8)
    if len(codes) == 0:
        return codes, np.zeros(0, np.int64)
    keep = np.ones(len(codes), bool)
    keep[1:] = codes[1:] != codes[:-1]
    idx = np.nonzero(keep)[0]
    return codes[idx], idx


@dataclass
class Candidate:
    read_idx: int
    chunk_id: int
    is_forward: bool
    window_start: int  # in strand coordinates (rc coords when reverse)
    window_len: int
    n_hits: int


class ChunkIndex:
    """Sorted k-mer table over the chunk set."""

    def __init__(self, chunk_seqs: dict[int, np.ndarray], k: int = 15,
                 max_occ: int = 64, hpc: bool = False):
        self.k = k
        self.max_occ = max_occ
        self.hpc = hpc
        self.chunk_len = {cid: len(s) for cid, s in chunk_seqs.items()}
        km, cid_arr, pos_arr = [], [], []
        for cid, codes in chunk_seqs.items():
            codes = np.asarray(codes, np.int8)
            if hpc:
                codes, raw_idx = hpc_compress(codes)
            vals, ok = pack_kmers(codes, k)
            idx = np.nonzero(ok)[0]
            km.append(vals[idx])
            cid_arr.append(np.full(len(idx), cid, np.int64))
            # index stores RAW positions so read-vs-chunk diagonals live in
            # raw coordinate space even under HPC seeding
            pos_arr.append((raw_idx[idx] if hpc else idx).astype(np.int32))
        if km:
            km = np.concatenate(km)
            cid_arr = np.concatenate(cid_arr)
            pos_arr = np.concatenate(pos_arr)
        else:
            km = np.zeros(0, np.uint64)
            cid_arr = np.zeros(0, np.int64)
            pos_arr = np.zeros(0, np.int32)
        order = np.argsort(km, kind="stable")
        self.kmers = km[order]
        self.cids = cid_arr[order]
        self.poss = pos_arr[order]

    def _hits(self, read_kmers: np.ndarray, valid: np.ndarray):
        """(read_pos, chunk_id, chunk_pos) for every index hit."""
        rk = read_kmers[valid]
        rpos = np.nonzero(valid)[0]
        lo = np.searchsorted(self.kmers, rk, "left")
        hi = np.searchsorted(self.kmers, rk, "right")
        occ = hi - lo
        keep = (occ > 0) & (occ <= self.max_occ)
        lo, hi, rpos = lo[keep], hi[keep], rpos[keep]
        occ = hi - lo
        if len(lo) == 0:
            return (np.zeros(0, np.int64),) * 3
        idx = np.repeat(lo, occ) + (
            np.arange(occ.sum()) - np.repeat(np.cumsum(occ) - occ, occ))
        read_pos = np.repeat(rpos, occ)
        return read_pos, self.cids[idx], self.poss[idx].astype(np.int64)

    def candidates_one_strand(self, codes: np.ndarray, read_idx: int,
                              is_forward: bool, min_hits: int, margin: int,
                              stride: int = 3):
        codes = np.asarray(codes, np.int8)
        raw_idx = None
        if self.hpc:
            codes, raw_idx = hpc_compress(codes)
        vals, ok = pack_kmers(codes, self.k)
        if stride > 1:
            sl = np.zeros_like(ok)
            sl[::stride] = True
            ok = ok & sl
        rp, cid, cp = self._hits(vals, ok)
        if len(rp) == 0:
            return []
        if raw_idx is not None:
            rp = raw_idx[rp]
        diag = rp - cp
        BIN = 128
        dbin = diag // BIN
        key = cid * (1 << 22) + (dbin + (1 << 20))
        out = []
        order = np.argsort(key, kind="stable")
        key_s, rp_s, cid_s, diag_s, cp_s = (key[order], rp[order], cid[order],
                                            diag[order], cp[order])
        uniq, starts, counts = np.unique(key_s, return_index=True,
                                         return_counts=True)
        # merge adjacent bins for the same chunk
        taken = set()
        cnt_by_key = dict(zip(uniq.tolist(), counts.tolist()))
        for u, st, ct in zip(uniq, starts, counts):
            c2 = ct + cnt_by_key.get(int(u) + 1, 0)
            if c2 < min_hits:
                continue
            prev = cnt_by_key.get(int(u) - 1, 0)
            if prev > ct:  # the pair (u-1, u) is better started at u-1
                continue
            cidv = int(cid_s[st])
            if (cidv, int(u)) in taken or (cidv, int(u) - 1) in taken:
                continue
            taken.add((cidv, int(u)))
            taken.add((cidv, int(u) + 1))
            sel = slice(st, st + ct)
            dmed = int(np.median(diag_s[sel]))
            clen = self.chunk_len[cidv]
            wstart = dmed - margin
            wlen = clen + 2 * margin
            out.append(Candidate(read_idx, cidv, is_forward, wstart, wlen,
                                 int(c2)))
        return out

    def candidates(self, codes: np.ndarray, read_idx: int, min_hits: int = 4,
                   margin: int = 200, stride: int = 3):
        fwd = self.candidates_one_strand(codes, read_idx, True, min_hits,
                                         margin, stride)
        rc = seqmod.revcomp(codes)
        rev = self.candidates_one_strand(rc, read_idx, False, min_hits,
                                         margin, stride)
        return fwd + rev

    def _candidates_native(self, blob, starts, lens, lane_meta, min_hits,
                           margin, stride):
        """Candidate voting via native/kmer_vote.cc (None = unavailable)."""
        from ..native_ext import kmer_vote_native
        if getattr(self, "_kmers_u64", None) is None:
            self._kmers_u64 = np.ascontiguousarray(self.kmers, np.uint64)
            self._cids_i32 = np.ascontiguousarray(self.cids, np.int32)
            self._poss_i32 = np.ascontiguousarray(self.poss, np.int32)
        phases = (stride - starts % stride) % stride if stride > 1 \
            else np.zeros(len(starts), np.int64)
        got = kmer_vote_native(blob, starts, lens, phases,
                               self._kmers_u64, self._cids_i32,
                               self._poss_i32, self.k, stride, self.max_occ,
                               min_hits, 128)
        if got is None:
            return None
        lane, cid, dmed, c2 = got
        out = []
        for i in range(len(lane)):
            cidv = int(cid[i])
            ri, fwdb = lane_meta[int(lane[i])]
            out.append(Candidate(ri, cidv, fwdb, int(dmed[i]) - margin,
                                 self.chunk_len[cidv] + 2 * margin,
                                 int(c2[i])))
        return out

    def candidates_batch(self, read_codes: list, min_hits: int = 4,
                         margin: int = 200, stride: int = 3):
        """All reads' candidates in one vectorized sweep: k-mers of every
        read (both strands) packed and looked up together, diagonal-bin
        votes keyed by (read, strand, chunk, bin) in one np.unique pass.

        A native threaded scanner (native/kmer_vote.cc) does the rolling
        k-mer + voting pass when available — identical semantics, one pass
        per read lane instead of several numpy vector passes over the blob
        (the reference leans on minimap2's internal seeding threads here,
        encode/mod.rs:342-351); this numpy body is the fallback."""
        if not read_codes:
            return []
        k = self.k
        lane_codes = []
        lane_meta = []   # (read_idx, is_forward)
        lane_raw = []    # hpc: per-lane raw positions of compressed chars
        for ri, codes in enumerate(read_codes):
            fwd = np.asarray(codes, np.int8)
            rev = seqmod.revcomp(fwd)
            if self.hpc:
                fwd, fri = hpc_compress(fwd)
                rev, rri = hpc_compress(rev)
                lane_raw.extend([fri, rri])
            lane_codes.append(fwd)
            lane_meta.append((ri, True))
            lane_codes.append(rev)
            lane_meta.append((ri, False))
        lens = np.array([len(c) for c in lane_codes], np.int64)
        # separator of k-1 sentinel chars kills cross-boundary k-mers
        sep = np.full(k - 1, 7, np.int8)
        blob = np.concatenate([x for c in lane_codes for x in (c, sep)])
        starts = np.concatenate([[0], np.cumsum(lens + k - 1)])[:-1]
        if not self.hpc:
            # the native rolling scanner seeds on raw k-mers only
            native = self._candidates_native(blob, starts, lens, lane_meta,
                                             min_hits, margin, stride)
            if native is not None:
                return native
        vals, ok = pack_kmers(blob, k)
        if stride > 1:
            sl = np.zeros_like(ok)
            sl[::stride] = True
            ok &= sl
        rp, cid, cp = self._hits(vals, ok)
        if len(rp) == 0:
            return []
        lane = np.searchsorted(starts, rp, "right") - 1
        rpos = rp - starts[lane]
        if self.hpc:
            # raw-coordinate read positions via a blob-parallel raw-position
            # array (separator rows cannot match: sentinel 7 k-mers are
            # invalid)
            sep_raw = np.zeros(k - 1, np.int64)
            rawpos_blob = np.concatenate(
                [x for r in lane_raw for x in (r, sep_raw)]) \
                if lane_raw else np.zeros(0, np.int64)
            rpos = rawpos_blob[rp]
        diag = rpos - cp
        BIN = 128
        dbin = diag // BIN + (1 << 20)
        key = (lane.astype(np.int64) << 44) | (cid << 22) | dbin
        order = np.argsort(key, kind="stable")
        key_s, diag_s = key[order], diag[order]
        uniq, starts_u, counts = np.unique(key_s, return_index=True,
                                           return_counts=True)
        cnt_by_key = dict(zip(uniq.tolist(), counts.tolist()))
        out = []
        taken = set()
        for u, st, ct in zip(uniq.tolist(), starts_u, counts):
            c2 = ct + cnt_by_key.get(u + 1, 0)
            if c2 < min_hits:
                continue
            prev = cnt_by_key.get(u - 1, 0)
            if prev > ct:
                continue
            lane_i = u >> 44
            cidv = int((u >> 22) & ((1 << 22) - 1))
            if (lane_i, cidv, u) in taken or (lane_i, cidv, u - 1) in taken:
                continue
            taken.add((lane_i, cidv, u))
            taken.add((lane_i, cidv, u + 1))
            sel = slice(st, st + ct)
            dmed = int(np.median(diag_s[sel]))
            clen = self.chunk_len[cidv]
            ri, fwdb = lane_meta[lane_i]
            out.append(Candidate(ri, cidv, fwdb, dmed - margin,
                                 clen + 2 * margin, int(c2)))
        return out


def extend_candidates(cands: list[Candidate], read_codes: list[np.ndarray],
                      chunk_seqs: dict[int, np.ndarray], W: int = 256,
                      margin: int = 200, batch: int = 2048):
    """Verify candidates with the K3 kernel: chunk globally aligned inside the
    read window (free window ends).  Returns per-candidate dicts with
    dist, cigar (chunk-as-query), window span, and strand-coord positions.

    The chunk blob is copied to every entry of the device set
    (:func:`jtk_tpu_torch.runtime.devices`) once a call, and each batch's
    candidates are cut over the set (K3 and its walk run per shard), the
    results gathered in candidate order: integer work, the same at any
    device count.
    """
    if not cands:
        return []
    import logging
    import time as _time

    import torch

    from ..ops.edit_dp import extend_hostwin_packed, to_host
    from ..parallel import gather, on_entry, replicate, shard_bounds
    from ..runtime import devices
    _logger = logging.getLogger(__name__)
    _t0 = _time.time()
    devs = devices()
    cid_list = sorted(chunk_seqs)
    cidx_of = {cid: i for i, cid in enumerate(cid_list)}
    # the DP runs over Qpad rows (at least 2048: the production chunk
    # length); rows past each chunk's length are frozen
    Qpad = max(2048, ((max(len(chunk_seqs[c]) for c in cid_list) + 127)
                      // 128) * 128)
    Tpad = ((max(c.window_len for c in cands) + 511) // 512) * 512
    chunks_blob = np.full((len(cid_list), Qpad), 4, np.int8)
    chunk_lens = np.ones(len(cid_list), np.int32)
    for i, cid in enumerate(cid_list):
        s = chunk_seqs[cid]
        chunks_blob[i, :len(s)] = s
        chunk_lens[i] = len(s)
    dev_blob, dev_lens = replicate(
        devs, torch.as_tensor(chunks_blob, dtype=torch.int32),
        torch.as_tensor(chunk_lens, dtype=torch.int64))
    # flat [fwd reads | rc reads] blob for the vectorized window gather:
    # one clip-mode np.take builds every window row.  RC coordinates match
    # the candidate sweep's (window_start is emitted in RC-read coords for
    # reverse candidates).
    read_lens = np.array([len(r) for r in read_codes], np.int64)
    read_starts = np.zeros(len(read_codes) + 1, np.int64)
    np.cumsum(read_lens, out=read_starts[1:])
    _blob_fwd = (np.concatenate(read_codes).astype(np.int8, copy=False)
                 if read_codes else np.zeros(0, np.int8))
    _blob_rc = (np.concatenate([seqmod.revcomp(r) for r in read_codes])
                .astype(np.int8, copy=False)
                if read_codes else np.zeros(0, np.int8))
    read_blob = np.concatenate([_blob_fwd, _blob_rc, np.zeros(1, np.int8)])
    rc_base = len(_blob_fwd)
    results = []
    overflow = []
    pre_redo = []  # candidates whose window holds a code >3 (N): these rare
    # rows take the legacy (dense, N-safe) path, as in the reference
    for s in range(0, len(cands), batch):
        grp = cands[s:s + batch]
        B = len(grp)
        ri_a = np.array([c.read_idx for c in grp], np.int64)
        fw_a = np.array([c.is_forward for c in grp], bool)
        ws_a = np.array([c.window_start for c in grp], np.int64)
        wl_a = np.array([c.window_len for c in grp], np.int64)
        a_a = np.maximum(ws_a, 0)
        bnd_a = np.minimum(ws_a + wl_a, read_lens[ri_a])
        wlen = np.maximum(bnd_a - a_a, 0)
        # int64 gather indices: no wrap however many read bases the blob holds
        base = np.where(fw_a, 0, rc_base) + read_starts[ri_a] + a_a
        col = np.arange(Tpad, dtype=np.int64)
        idx = np.minimum(base[:, None] + col[None, :], len(read_blob) - 1)
        rows = np.where(col[None, :] < wlen[:, None],
                        read_blob.take(idx), 0).astype(np.int8)
        has_n = rows.max(axis=1, initial=0) > 3
        for b in np.nonzero(has_n)[0]:
            pre_redo.append(grp[b])
            wlen[b] = 0
        rows[has_n] = 0
        cc = np.array([cidx_of[c.chunk_id] for c in grp], np.int64)
        t_lens = np.maximum(wlen, 1)
        parts = []
        for i, (a, b) in enumerate(shard_bounds(B, len(devs))):
            if a == b:
                continue
            with on_entry(i):
                parts.append(extend_hostwin_packed(
                    dev_blob[i], dev_lens[i], cc[a:b], rows[a:b], ws_a[a:b],
                    a_a[a:b], t_lens[a:b], W, Qpad, Tpad, margin,
                    device=devs[i]))
        meta, ops_packed, delpack = to_host(
            *(gather([p[n] for p in parts], devs[0]) for n in range(3)))
        q_lens = [len(chunk_seqs[c.chunk_id]) for c in grp]
        decoded = decode_indexed(meta, ops_packed, delpack, q_lens)
        for c, (score, sj, ej, cigar, valid) in zip(grp, decoded):
            rec = {
                "cand": c,
                "dist": score if valid else (1 << 30),
                "ops": cigar,
                "span_start": sj,
                "span_end": ej,
            }
            if not valid:
                # a window shorter than half the chunk can never reach the
                # identity threshold: a guaranteed reject, no redo.  Only
                # >DEL_TOPK deletion runs (rare) need the dense legacy pass.
                a = max(c.window_start, 0)
                bnd = min(c.window_start + c.window_len,
                          len(read_codes[c.read_idx]))
                if bnd - a >= len(chunk_seqs[c.chunk_id]) // 2:
                    overflow.append(rec)
            results.append(rec)
    _logger.info("extend: %d cands in %.2fs", len(cands), _time.time() - _t0)
    if pre_redo:
        redo_set = {id(c) for c in pre_redo}
        seen = {id(rec) for rec in overflow}
        for rec in results:
            if id(rec["cand"]) in redo_set and id(rec) not in seen:
                rec["dist"] = 1 << 30
                overflow.append(rec)
    if overflow:
        # rare rows (N windows / >DEL_TOPK deletion runs): redo on the
        # legacy per-candidate path
        redo = _extend_legacy([r["cand"] for r in overflow], read_codes,
                              chunk_seqs, W, margin)
        for rec, new in zip(overflow, redo):
            rec.update(new)
    return results


def _extend_legacy(cands, read_codes, chunk_seqs, W, margin):
    """Dense (N-safe, unpacked) redo path.  Batched: candidates of one
    padded shape (Qpad x Tpad) share one K3 batch."""
    out = [None] * len(cands)
    jobs = {}  # (Qp, Tp) -> list of (orig_idx, cseq, win, a, diag)
    for i, c in enumerate(cands):
        cseq = chunk_seqs[c.chunk_id]
        rseq = read_codes[c.read_idx]
        if not c.is_forward:
            rseq = seqmod.revcomp(rseq)
        a = max(c.window_start, 0)
        bnd = min(c.window_start + c.window_len, len(rseq))
        win = rseq[a:bnd]
        if len(win) < 8:
            out[i] = {"dist": 1 << 30, "ops": [],
                      "span_start": a, "span_end": a}
            continue
        Qp = ((len(cseq) + 127) // 128) * 128
        Tp = ((len(win) + 255) // 256) * 256
        diag = c.window_start + margin - a
        jobs.setdefault((Qp, Tp), []).append((i, cseq, win, a, diag))
    for (Qp, Tp), grp in jobs.items():
        B = len(grp)
        qs = np.full((B, Qp), 4, np.int8)
        rs = np.full((B, Tp), 4, np.int8)
        q_lens = np.ones(B, np.int32)
        t_lens = np.ones(B, np.int32)
        offs = np.zeros((B, Qp + 1), np.int32)
        for b, (_i, cseq, win, _a, diag) in enumerate(grp):
            qs[b, :len(cseq)] = cseq
            rs[b, :len(win)] = win
            q_lens[b] = len(cseq)
            t_lens[b] = len(win)
            offs[b] = diagonal_offsets(len(cseq), diag, len(win), Qp, W)
        res = align_with_cigar_batch(qs, rs, offs, q_lens, t_lens, W,
                                     "infix")
        for b, (i, _cseq, _win, a, _diag) in enumerate(grp):
            out[i] = {"dist": int(res["score"][b]), "ops": res["cigar"][b],
                      "span_start": int(a + res["start_j"][b]),
                      "span_end": int(a + res["end_j"][b])}
    return out


def flip_cigar(ops):
    """Chunk-as-query cigar -> read-as-query cigar (swap I/D)."""
    sw = {"M": "M", "I": "D", "D": "I"}
    return [(sw[k], l) for k, l in ops]
