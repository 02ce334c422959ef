"""Banded edit-distance alignment with traceback (K3 on the card).

Counterpart of ``jtk_tpu/ops/banded_align.py``: the numpy band geometry
(``linear_offsets``, ``diagonal_offsets``), the host-side result decoding
and CIGAR expansion, and the alignment entry points.  Every DP here runs
through the K3 kernel (:mod:`jtk_tpu_torch.ops.edit_dp`) — global and infix
modes share it; row-0 init and the score/end selection stay in
:func:`~jtk_tpu_torch.ops.edit_dp.k3_batch`.  The band width W is never
rounded in these paths: a wider band changes the alignment.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native_ext, trace
from ..runtime import resolve
from .edit_dp import DEL_TOPK, edit_dp, k3_batch, k3_inputs, pack_results, \
    select_end, to_host

INF = np.int32(2 ** 30)
DIAG, UP, LEFT = np.uint8(0), np.uint8(1), np.uint8(2)
_KM = {1: "M", 2: "I", 3: "D"}

__all__ = ["DEL_TOPK", "linear_offsets", "linear_offsets_block",
           "diagonal_offsets", "pack2bit",
           "decode_indexed", "align_with_cigar_batch", "dispatch_align_cigar",
           "collect_align_cigar", "banded_align_batch", "traceback_batch",
           "ops_rle", "edit_align"]


def linear_offsets(q_len: int, t_len: int, Q: int, W: int) -> np.ndarray:
    """Band start per query row for a global alignment: the band follows the
    straight line from (0,0) to (q_len, t_len).

    Increments are forced into {0, 1} so kernels can use static shifts
    instead of general gathers (requires W//2 >= t_len - q_len when
    t_len > q_len; asserted)."""
    assert t_len - q_len < W - 1, \
        f"band W={W} too narrow for global q={q_len} t={t_len}"
    i = np.arange(Q + 1, dtype=np.int64)
    center = np.round(i * (t_len / max(q_len, 1))).astype(np.int64)
    center[q_len:] = t_len
    hi = max(t_len - W + 1, 0)
    off = np.clip(center - W // 2, 0, hi)
    # enforce non-decreasing with unit steps
    off = np.maximum.accumulate(off)
    off = np.minimum.accumulate(off - i) + i
    # reachability of (q_len, t_len): slope-1 lower-bound line
    line = (t_len - W + 1) - (q_len - i)
    off = np.maximum(off, np.clip(line, 0, None))
    off = np.clip(off, 0, hi)
    off[q_len:] = off[q_len]
    assert off[q_len] <= t_len <= off[q_len] + W - 1
    return off.astype(np.int32)


def linear_offsets_block(q_lens, t_lens, Q: int, W: int) -> np.ndarray:
    """:func:`linear_offsets` of every pair as one (B, Q + 1) int32 block:
    one call of the native ``band_offsets`` library, or where it is not
    built its twin, :func:`linear_offsets` row by row.  The rows of each
    are counted (``band_offsets.native_rows``, ``band_offsets.twin_rows``)."""
    out = native_ext.band_offsets_native(q_lens, t_lens, Q, W)
    if out is not None:
        trace.count("band_offsets.native_rows", len(out))
        return out
    out = np.stack([linear_offsets(int(q), int(t), Q, W)
                    for q, t in zip(q_lens, t_lens)])
    trace.count("band_offsets.twin_rows", len(out))
    return out


def diagonal_offsets(q_len: int, diag: int, t_len: int, Q: int, W: int) -> np.ndarray:
    """Band start per row for an infix alignment around ref diagonal ``diag``
    (ref position where query position 0 lands)."""
    i = np.arange(Q + 1, dtype=np.int64)
    hi = max(t_len - W + 1, 0)
    off = np.clip(diag + i - W // 2, 0, hi)
    off[q_len:] = off[q_len]
    return off.astype(np.int32)


def pack2bit(codes: np.ndarray) -> np.ndarray:
    """Host-side 2-bit base packing along the last axis (len must be a
    multiple of 4; content must be 0..3 — pad rows by 0 and mask with the
    length vector on device).  Cuts host->device window transfers 4x on
    slow links."""
    b = codes.reshape(*codes.shape[:-1], -1, 4).astype(np.uint8)
    return (b[..., 0] | (b[..., 1] << 2) | (b[..., 2] << 4)
            | (b[..., 3] << 6))


def _expand_cigars_batch(ops_packed, del_vals, del_idx, q_lens, lead_d):
    """All-rows cigar expansion: native single pass when available, else the
    per-row numpy fallback.  Returns a list of [(kind, len)] cigars."""
    B = len(q_lens)
    from ..native_ext import cigar_expand_native
    got = cigar_expand_native(np.asarray(ops_packed), del_vals, del_idx,
                              np.asarray(q_lens, np.int32),
                              np.asarray(lead_d, np.int32))
    if got is not None:
        kinds, lens, row_off = got
        kl = np.array([" ", "M", "I", "D"])[kinds].tolist()
        ll = lens.tolist()
        return [list(zip(kl[row_off[b]:row_off[b + 1]],
                         ll[row_off[b]:row_off[b + 1]])) for b in range(B)]
    Q = ops_packed.shape[1] * 8
    is_ins = np.unpackbits(np.asarray(ops_packed), axis=1,
                           bitorder="little")[:, :Q].astype(bool)
    del_idx = del_idx.astype(np.int64)
    out = []
    for b in range(B):
        ql = int(q_lens[b])
        dels_b = np.zeros(ql, np.int64)
        nz = del_vals[b] > 0
        idx = del_idx[b][nz]
        okm = idx < ql
        dels_b[idx[okm]] = del_vals[b][nz][okm]
        out.append(_expand_cigar(is_ins[b, :ql][::-1], dels_b[::-1],
                                 int(lead_d[b])))
    return out


def decode_indexed(meta, ops_packed, delpack, q_lens):
    meta = np.asarray(meta)
    delpack = np.asarray(delpack)
    score = meta[:, 0]
    end_j = meta[:, 1]
    start_j = meta[:, 2]
    n_runs = meta[:, 3]
    valid = meta[:, 4].astype(bool)
    astart = meta[:, 5]
    kh = delpack.shape[1] // 2
    del_vals = delpack[:, :kh]
    del_idx = delpack[:, kh:]
    B = len(score)
    cigars = _expand_cigars_batch(ops_packed, del_vals, del_idx, q_lens,
                                  np.zeros(B, np.int32))
    out = []
    for b in range(B):
        too_many = n_runs[b] > del_vals.shape[1]
        out.append((int(score[b]), int(astart[b] + start_j[b]),
                    int(astart[b] + end_j[b]), cigars[b],
                    bool(valid[b]) and not too_many))
    return out


def _expand_cigar(is_ins_fwd, dels_fwd, lead_d):
    """Vectorized run-building: forward-order per-row (op, D-run) -> cigar."""
    n = len(is_ins_fwd)
    kinds = np.empty(2 * n + 1, np.uint8)
    lens = np.empty(2 * n + 1, np.int64)
    kinds[0] = 3
    lens[0] = lead_d
    kinds[1::2] = np.where(is_ins_fwd, 2, 1)
    lens[1::2] = 1
    kinds[2::2] = 3
    lens[2::2] = dels_fwd
    keep = lens > 0
    kinds, lens = kinds[keep], lens[keep]
    if len(kinds) == 0:
        return []
    starts = np.concatenate([[0], np.flatnonzero(np.diff(kinds)) + 1])
    sums = np.add.reduceat(lens, starts)
    return [(_KM[int(k)], int(l)) for k, l in zip(kinds[starts], sums)]


def _device_rows(qs, rs, offsets, q_lens, t_lens, device=None):
    dev = resolve(device)
    def t(x, dt):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)
    return (t(qs, torch.int32), t(rs, torch.int32), t(offsets, torch.int64),
            t(q_lens, torch.int64), t(t_lens, torch.int64))


def dispatch_align_cigar(qs, rs, offsets, q_lens, t_lens, W: int,
                         mode: str = "global"):
    """Run the device part of :func:`align_with_cigar_batch` (K3 + traceback
    + packing); returns a handle for :func:`collect_align_cigar`."""
    qs = np.asarray(qs)
    rs = np.asarray(rs)
    offsets = np.asarray(offsets)
    q_lens = np.asarray(q_lens, np.int32)
    t_lens = np.asarray(t_lens, np.int32)
    q, r, off, ql, tl = _device_rows(qs, rs, offsets, q_lens, t_lens)
    handle = pack_results(*k3_batch(q, r, off, ql, tl, W, mode))
    return handle, (qs, rs, offsets, q_lens, t_lens, W, mode)


def collect_align_cigar(dispatched):
    """Fetch + decode a handle from :func:`dispatch_align_cigar`."""
    handle, (qs, rs, offsets, q_lens, t_lens, W, mode) = dispatched
    return _decode_align_results(to_host(*handle), qs, rs, offsets, q_lens,
                                 t_lens, W, mode)


def align_with_cigar_batch(qs, rs, offsets, q_lens, t_lens, W: int,
                           mode: str = "global"):
    """Batched alignment with device-side traceback.  Returns a dict of
    score, end_j, start_j and cigar ([(kind, len)] lists, query = qs rows)."""
    return collect_align_cigar(dispatch_align_cigar(
        qs, rs, offsets, q_lens, t_lens, W, mode))


def _decode_align_results(handle, qs, rs, offsets, q_lens, t_lens, W, mode):
    meta, ops_packed, delpack = handle
    meta = np.asarray(meta)
    delpack = np.asarray(delpack)
    score = meta[:, 0].copy()
    end_j = meta[:, 1].copy()
    start_j = meta[:, 2].copy()
    n_runs = meta[:, 3]
    k_half = delpack.shape[1] // 2
    del_vals = delpack[:, :k_half]
    del_idx = delpack[:, k_half:]
    B = len(score)
    overflow = n_runs > del_vals.shape[1]
    # step t covers query char ql-1-t; forward order = reversed rows
    lead = (start_j if mode == "global" else np.zeros(B, np.int32))
    cigars = _expand_cigars_batch(ops_packed, del_vals, del_idx, q_lens,
                                  lead)
    # rare overflow (> DEL_TOPK deletion runs): fall back to the dense path
    if overflow.any():
        idxs = np.nonzero(overflow)[0]
        res = banded_align_batch(qs[idxs], rs[idxs], offsets[idxs],
                                 np.asarray(q_lens)[idxs],
                                 np.asarray(t_lens)[idxs], W, mode)
        ops_l, starts = traceback_batch(res["ptrs"], offsets[idxs],
                                        np.asarray(q_lens)[idxs],
                                        res["end_j"], mode)
        for j, b in enumerate(idxs):
            cigars[b] = ops_rle(ops_l[j])
            score[b] = res["score"][j]
            end_j[b] = res["end_j"][j]
            start_j[b] = starts[j] if mode != "global" else 0
    # for global alignments the leading deletion run is part of the cigar,
    # so the alignment's ref start is 0 (matches traceback_batch semantics)
    if mode == "global":
        start_j = np.zeros_like(start_j)
    return {
        "score": score,
        "end_j": end_j,
        "start_j": start_j,
        "cigar": cigars,
    }


def banded_align_batch(qs, rs, offsets, q_lens, t_lens, W: int,
                       mode: str = "global"):
    """Batched banded alignment through K3. All args numpy; returns numpy.

    qs (B, Q) int8, rs (B, T) int8, offsets (B, Q+1) int32.
    Returns dict with score (B,), end_j (B,), ptrs (B, Q+1, W) uint8."""
    q, r, off, ql, tl = _device_rows(qs, rs, offsets, q_lens, t_lens)
    e0, qs32, shifts, inc, rc0, j0 = k3_inputs(q, r, off, tl, W, mode)
    packed, last = edit_dp(e0, qs32, shifts, inc, rc0, j0,
                           ql.to(torch.int32), tl.to(torch.int32))
    score, end_j = select_end(last, off, ql, tl, W, mode)
    Q, B, _ = packed.shape
    ptrs = np.zeros((B, Q + 1, W), np.uint8)
    ptrs[:, 1:] = (packed & 3).to(torch.uint8).permute(1, 0, 2).cpu().numpy()
    # rows past each q_len are frozen, never traced back, and on the card
    # never written: zero them on every device
    ptrs[np.arange(Q + 1)[None] > np.asarray(q_lens)[:, None]] = 0
    return {
        "score": score.cpu().numpy().astype(np.int32),
        "end_j": end_j.cpu().numpy().astype(np.int32),
        "ptrs": ptrs,
    }


def traceback_batch(ptrs, offsets, q_lens, end_js, mode: str = "global"):
    """Decode packed pointers into op strings, vectorized across the batch.

    Returns a list of op lists (chars 'M'/'I'/'D', query-leading order) and the
    ref start position for each alignment.
    """
    ptrs = np.asarray(ptrs)
    offsets = np.asarray(offsets)
    B, Qp1, W = ptrs.shape
    i = np.asarray(q_lens, np.int64).copy()
    j = np.asarray(end_js, np.int64).copy()
    if mode == "global":
        active = (i > 0) | (j > 0)
    else:
        active = i > 0
    max_steps = int(Qp1 + offsets.max() + W + 2)
    out = np.zeros((B, max_steps), dtype=np.uint8)  # 0=none, 1=M, 2=I, 3=D
    step = 0
    bidx = np.arange(B)
    while active.any() and step < max_steps:
        k = j - offsets[bidx, np.clip(i, 0, Qp1 - 1)]
        k = np.clip(k, 0, W - 1)
        p = ptrs[bidx, np.clip(i, 0, Qp1 - 1), k]
        # boundary rules: i==0 -> only D (global) / stop (infix); j==0 -> only I
        at_top = i == 0
        at_left = j == 0
        opcode = np.where(p == DIAG, 1, np.where(p == UP, 2, 3)).astype(np.uint8)
        opcode = np.where(at_top, 3, opcode)           # row 0: eat ref
        opcode = np.where(at_left & ~at_top, 2, opcode)  # col 0: eat query
        if mode != "global":
            active_now = active & ~at_top
        else:
            active_now = active
        opcode = np.where(active_now, opcode, 0)
        out[bidx, step] = opcode
        di = np.where((opcode == 1) | (opcode == 2), 1, 0)
        dj = np.where((opcode == 1) | (opcode == 3), 1, 0)
        i = i - di
        j = j - dj
        if mode == "global":
            active = (i > 0) | (j > 0)
        else:
            active = i > 0
        step += 1
    kinds = np.array([" ", "M", "I", "D"])
    ops_list = []
    for b in range(B):
        codes = out[b, :step][out[b, :step] != 0][::-1]
        ops_list.append([kinds[c] for c in codes])
    ref_starts = j
    return ops_list, ref_starts


def ops_rle(ops):
    """Run-length encode a flat op list into CIGAR tuples."""
    out = []
    for k in ops:
        if out and out[-1][0] == k:
            out[-1] = (k, out[-1][1] + 1)
        else:
            out.append((k, 1))
    return out


def edit_align(q: np.ndarray, r: np.ndarray, W: int = 128, mode: str = "global",
               diag: int | None = None):
    """Convenience single-pair API: returns (score, cigar, ref_start, ref_end)."""
    Q, T = len(q), len(r)
    if mode == "global":
        off = linear_offsets(Q, T, Q, W)
    else:
        off = diagonal_offsets(Q, diag if diag is not None else 0, T, Q, W)
    res = banded_align_batch(q[None].astype(np.int8), r[None].astype(np.int8),
                             off[None], np.array([Q]), np.array([T]), W, mode)
    ops, ref_starts = traceback_batch(res["ptrs"], off[None], np.array([Q]),
                                      res["end_j"], mode)
    return int(res["score"][0]), ops_rle(ops[0]), int(ref_starts[0]), int(res["end_j"][0])
