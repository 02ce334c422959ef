"""K3 — banded unit-cost edit DP with a packed traceback stream.

Counterpart of ``jtk_tpu/ops/pallas_k3.py``.  :func:`edit_dp` is the kernel
wrapper: on a CUDA tensor it launches the hand-written kernel
``csrc/edit_dp.cu`` (any W, :func:`edit_dp_geometry`); on a CPU
tensor it runs :func:`edit_dp_plain`, the same function in plain PyTorch.
:func:`traceback_packed` walks the stream back from each pair's end: on a
CUDA tensor it launches the walk kernel of the same source, on a CPU
tensor it runs :func:`traceback_packed_plain`.  Around them sit the glue of
``pallas_extend_hostwin`` (band offsets, window setup, score/end
selection and the result packing: insertion bitmask, top-``DEL_TOPK``
deletion runs, 6-column meta) and the shared entry point :func:`k3_batch`
used by every alignment in the port.

Band conventions (as in the reference): offsets have unit increments,
``rc[k] = r[j-1]`` for ``j = off_i + k``.  The stream is ``(Q, B, W)``
int16 (int32 above STREAM_INT16_W lanes, :func:`cell_dtype`) holding
``ptr | left_run << 2`` (ptr 0 = diag, 1 = up, 2 = left; diag wins ties
over up over left).  Only the rows of each pair up to its
``q_len`` hold cells (the walk reads no others); ``last`` is the state at
row ``q_len``.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_build import Launches, check, launch

INF = 1 << 30
DEL_TOPK = 192
STREAM_INT16_W = 8192   # ptr | run << 2 with run < W fits an int16
WARP_FORM_W = 2048      # 16 warps x 4 lanes: the widest warp-form band
MAX_LANES = 4           # band lanes a thread keeps in the warp form
MAX_WARPS = 16          # warps of a pair in the warp form
MAX_THREADS = 1024      # threads of a pair's block in the block form
# the (Q, B, W) stream of one launch stays under 2 GB
STREAM_BYTES = 1 << 31
# the scratch form's state lies in shared memory up to this many bytes
EDIT_SMEM_STATE = 200 * 1024

LAUNCHES = Launches("edit_dp")
TB_LAUNCHES = Launches("edit_tb")


def edit_dp_geometry(W: int) -> tuple[int, int, int]:
    """Launch geometry of the K3 kernel for band width ``W``: (lanes per
    thread, warps per pair, pairs per block).  Up to WARP_FORM_W the warp
    form: the fewest lanes up to MAX_LANES that one warp needs, then as
    many warps as the band needs, 4 warps a block (or one wider pair).
    Above, the block form: one pair a block of at most MAX_THREADS threads,
    4 lanes a thread (8 above 4096).  Above STREAM_INT16_W the scratch
    form: MAX_THREADS threads, ceil(W / MAX_THREADS) lanes a thread, any
    width (:func:`edit_state_bytes`)."""
    if W < 1:
        raise ValueError(f"edit_dp: band width {W} below 1")
    if W <= WARP_FORM_W:
        lanes = 1
        while lanes < MAX_LANES and 32 * lanes < W:
            lanes *= 2
        warps = -(-W // (32 * lanes))
        return lanes, warps, max(1, 4 // warps)
    if W > STREAM_INT16_W:
        return -(-W // MAX_THREADS), MAX_THREADS // 32, 1
    lanes = 4 if W <= 4 * MAX_THREADS else 8
    return lanes, -(-W // (32 * lanes)), 1


def cell_dtype(W: int) -> torch.dtype:
    """The stream's cell type: int16 up to STREAM_INT16_W lanes (a left run
    stays below W), int32 above."""
    return torch.int16 if W <= STREAM_INT16_W else torch.int32


def edit_state_bytes(W: int) -> int:
    """Bytes of the scratch form's per-pair state (above STREAM_INT16_W):
    e and band chars of two rows, the candidates and their diag flags, 15
    bytes a lane of W padded to a multiple of MAX_THREADS, rounded up to
    16.  In shared memory up to EDIT_SMEM_STATE, else in device memory."""
    lanes = -(-W // MAX_THREADS) * MAX_THREADS
    return (15 * lanes + 15) // 16 * 16


def _stream(Q: int, B: int, W: int, device) -> torch.Tensor:
    """A (Q, B, W) stream of :func:`cell_dtype` cells with 16 bytes of
    allocation past its end (the walk copies rows by 16-byte aligned
    blocks), uninitialised."""
    dt = cell_dtype(W)
    pad = 16 // torch.empty((), dtype=dt).element_size()
    return torch.empty(Q * B * W + pad, dtype=dt, device=device)[
        :Q * B * W].view(Q, B, W)


def edit_dp_plain(e0, qs, shifts, inc, rc0, j0, qlen, tlen):
    """Plain PyTorch version of the K3 kernel (same inputs and outputs as
    :func:`edit_dp`)."""
    B, W = e0.shape
    Q = qs.shape[1]
    dev = e0.device
    ks = torch.arange(W, dtype=torch.int32, device=dev)
    inf_col = torch.full((B, 1), INF, dtype=torch.int32, device=dev)
    e, j, rc = e0.clone(), j0.clone(), rc0.clone()
    tl = tlen[:, None]
    ql = qlen[:, None]
    out = torch.empty((Q, B, W), dtype=cell_dtype(W), device=dev)
    for r in range(Q):
        qc = qs[:, r:r + 1]
        sv = shifts[:, r:r + 1]
        one = sv == 1
        e_next = torch.cat([e[:, 1:], inf_col], 1)
        e_prev = torch.cat([inf_col, e[:, :-1]], 1)
        rc_next = torch.cat([rc[:, 1:], inc[:, r:r + 1]], 1)
        up = torch.where(one, e_next, e) + 1
        diag_v = torch.where(one, e, e_prev)
        rc_n = torch.where(one, rc_next, rc)
        j_n = j + sv
        sub = (rc_n != qc).to(torch.int32)
        ok = j_n <= tl
        diag = torch.where(ok & (j_n >= 1), diag_v + sub, INF)
        up = torch.where(ok, up, INF)
        cand = torch.minimum(diag, up)
        y = torch.cummin(cand - ks, dim=1).values
        er = torch.where(ok, torch.minimum(cand, y + ks), INF)
        ptr = torch.where(er == diag, 0, torch.where(er == up, 1, 2)) \
            .to(torch.int32)
        nonleft = torch.cummax(torch.where(ptr != 2, ks, -1), dim=1).values
        run = torch.where(ptr == 2, ks - nonleft, 0)
        out[r] = (ptr | (run << 2)).to(out.dtype)
        live = (r + 1) <= ql
        e = torch.where(live, er, e)
        j = torch.where(live, j_n, j)
        rc = torch.where(live, rc_n, rc)
    return out, e


def edit_dp(e0, qs, shifts, inc, rc0, j0, qlen, tlen):
    """One K3 pass over a batch of pairs.

    e0, rc0, j0: (B, W) int32 row-0 values, ref chars r[j-1] and columns;
    qs, shifts, inc: (B, Q) int32 query chars, band shifts (0/1) and the
    char entering lane W-1 on a shift; qlen, tlen: (B,) int32.  Each row
    of j0 is unit-step (``j0[b, k] = j0[b, 0] + k``, as :func:`k3_inputs`
    makes it) and chars fit an int8.
    Returns (stream (Q, B, W) of :func:`cell_dtype` cells, last row (B, W)
    int32); on the card a pair's stream rows from index q_len on are not
    written."""
    if e0.device.type == "cpu":
        # rows past every q_len freeze the state and are never traced back:
        # the plain run stops at the longest query (those stream rows stay 0)
        Qe = int(qlen.max()) if qlen.numel() else 0
        out = torch.zeros((qs.shape[1],) + tuple(e0.shape),
                          dtype=cell_dtype(e0.shape[1]))
        out[:Qe], last = edit_dp_plain(e0, qs[:, :Qe], shifts[:, :Qe],
                                       inc[:, :Qe], rc0, j0, qlen, tlen)
        return out, last
    B, W = e0.shape
    Q = qs.shape[1]
    lanes, warps, ppb = edit_dp_geometry(W)
    for t, name, shape in ((e0, "e0", (B, W)), (rc0, "rc0", (B, W)),
                           (j0, "j0", (B, W)), (qs, "qs", (B, Q)),
                           (shifts, "shifts", (B, Q)), (inc, "inc", (B, Q)),
                           (qlen, "qlen", (B,)), (tlen, "tlen", (B,))):
        check(t, torch.int32, shape, name, device=e0.device)
    # the kernel stops at each pair's q_len: rows past it stay unwritten
    out = _stream(Q, B, W, e0.device)
    if Q == 0:
        return out, e0.clone()
    last = torch.empty((B, W), dtype=torch.int32, device=e0.device)
    state = W > STREAM_INT16_W and edit_state_bytes(W) > EDIT_SMEM_STATE
    scratch = torch.empty(B * edit_state_bytes(W) if state else 0,
                          dtype=torch.uint8, device=e0.device)
    launch("edit_dp", "edit_dp_launch", e0, qs, shifts, inc, rc0, j0, qlen,
           tlen, out, last, B, Q, W, lanes, warps, ppb, scratch)
    LAUNCHES.add((B, Q, W))
    return out, last


def k3_inputs(q, r, off, t_lens, W: int, mode: str):
    """Kernel inputs from query rows q (B, Q), ref rows r (B, T) (codes),
    band offsets off (B, Q+1) and t_lens (B,): (e0, qs, shifts, inc, rc0,
    j0), all int32.  Row 0 leaves the ref prefix free in infix mode."""
    B, T = r.shape
    dev = r.device
    ks = torch.arange(W, dtype=torch.int64, device=dev)
    # r_pad = [sentinel 4, ref, 4-pad]: rc[k] = r_pad[off + k]
    r_pad = torch.cat([torch.full((B, 1), 4, dtype=torch.int32, device=dev),
                       r.to(torch.int32),
                       torch.full((B, W + 1), 4, dtype=torch.int32,
                                  device=dev)], 1)
    off = off.to(torch.int64)
    j0 = off[:, :1] + ks[None]
    rc0 = torch.gather(r_pad, 1, j0)
    inc = torch.gather(r_pad, 1, (off[:, 1:] + W - 1).clamp(
        0, r_pad.shape[1] - 1))
    tl = t_lens.to(torch.int64)[:, None]
    if mode == "global":
        e0 = torch.where(j0 <= tl, j0, INF)
    else:
        e0 = torch.where(j0 <= tl, 0, INF)
    shifts = off[:, 1:] - off[:, :-1]
    i32 = torch.int32
    return (e0.to(i32).contiguous(), q.to(i32).contiguous(),
            shifts.to(i32).contiguous(), inc.contiguous(),
            rc0.contiguous(), j0.to(i32).contiguous())


def traceback_packed(packed, off, q_len, end_j, W: int):
    """Walk the packed stream from (q_len, end_j) back to row 0, every pair
    at once.  Returns (dels (B, Q) int32, ops (B, Q) uint8, start_j (B,)
    int64): step t covers query char q_len-1-t, ``dels[t]`` ref-deletions
    first, then op 1 = M or 2 = I; steps at and past q_len are 0.  On a
    CUDA tensor it launches the walk kernel of ``csrc/edit_dp.cu`` (the
    stream of :func:`edit_dp`: :func:`cell_dtype` cells, 16-byte aligned),
    on a CPU tensor it runs :func:`traceback_packed_plain` (either cell
    type)."""
    if packed.device.type == "cpu":
        return traceback_packed_plain(packed, off, q_len, end_j, W)
    Q, B, _ = packed.shape
    check(packed, cell_dtype(W), (Q, B, W), "packed")
    if packed.data_ptr() % 16:
        raise ValueError("packed: expected a 16-byte aligned stream")
    end = packed.storage_offset() + packed.numel()
    if (packed.untyped_storage().nbytes()
            < end * packed.element_size() + 16):
        # the walk copies whole 16-byte blocks: a stream that edit_dp did
        # not allocate gets its padding here
        padded = _stream(Q, B, W, packed.device)
        padded.copy_(packed)
        packed = padded
    off = off.to(torch.int64).contiguous()
    ql = q_len.to(torch.int32).contiguous()
    ej = end_j.to(torch.int64).contiguous()
    for t, name, shape in ((off, "off", (B, Q + 1)), (ql, "q_len", (B,)),
                           (ej, "end_j", (B,))):
        check(t, t.dtype, shape, name, device=packed.device)
    dels = torch.empty((B, Q), dtype=torch.int32, device=packed.device)
    ops = torch.empty((B, Q), dtype=torch.uint8, device=packed.device)
    start = torch.empty((B,), dtype=torch.int64, device=packed.device)
    if B == 0 or Q == 0:
        return dels, ops, ej.clone()
    launch("edit_dp", "edit_tb_launch", packed, off, ql, ej, dels, ops, start,
           B, Q, W)
    TB_LAUNCHES.add((B, Q, W))
    return dels, ops, start


def traceback_packed_plain(packed, off, q_len, end_j, W: int):
    """Plain PyTorch version of the walk (same inputs and outputs as
    :func:`traceback_packed`): one step per query row, all pairs at once."""
    Q, B, _ = packed.shape
    dev = packed.device
    flat = packed.reshape(Q, B * W)
    boff = torch.arange(B, dtype=torch.int64, device=dev) * W
    off = off.to(torch.int64)
    i = q_len.to(torch.int64).clone()
    j = end_j.to(torch.int64).clone()
    dels = torch.zeros((B, Q), dtype=torch.int32, device=dev)
    ops = torch.zeros((B, Q), dtype=torch.uint8, device=dev)
    steps = int(q_len.max()) if B else 0
    for t in range(steps):
        live = i > 0
        off_i = torch.gather(off, 1, i.clamp(0, Q)[:, None])[:, 0]
        k = (j - off_i).clamp(0, W - 1)
        row = (i - 1).clamp(0, Q - 1)
        run = flat[row, boff + k].to(torch.int64) >> 2
        k2 = (k - run).clamp(0, W - 1)
        is_diag = (flat[row, boff + k2] & 3) == 0
        dels[:, t] = torch.where(live, run, 0)
        ops[:, t] = torch.where(live, torch.where(is_diag, 1, 2), 0)
        j = torch.where(live, j - run - is_diag.to(torch.int64), j)
        i = torch.where(live, i - 1, i)
    return dels, ops, j


def _lowest_argmin(x):
    """Index of the first minimum along dim 1."""
    W = x.shape[1]
    ks = torch.arange(W, dtype=torch.int64, device=x.device)
    mn = x.min(dim=1, keepdim=True).values
    return torch.where(x == mn, ks, W).min(dim=1).values


def select_end(last, off, q_lens, t_lens, W: int, mode: str):
    """(score, end_j) from the DP's last row: column t_len in global mode,
    the lowest-index minimum of the row in infix mode."""
    last = last.to(torch.int64)
    off_q = torch.gather(off, 1, q_lens.to(torch.int64)[:, None])[:, 0]
    if mode == "global":
        end = t_lens.to(torch.int64)
        k_end = (end - off_q).clamp(0, W - 1)
    else:
        k_end = _lowest_argmin(last)
        end = off_q + k_end
    return torch.gather(last, 1, k_end[:, None])[:, 0], end


def k3_batch(q, r, off, q_lens, t_lens, W: int, mode: str):
    """DP + score/end selection + traceback for a batch of pairs, sliced so
    each launch's stream stays bounded.  Tensors on one device.
    Returns (score, end_j, start_j, dels, ops)."""
    e0, qs, shifts, inc, rc0, j0 = k3_inputs(q, r, off, t_lens, W, mode)
    B, Q = qs.shape
    ql = q_lens.to(torch.int32).contiguous()
    tl = t_lens.to(torch.int32).contiguous()
    off = off.to(torch.int64)
    cell = torch.empty((), dtype=cell_dtype(W)).element_size()
    maxb = max(1, min(2048, STREAM_BYTES // max(Q * W * cell, 1)))
    parts = []
    for s in range(0, B, maxb):
        sl = slice(s, min(B, s + maxb))
        packed, last = edit_dp(e0[sl], qs[sl], shifts[sl], inc[sl], rc0[sl],
                               j0[sl], ql[sl], tl[sl])
        score, end = select_end(last, off[sl], ql[sl], tl[sl], W, mode)
        dels, ops, start = traceback_packed(packed, off[sl], ql[sl], end, W)
        del packed
        parts.append((score, end, start, dels, ops))
    return tuple(torch.cat([p[n] for p in parts]) for n in range(5))


def pack_results(score, end_j, start_j, dels, ops, *extra):
    """Device-side result packing: meta (B, 4 + len(extra)) int32 =
    [score, end_j, start_j, n_del_runs, *extra]; the insertion bitmask
    (B, ceil(Q/8)) uint8 (little-endian bits); the top-DEL_TOPK deletion
    runs (B, 2k) [values | row indices], lower index first among ties."""
    B, Q = ops.shape
    dev = ops.device
    Qp = (Q + 7) // 8 * 8
    bits = torch.zeros((B, Qp), dtype=torch.int32, device=dev)
    bits[:, :Q] = (ops == 2).to(torch.int32)
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                           device=dev)
    ops_packed = (bits.view(B, Qp // 8, 8) * weights).sum(-1).to(torch.uint8)
    k = min(DEL_TOPK, Q)
    dv, di = torch.sort(dels, dim=1, descending=True, stable=True)
    n_runs = (dels > 0).sum(1)
    meta = torch.stack([score.to(torch.int32), end_j.to(torch.int32),
                        start_j.to(torch.int32), n_runs.to(torch.int32)]
                       + [x.to(torch.int32) for x in extra], 1)
    delpack = torch.cat([dv[:, :k].to(torch.int32), di[:, :k].to(torch.int32)],
                        1)
    return meta, ops_packed, delpack


def to_host(meta, ops_packed, delpack):
    """Packed results as numpy (meta int32, bits uint8, delpack uint16)."""
    return (meta.cpu().numpy(), ops_packed.cpu().numpy(),
            delpack.cpu().numpy().astype(np.uint16))


def _t(x, dtype, dev):
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


def extend_hostwin(chunks_blob, chunk_lens, cand_chunk, rs, wstart, astart,
                   t_lens, W: int, Qpad: int, Tpad: int, margin: int,
                   device=None):
    """Candidate verification (infix mode, chunk as query inside its read
    window) — counterpart of ``banded_align._extend_hostwin`` and
    ``pallas_k3.pallas_extend_hostwin`` with unpacked (B, Tpad) window
    codes ``rs``.  Returns numpy (meta (B, 6), ops_packed, delpack) with
    meta = [score, end_j, start_j, n_runs, valid, astart]."""
    return to_host(*extend_hostwin_packed(
        chunks_blob, chunk_lens, cand_chunk, rs, wstart, astart, t_lens, W,
        Qpad, Tpad, margin, device=device))


def extend_hostwin_packed(chunks_blob, chunk_lens, cand_chunk, rs, wstart,
                          astart, t_lens, W: int, Qpad: int, Tpad: int,
                          margin: int, device=None):
    """:func:`extend_hostwin`'s results as tensors on ``device`` (default:
    the blob's, else the current device), read back nowhere: a shard of a
    candidate batch."""
    from ..runtime import resolve
    dev = resolve(device) if device is not None else (
        chunks_blob.device if isinstance(chunks_blob, torch.Tensor)
        else resolve())
    i64 = torch.int64
    blob = _t(chunks_blob, torch.int32, dev)
    clens = _t(chunk_lens, i64, dev)
    cc = _t(cand_chunk, i64, dev)
    rs = _t(rs, torch.int32, dev)
    ws = _t(wstart, i64, dev)
    a = _t(astart, i64, dev)
    tl = _t(t_lens, i64, dev)
    rs = torch.where(torch.arange(Tpad, device=dev)[None] < tl[:, None], rs, 4)
    q = blob[cc]
    q_lens = clens[cc]
    diag0 = ws + margin - a
    ii = torch.arange(Qpad + 1, dtype=i64, device=dev)
    hi = (tl - W + 1).clamp(min=0)
    off = torch.minimum((diag0[:, None] + ii[None] - W // 2).clamp(min=0),
                        hi[:, None])
    off_q = torch.minimum((diag0 + q_lens - W // 2).clamp(min=0), hi)
    off = torch.where(ii[None] <= q_lens[:, None], off, off_q[:, None])
    score, end_j, start_j, dels, ops = k3_batch(q, rs, off, q_lens, tl, W,
                                                "infix")
    valid = tl >= q_lens // 2
    return pack_results(score, end_j, start_j, dels, ops, valid, a)
