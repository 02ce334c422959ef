"""K3 — banded unit-cost edit DP with a packed traceback stream.

Counterpart of ``jtk_tpu/ops/pallas_k3.py``.  :func:`edit_dp` is the kernel
wrapper: on a CUDA tensor it launches the hand-written kernel
``csrc/edit_dp.cu`` (W up to MAX_W, :func:`edit_dp_geometry`); on a CPU
tensor it runs :func:`edit_dp_plain`, the same function in plain PyTorch.
Around it sit the glue of ``pallas_extend_hostwin`` (band offsets, window
setup, score/end selection, the batched traceback walk and the result
packing: insertion bitmask, top-``DEL_TOPK`` deletion runs, 6-column meta)
and the shared entry point :func:`k3_batch` used by every alignment in the
port.

Band conventions (as in the reference): offsets have unit increments,
``rc[k] = r[j-1]`` for ``j = off_i + k``, rows past ``q_len`` are frozen.
The stream is ``(Q, B, W)`` int16 holding ``ptr | left_run << 2`` (ptr 0 =
diag, 1 = up, 2 = left; diag wins ties over up over left).
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_build import Launches, check, launch

INF = 1 << 30
DEL_TOPK = 192
MAX_W = 8192            # ptr | run << 2 with run < W fits an int16
MAX_LANES = 8           # band lanes a thread keeps (1, 2, 4 or 8)
MAX_THREADS = 1024      # threads of the one block a pair has
# (Q, B, W) int16 stream of one launch stays under 2^30 cells (2 GB)
STREAM_CELLS = 1 << 30

LAUNCHES = Launches("edit_dp")


def edit_dp_geometry(W: int) -> tuple[int, int]:
    """Launch geometry of the K3 kernel for band width ``W``: (lanes per
    thread, threads per block).  A thread takes the fewest lanes (a power
    of two up to MAX_LANES) that leave the band at most MAX_THREADS
    threads, rounded up to whole warps."""
    if not 1 <= W <= MAX_W:
        raise ValueError(f"edit_dp: band width {W} outside 1..{MAX_W}")
    lanes = 1
    while -(-W // lanes) > MAX_THREADS:
        lanes *= 2
    return lanes, -(-W // (32 * lanes)) * 32


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
    out = torch.empty((Q, B, W), dtype=torch.int16, device=dev)
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
        out[r] = (ptr | (run << 2)).to(torch.int16)
        live = (r + 1) <= ql
        e = torch.where(live, er, e)
        j = torch.where(live, j_n, j)
        rc = torch.where(live, rc_n, rc)
    return out, e


def edit_dp(e0, qs, shifts, inc, rc0, j0, qlen, tlen):
    """One K3 pass over a batch of pairs.

    e0, rc0, j0: (B, W) int32 row-0 values, ref chars r[j-1] and columns;
    qs, shifts, inc: (B, Q) int32 query chars, band shifts (0/1) and the
    char entering lane W-1 on a shift; qlen, tlen: (B,) int32.
    Returns (stream (Q, B, W) int16, last row (B, W) int32)."""
    if e0.device.type == "cpu":
        # rows past every q_len freeze the state and are never traced back:
        # the plain run stops at the longest query (those stream rows stay 0)
        Qe = int(qlen.max()) if qlen.numel() else 0
        out = torch.zeros((qs.shape[1],) + tuple(e0.shape), dtype=torch.int16)
        out[:Qe], last = edit_dp_plain(e0, qs[:, :Qe], shifts[:, :Qe],
                                       inc[:, :Qe], rc0, j0, qlen, tlen)
        return out, last
    B, W = e0.shape
    Q = qs.shape[1]
    lanes, _threads = edit_dp_geometry(W)
    for t, name, shape in ((e0, "e0", (B, W)), (rc0, "rc0", (B, W)),
                           (j0, "j0", (B, W)), (qs, "qs", (B, Q)),
                           (shifts, "shifts", (B, Q)), (inc, "inc", (B, Q)),
                           (qlen, "qlen", (B,)), (tlen, "tlen", (B,))):
        check(t, torch.int32, shape, name)
    out = torch.empty((Q, B, W), dtype=torch.int16, device=e0.device)
    last = torch.empty((B, W), dtype=torch.int32, device=e0.device)
    launch("edit_dp", "edit_dp_launch", e0, qs, shifts, inc, rc0, j0, qlen,
           tlen, out, last, B, Q, W, lanes)
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
    """Batched traceback over the packed stream (one step per query row,
    all pairs at once).  Returns (dels (B, Q) int32, ops (B, Q) uint8,
    start_j (B,)): step t covers query char q_len-1-t, ``dels[t]``
    ref-deletions first, then op 1 = M or 2 = I."""
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
    maxb = max(1, min(2048, STREAM_CELLS // max(Q * W, 1)))
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
    return to_host(*pack_results(score, end_j, start_j, dels, ops, valid, a))
