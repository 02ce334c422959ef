"""Plain edit distances, and the cost of a CIGAR, for the correctness check.

Unbanded global edit distance (unit costs, as the port's K3 scores it)
over a batch of pairs, one query row at a time in plain PyTorch: a row's
diagonal and vertical moves are elementwise, its horizontal chain is a
running minimum (``D[j] = j + cummin(E[k] - k)``).  Imports nothing of the
program under test.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 1 << 20


def _pad(seqs, fill):
    n = max((len(s) for s in seqs), default=0)
    out = np.full((len(seqs), max(n, 1)), fill, np.int8)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return out


def edit_distance(queries, targets, device, dtype=torch.int32,
                  keep_rows: bool = False):
    """Global edit distance of each (query, target) pair.

    Each row is held in ``dtype``: a narrower type wraps its cells as
    that type's arithmetic does (the lower-precision control);
    ``keep_rows`` also returns every row, (Q+1, B, T+1), for a traceback.
    Returns a numpy int64 array (B,) [and the rows]."""
    B = len(queries)
    if B == 0:
        return np.zeros(0, np.int64)
    q = torch.as_tensor(_pad(queries, 5), device=device).long()
    t = torch.as_tensor(_pad(targets, 6), device=device).long()
    ql = torch.as_tensor([len(s) for s in queries], device=device)
    tl = torch.as_tensor([len(s) for s in targets], device=device)
    T = t.shape[1]

    def held(x):
        return x.to(dtype).to(torch.int64)

    j = torch.arange(T + 1, device=device)
    row = held(j[None].expand(B, -1))
    rows = [row.to(dtype)] if keep_rows else None
    for i in range(1, int(ql.max()) + 1):
        sub = (q[:, i - 1:i] != t).to(torch.int64)
        e = torch.minimum(row[:, :-1] + sub, row[:, 1:] + 1)
        e = torch.cat([torch.full((B, 1), i, device=device), e], 1)
        new = held(torch.cummin(e - j, 1).values + j)
        row = torch.where((i <= ql)[:, None], new, row)
        if keep_rows:
            rows.append(row.to(dtype))
    dist = row.gather(1, tl[:, None].long())[:, 0].cpu().numpy()
    if keep_rows:
        return dist.astype(np.int64), torch.stack(rows).cpu().numpy()
    return dist.astype(np.int64)


def traceback(rows: np.ndarray, b: int, q, t):
    """A CIGAR of pair ``b`` from its rows (as :func:`edit_distance` keeps
    them): diagonal before vertical before horizontal."""
    i, j = len(q), len(t)
    ops = []
    R = rows[:, b].astype(np.int64)
    while i > 0 and j > 0:
        s = int(q[i - 1] != t[j - 1])
        if R[i, j] == R[i - 1, j - 1] + s:
            ops.append("M")
            i, j = i - 1, j - 1
        elif R[i, j] == R[i - 1, j] + 1:
            ops.append("I")
            i -= 1
        elif R[i, j] == R[i, j - 1] + 1:
            ops.append("D")
            j -= 1
        else:     # a wrapped cell: no move explains it
            ops.append("M")
            i, j = i - 1, j - 1
    ops.extend("I" * i + "D" * j)
    ops.reverse()
    out = []
    for k in ops:
        if out and out[-1][0] == k:
            out[-1][1] += 1
        else:
            out.append([k, 1])
    return [(k, n) for k, n in out]


def cigar_cost(cigar, q, t) -> int:
    """Unit edit cost of ``cigar`` (M/I/D, query ``q`` against target
    ``t``), or ``BIG`` where it does not consume both exactly or holds
    another operation."""
    q = np.asarray(q)
    t = np.asarray(t)
    i = j = cost = 0
    for k, n in cigar:
        n = int(n)
        if n < 0:
            return BIG
        if k == "M":
            if i + n > len(q) or j + n > len(t):
                return BIG
            cost += int(np.count_nonzero(q[i:i + n] != t[j:j + n]))
            i += n
            j += n
        elif k == "I":
            cost += n
            i += n
        elif k == "D":
            cost += n
            j += n
        else:
            return BIG
    if i != len(q) or j != len(t):
        return BIG
    return cost


def encode(ascii_: str) -> np.ndarray:
    """ASCII bases to codes A 0, C 1, G 2, T 3, other 4."""
    lut = np.full(256, 4, np.int8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    for i, b in enumerate(b"acgt"):
        lut[b] = i
    return lut[np.frombuffer(ascii_.encode(), np.uint8)]


def control_cigars(qs, ts, best, n: int, dtype, device):
    """The control: the first ``n`` pairs' CIGARs walked from this
    module's DP with cells of ``dtype``, in the program's
    place.  Returns the pairs, their least distances and those CIGARs."""
    qs, ts, best = qs[:n], ts[:n], best[:n]
    _d, rows = edit_distance(qs, ts, device, dtype=dtype, keep_rows=True)
    return qs, ts, best, [traceback(rows, b, q, t)
                          for b, (q, t) in enumerate(zip(qs, ts))]
