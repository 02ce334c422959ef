"""The yardstick of a kernel's roofline share: the card's peaks, and the
bytes and operations of each kernel's launch from its shapes.

Frozen here (copied from ``chip_smoke.py``'s ``roofline`` and
``k3_bounds`` and its table-kernel bound) so that a change to the program
cannot move it.  A launch's least time is the larger of its bytes over
the memory rate and its operations over the float32 rate; each input byte
counts once and each output byte once.
"""

from __future__ import annotations

# one H100 SXM, NVIDIA's data sheet, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def k3_dp(B: int, W: int, rows: int) -> float:
    """K3's DP over B pairs whose q_lens sum to ``rows``: its (B, W) row-0
    inputs, its row streams up to each q_len, the stream it writes up to
    q_len (2-byte cells, 4 above 8192 lanes) and the last row; ~20 integer
    operations a cell."""
    cell = 2 if W <= 8192 else 4
    return least_seconds(4 * (3 * B * W + 3 * rows + 2 * B) + cell * W * rows
                         + 4 * B * W, 20.0 * W * rows)


def k3_walk(B: int, Q: int, W: int, rows: int) -> float:
    """K3's walk: at most two stream cells and one band offset a step,
    q_len and end_j a pair, dels and ops of every step and start_j; ~15
    integer operations a step."""
    cell = 2 if W <= 8192 else 4
    return least_seconds((2 * cell + 8) * rows + 5 * B * Q + 20 * B,
                         15.0 * rows)


def k1_tables(in_bytes: int, B: int, Q: int, W: int, rows: int,
              size: int) -> float:
    """K1f or K1b: its inputs, the three (B, Q, W) tables and the row
    scales it writes in its type (``size`` bytes), ~40 operations a band
    cell of the rows the pairs need."""
    return least_seconds(in_bytes + size * B * Q * (3 * W + 1),
                         40.0 * W * rows)
