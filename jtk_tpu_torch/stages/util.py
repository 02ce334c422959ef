"""Small shared helpers (reference: haplotyper/src/misc.rs)."""

from __future__ import annotations

import numpy as np


def logsumexp(xs: np.ndarray, axis=None):
    m = np.max(xs, axis=axis, keepdims=True)
    out = np.log(np.sum(np.exp(xs - m), axis=axis, keepdims=True)) + m
    return float(out.reshape(())) if axis is None else np.squeeze(out, axis=axis)


def update_coverage(ds) -> float:
    """Haploid coverage = median chunk pileup count / 2 (misc.rs:394-407)."""
    counts: dict[int, int] = {}
    for er in ds.encoded_reads:
        for n in er.nodes:
            counts[n.chunk] = counts.get(n.chunk, 0) + 1
    if not counts:
        return 0.0
    cov = float(np.median(list(counts.values()))) / 2.0
    ds.coverage.set(cov)
    return ds.coverage.unwrap()


def homopolymer_length(seq: np.ndarray) -> np.ndarray:
    """Per-position run length of the homopolymer containing it
    (pseudo_mcmc.rs:196-211)."""
    seq = np.asarray(seq)
    starts = np.ones(len(seq), bool)
    np.not_equal(seq[1:], seq[:-1], out=starts[1:])
    runs = np.diff(np.flatnonzero(starts), append=len(seq))
    return np.repeat(runs, runs).astype(np.int32)


def adjusted_rand_index(a, b) -> float:
    """misc.rs:5-46."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    if len(a) == 0:
        return 1.0
    ka, kb = int(a.max()) + 1, int(b.max()) + 1
    m = np.zeros((ka, kb))
    np.add.at(m, (a, b), 1)
    comb = lambda x: x * (x - 1) / 2.0
    idx = comb(m).sum()
    ea, eb = comb(m.sum(1)).sum(), comb(m.sum(0)).sum()
    exp = ea * eb / comb(len(a))
    mx = (ea + eb) / 2.0
    den = mx - exp
    return float((idx - exp) / den) if abs(den) > 1e-12 else 1.0


def max_poisson_lk(x: int, lam: float, c_start: int, c_end: int) -> float:
    best = -np.inf
    for c in range(max(c_start, 1), c_end + 1):
        l = max(lam * c, 1e-3)
        lp = x * np.log(l) - l - np.sum(np.log(np.arange(1, x + 1)))
        best = max(best, lp)
    return float(best)
