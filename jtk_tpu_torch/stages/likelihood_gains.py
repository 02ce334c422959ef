"""Gain calibration: expected LK gain and null probability of true variants.

Reference: ``haplotyper/src/likelihood_gains.rs`` — simulates reads through
the trained HMM to estimate, per (difference type x homopolymer length
1..3), (a) the expected likelihood gain a true variant confers on a carrying
read (gain_of :253-315: per-template median, 10%-quantile over templates)
and (b) the probability that a non-carrying read still shows positive gain
(2/3-quantile), used for binomial-tail p-values of variant columns
(:115-129).  Each template plants the variant inside a homopolymer of the
conditioning length (gen_diff_haplotypes :217-247).

The simulation samples reads from the trained HMM itself (hmm_generate) and
scores them with the banded K1 likelihood kernel, batched across the whole
(template x read) sweep in a handful of device calls.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import trace
from ..datamodel import ErrorRate
from ..ops.banded_align import linear_offsets
from ..ops.phmm import PHMMParams, hmm_generate, likelihood_pairs

DIFF_TYPES = ("sub", "del", "ins")
_GAINS_CACHE: dict = {}
MAX_HOMOP = 3
SEQ_LEN = 100
N_TEMPLATES = 40
N_READS = 32
BAND = 64


@dataclass
class Gains:
    # difftype -> (MAX_HOMOP,) arrays indexed by homopolymer length - 1
    expected_h: dict
    null_prob_h: dict
    thr: float = 0.5
    # read count -> pvalue_grid's array
    _grids: dict = field(default_factory=dict)

    def expected(self, homop_len: int, difftype: str) -> float:
        i = int(np.clip(homop_len, 1, MAX_HOMOP)) - 1
        return float(self.expected_h[difftype][i])

    def expected_of(self, difftype: str) -> float:
        """Homopolymer-agnostic view (length-1 profile)."""
        return float(self.expected_h[difftype][0])

    def null_of(self, difftype: str, homop_len: int = 1) -> float:
        i = int(np.clip(homop_len, 1, MAX_HOMOP)) - 1
        return float(self.null_prob_h[difftype][i])

    def pvalue_grid(self, total: int) -> np.ndarray:
        """Binomial tails P(X >= count | total, null_prob) at count 0..total
        for every difference type and homopolymer length: a float64
        (len(DIFF_TYPES) * MAX_HOMOP, total + 1) array whose row
        ``DIFF_TYPES.index(difftype) * MAX_HOMOP + homop_len - 1`` is the
        tail at that null probability (floored at 1e-4; probabilities equal
        to 6 decimals share the first one's tail).  One a read count,
        cached (counter ``gains.pvalue_grids``)."""
        grid = self._grids.get(total)
        if grid is None:
            tails: dict = {}
            rows = []
            for dt in DIFF_TYPES:
                for L in range(1, MAX_HOMOP + 1):
                    p = max(self.null_of(dt, L), 1e-4)
                    key = round(p, 6)
                    if key not in tails:
                        tails[key] = _binom_tail(p, total)
                    rows.append(tails[key])
            grid = self._grids[total] = np.stack(rows)
            trace.count("gains.pvalue_grids")
        return grid


def _gammaln(x):
    # Stirling with correction terms; exact enough for binomial tails
    x = np.asarray(x, float)
    out = np.zeros_like(x)
    small = x < 1
    xs = np.where(small, x + 2, x)
    out = (xs - 0.5) * np.log(xs) - xs + 0.5 * np.log(2 * np.pi) \
        + 1.0 / (12 * xs) - 1.0 / (360 * xs ** 3)
    out = np.where(small, out - np.log(np.maximum(x, 1e-12))
                   - np.log(np.maximum(x + 1, 1e-12)), out)
    return out


def _binom_tail(p: float, n: int) -> np.ndarray:
    lp, lq = np.log(max(p, 1e-12)), np.log1p(-min(p, 1 - 1e-12))
    k = np.arange(n + 1)
    logpmf = (_gammaln(n + 1) - _gammaln(k + 1) - _gammaln(n - k + 1)
              + k * lp + (n - k) * lq)
    # reverse cumulative logsumexp
    rev = logpmf[::-1]
    m = np.maximum.accumulate(rev)
    csum = np.log(np.cumsum(np.exp(rev - m))) + m
    tail = csum[::-1]
    return np.minimum(np.exp(tail), 1.0)


def _noisy(rng, template, er: ErrorRate):
    """Error-rate-profile read simulator (fallback when no HMM params)."""
    out = []
    for b in template:
        x = rng.random()
        if x < er.del_:
            continue
        if x < er.del_ + er.mismatch:
            out.append((b + 1 + rng.integers(0, 3)) % 4)
        else:
            out.append(b)
        if rng.random() < er.ins:
            out.append(rng.integers(0, 4))
    return np.array(out, dtype=np.int8)


def _gen_diff_haplotypes(rng, hlen: int, difftype: str):
    """Homopolymer of length hlen with / without the variant
    (gen_diff_haplotypes, likelihood_gains.rs:217-247)."""
    center = int(rng.integers(0, 4))
    others = [b for b in range(4) if b != center]
    left = others[int(rng.integers(0, 3))]
    right = others[int(rng.integers(0, 3))]
    c1 = [center] * hlen
    c2 = list(c1)
    if difftype == "sub":
        c2[0] = others[int(rng.integers(0, 3))]
    elif difftype == "del":
        c2.pop(0)
    else:
        c2.insert(1, others[int(rng.integers(0, 3))])
    hap1 = np.array([left] + c1 + [right], np.int8)
    hap2 = np.array([left] + c2 + [right], np.int8)
    return hap1, hap2


def _batched_lks(pairs, params: PHMMParams, W: int):
    """pairs: [(read, template)] -> log-likelihoods, one device call."""
    if not pairs:
        return np.zeros(0)
    Q = max(len(q) for q, _t in pairs)
    Q = ((Q + 31) // 32) * 32
    T = max(len(t) for _q, t in pairs)
    T = ((T + 31) // 32) * 32
    B = len(pairs)
    qs = np.full((B, Q), 4, np.int8)
    rs = np.full((B, T), 4, np.int8)
    qlens = np.zeros(B, np.int32)
    tlens = np.zeros(B, np.int32)
    offs = np.zeros((B, Q + 1), np.int32)
    for i, (q, t) in enumerate(pairs):
        qs[i, :len(q)] = q
        rs[i, :len(t)] = t
        qlens[i] = len(q)
        tlens[i] = len(t)
        offs[i] = linear_offsets(len(q), len(t), Q, W)
    lks = likelihood_pairs(qs, rs, offs, qlens, tlens, params, W)
    return np.asarray(lks, np.float64)


def estimate_gains(params: PHMMParams, error_rate: ErrorRate | None = None,
                   seed: int = 42, n_templates: int = N_TEMPLATES,
                   n_reads: int = N_READS, seq_len: int = SEQ_LEN,
                   W: int = BAND,
                   params_rev: PHMMParams | None = None) -> Gains:
    key = (seed, n_templates, n_reads, seq_len, W,
           float(params.trans.sum()),
           float(params.mat_emit.sum()),
           float(params.ins_emit.sum()))
    cached = _GAINS_CACHE.get(key)
    if cached is not None:
        return cached
    rng = np.random.default_rng(seed)
    params_rev = params_rev or params
    expected_h = {d: np.zeros(MAX_HOMOP) for d in DIFF_TYPES}
    null_h = {d: np.zeros(MAX_HOMOP) for d in DIFF_TYPES}
    # the whole (difftype x homopolymer-length) sweep shares FOUR device
    # calls — per-combo dispatches round-trip a high-latency link 36 times
    combos = [(dt, hlen) for dt in DIFF_TYPES
              for hlen in range(1, MAX_HOMOP + 1)]
    gain_pairs, base_pairs, null_t_pairs, null_d_pairs = [], [], [], []
    for dt, hlen in combos:
        for _ in range(n_templates):
            seg1 = rng.integers(0, 4, seq_len // 2).astype(np.int8)
            seg2 = rng.integers(0, 4, seq_len // 2).astype(np.int8)
            hap1, hap2 = _gen_diff_haplotypes(rng, hlen, dt)
            template = np.concatenate([seg1, hap1, seg2])
            diff = np.concatenate([seg1, hap2, seg2])
            for t in range(n_reads):
                par = params if t % 2 == 0 else params_rev
                read = hmm_generate(rng, diff, par)
                gain_pairs.append((read, diff))
                base_pairs.append((read, template))
                nread = hmm_generate(rng, template, par)
                null_t_pairs.append((nread, template))
                null_d_pairs.append((nread, diff))
    lk_d = _batched_lks(gain_pairs, params, W)
    lk_b = _batched_lks(base_pairs, params, W)
    lk_nt = _batched_lks(null_t_pairs, params, W)
    lk_nd = _batched_lks(null_d_pairs, params, W)
    per = n_templates * n_reads
    for ci, (dt, hlen) in enumerate(combos):
        sl = slice(ci * per, (ci + 1) * per)
        gains = (lk_d[sl] - lk_b[sl]).reshape(n_templates, n_reads)
        med = np.median(gains, axis=1)
        exp_gain = float(np.quantile(med, 0.10))
        min_gain = exp_gain / 10.0 if dt == "sub" else 1e-4
        nulls = (lk_nd[sl] > lk_nt[sl] + min_gain).reshape(n_templates,
                                                           n_reads)
        prob = float(np.quantile(nulls.mean(1), 2.0 / 3.0))
        expected_h[dt][hlen - 1] = max(exp_gain, 0.5)
        null_h[dt][hlen - 1] = min(max(prob, 1e-9), 0.5)
    out = Gains(expected_h, null_h)
    _GAINS_CACHE[key] = out
    return out


def estimate_minimum_gain(params: PHMMParams,
                          params_rev: PHMMParams | None = None,
                          seed: int = 23908, n_samples: int = 40,
                          n_reads: int = 24, seq_len: int = 100,
                          W: int = BAND) -> float:
    """Minimum gain protecting well-separated clusters
    (estimate_minimum_gain, likelihood_gains.rs:6-39): the 2nd-smallest
    per-template median gain of a 1-bp-insertion haplotype pair, floor 1."""
    rng = np.random.default_rng(seed)
    params_rev = params_rev or params
    pairs1, pairs2 = [], []
    for _ in range(n_samples):
        hap1 = rng.integers(0, 4, seq_len).astype(np.int8)
        pos = int(rng.integers(1, seq_len - 1))
        hap2 = np.concatenate([hap1[:pos], hap1[pos + 1:]])
        for t in range(n_reads):
            par = params if t % 2 == 0 else params_rev
            read = hmm_generate(rng, hap1, par)
            pairs1.append((read, hap1))
            pairs2.append((read, hap2))
    lk1 = _batched_lks(pairs1, params, W)
    lk2 = _batched_lks(pairs2, params, W)
    med = np.median((lk1 - lk2).reshape(n_samples, n_reads), axis=1)
    med.sort()
    return float(max(med[min(2, len(med) - 1)], 1.0))
