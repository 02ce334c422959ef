"""Repeat masking: canonical k-mer counting, mask top-frequency k-mers.

Reference: ``haplotyper/src/repeat_masking.rs`` — rolling canonical k-mer
iterator (:30-85), parallel counting (:162-194), percentile threshold
(create_mask :255-285), lowercase masking of read ranges (:287-325), and
``repetitiveness(seq)`` = fraction of k-mers occurring >= 2x.

Packing + counting is vectorized numpy (np.unique on packed uint64
canonical k-mers) — the histogram is a single host pass; ``pack_kmers`` is
shared with the mapper.  (The JAX package's sharded device histogram is a
multi-device path; the port counts on the host, which gives the same mask.)
"""

from __future__ import annotations

import numpy as np

from .. import seq as seqmod
from ..datamodel import DataSet
from ..mapper import pack_kmers

DEFAULT_K = 12
DEFAULT_FREQ = 0.001
DEFAULT_MIN_COUNT = 10


def canonical_kmers(codes: np.ndarray, k: int):
    """Canonical (min of fwd/revcomp) packed k-mers + validity mask."""
    fwd, ok_f = pack_kmers(codes, k)
    rc, _ = pack_kmers(seqmod.revcomp(codes), k)
    rc = rc[::-1]
    canon = np.minimum(fwd, rc)
    return canon, ok_f


class RepeatAnnot:
    def __init__(self, kmers: set, k: int):
        self.kmers = kmers
        self.k = k

    def repetitiveness(self, codes: np.ndarray) -> float:
        """Fraction of masked k-mers occurring >= 2x in ``codes``
        (repeat_masking.rs RepeatAnnot)."""
        canon, ok = canonical_kmers(codes, self.k)
        if not ok.any():
            return 0.0
        vals = canon[ok]
        if not self.kmers:
            return 0.0
        mask_arr = np.fromiter((v in self.kmers for v in vals), bool, len(vals))
        if not mask_arr.any():
            return 0.0
        masked = vals[mask_arr]
        _, counts = np.unique(masked, return_counts=True)
        rep = counts[counts >= 2].sum()
        return float(rep) / len(vals)


def count_kmers(ds: DataSet, k: int = DEFAULT_K):
    all_vals = []
    for r in ds.raw_reads:
        canon, ok = canonical_kmers(seqmod.encode(r.seq), k)
        all_vals.append(canon[ok])
    if not all_vals:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    vals = np.concatenate(all_vals)
    uniq, counts = np.unique(vals, return_counts=True)
    return uniq, counts


def mask_repeats(ds: DataSet, k: int = DEFAULT_K, freq: float = DEFAULT_FREQ,
                 min_count: int = DEFAULT_MIN_COUNT) -> RepeatAnnot:
    """Lowercase-mask ranges covered by over-represented k-mers."""
    uniq, counts = count_kmers(ds, k)
    if len(uniq) == 0:
        ds.masked_kmers.k = k
        ds.masked_kmers.thr = 0
        return RepeatAnnot(set(), k)
    thr = max(int(np.quantile(counts, 1.0 - freq)), min_count)
    masked = set(uniq[counts > thr].tolist())
    ds.masked_kmers.k = k
    ds.masked_kmers.thr = thr
    if masked:
        for r in ds.raw_reads:
            codes = seqmod.encode(r.seq)
            canon, ok = canonical_kmers(codes, k)
            hit = np.zeros(len(codes), bool)
            for i in np.nonzero(ok)[0]:
                if canon[i] in masked:
                    hit[i:i + k] = True
            if hit.any():
                arr = np.frombuffer(r.seq.encode(), np.uint8).copy()
                lower = arr + 32
                arr = np.where(hit & (arr < 97), lower, arr).astype(np.uint8)
                r.seq = arr.tobytes().decode()
    ds.push_stage("RepeatMasking", [f"k={k}", f"thr={thr}"])
    return RepeatAnnot(masked, k)
