"""Repeat masking: canonical k-mer counting, mask top-frequency k-mers.

Reference: ``haplotyper/src/repeat_masking.rs`` — rolling canonical k-mer
iterator (:30-85), parallel counting (:162-194), percentile threshold
(create_mask :255-285), lowercase masking of read ranges (:287-325), and
``repetitiveness(seq)`` = fraction of k-mers occurring >= 2x.

Packing is vectorized numpy, shared with the mapper (``pack_kmers``).  For
k <= 13, as ``jtk_tpu`` does on its mesh, the k-mers are counted on the
device set (:func:`jtk_tpu_torch.runtime.devices`, one device or several)
into 4^k exact bins (:func:`jtk_tpu_torch.parallel.make_sharded_kmer_hist`),
and only the present k-mers and their counts come back to the host; above,
4^k bins would not fit, and a single host pass counts them (np.unique on
packed uint64 canonical k-mers).
"""

from __future__ import annotations

import numpy as np
import torch

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


def _kmer_values(ds: DataSet, k: int) -> np.ndarray:
    """Every read's valid canonical k-mers, concatenated."""
    vals = [c[ok] for c, ok in (canonical_kmers(seqmod.encode(r.seq), k)
                                for r in ds.raw_reads)]
    return np.concatenate(vals) if vals else np.zeros(0, np.uint64)


def count_kmers(ds: DataSet, k: int = DEFAULT_K):
    """The distinct canonical k-mers of the reads, increasing, and their
    counts (see the module docstring for where they are counted)."""
    vals = _kmer_values(ds, k)
    if k > 13:
        return np.unique(vals, return_counts=True)
    from ..parallel import make_sharded_kmer_hist
    hist = make_sharded_kmer_hist(4 ** k)(vals.astype(np.int64))
    uniq = torch.nonzero(hist)[:, 0]
    return uniq.cpu().numpy().astype(vals.dtype), hist[uniq].cpu().numpy()


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
