"""Error-rate estimation: additive read + chunk-cluster model via ALS.

Reference: ``haplotyper/src/estimate_error_rate.rs:20-133`` —
error(node) ~ read_err[read] + chunk_err[(chunk, cluster)], fit by
alternating least squares with L2 regularization on the chunk terms; returns
per-read and per-(chunk, cluster) rates and the median absolute residual.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..datamodel import DataSet


@dataclass
class ErrorRateModel:
    read_err: dict       # read id -> rate
    chunk_err: dict      # (chunk, cluster) -> rate
    median_abs_dev: float

    def read_of(self, rid) -> float:
        return self.read_err.get(rid, 0.0)

    def chunk_of(self, chunk, cluster) -> float:
        return self.chunk_err.get((chunk, cluster), 0.0)


def estimate_error_rate(ds: DataSet, rounds: int = 20,
                        l2: float = 5.0) -> ErrorRateModel:
    chunks = {c.id: c.seq for c in ds.selected_chunks}
    obs = []  # (read_idx, (chunk, cluster), error)
    read_ids = []
    for er in ds.encoded_reads:
        ri = len(read_ids)
        read_ids.append(er.id)
        for n in er.nodes:
            if n.chunk not in chunks:
                continue
            mat, mism, ins, dele = n.aln_stats(chunks[n.chunk])
            aln = mat + mism + ins + dele
            if aln:
                obs.append((ri, (n.chunk, n.cluster),
                            (mism + ins + dele) / aln))
    if not obs:
        return ErrorRateModel({}, {}, 0.0)
    cc_keys = sorted({k for _, k, _ in obs})
    cc_idx = {k: i for i, k in enumerate(cc_keys)}
    ri_arr = np.array([o[0] for o in obs])
    ci_arr = np.array([cc_idx[o[1]] for o in obs])
    err = np.array([o[2] for o in obs])
    R, C = len(read_ids), len(cc_keys)
    read_e = np.zeros(R)
    chunk_e = np.zeros(C)
    for _ in range(rounds):
        # read terms: mean residual per read
        resid = err - chunk_e[ci_arr]
        num = np.bincount(ri_arr, weights=resid, minlength=R)
        den = np.bincount(ri_arr, minlength=R)
        read_e = num / np.maximum(den, 1)
        # chunk terms: L2-regularized mean residual per (chunk, cluster)
        resid = err - read_e[ri_arr]
        num = np.bincount(ci_arr, weights=resid, minlength=C)
        den = np.bincount(ci_arr, minlength=C)
        chunk_e = num / (den + l2)
    final = err - read_e[ri_arr] - chunk_e[ci_arr]
    mad = float(np.median(np.abs(final)))
    return ErrorRateModel(
        {read_ids[i]: float(read_e[i]) for i in range(R)},
        {cc_keys[i]: float(chunk_e[i]) for i in range(C)},
        mad,
    )
