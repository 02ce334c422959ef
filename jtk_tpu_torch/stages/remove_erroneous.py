"""Remove erroneous nodes — occurrences supported only by weak edges.

Reference: ``haplotyper/src/remove_erroneous_nodes.rs:33-156`` — calibrated
edge coverages (CoverageCalibrator over read lengths), edges below
quartile/4 whose neighborhood offers a >=3x better-supported alternative
edge are removed by deleting the offending node occurrence from every read
(losslessness kept via EncodedRead.remove).
"""

from __future__ import annotations

import logging
from collections import defaultdict

import numpy as np

from ..datamodel import DataSet
from ..graph.coverage import CoverageCalibrator

logger = logging.getLogger(__name__)

MEDIAN_FRAC = 4
IMPROVE_THR = 3.0


def _norm_key(a, b):
    return (a.chunk, b.chunk) if a.chunk <= b.chunk else (b.chunk, a.chunk)


def _edge_calibrated_coverage(ds: DataSet):
    counts = defaultdict(lambda: [0, 0])
    for er in ds.encoded_reads:
        for a, e, b in zip(er.nodes, er.edges, er.nodes[1:]):
            k = _norm_key(a, b)
            counts[k][0] += 1
            counts[k][1] += e.offset
    lens = [er.original_length for er in ds.encoded_reads]
    calib = CoverageCalibrator(lens)
    out = {}
    for k, (obs, totlen) in counts.items():
        gap = max(totlen // obs, 0)
        out[k] = calib.calib(obs, gap)
    return out


def remove_erroneous_nodes(ds: DataSet) -> DataSet:
    edge_cov = _edge_calibrated_coverage(ds)
    if not edge_cov:
        ds.push_stage("RemoveErroneousNodes", [])
        return ds
    covs = sorted(edge_cov.values())
    # the reference's "median" is the lower quartile (MEDIAN_FRAC=4)
    pivot = covs[len(covs) // MEDIAN_FRAC]
    to_remove = {}
    for key, cov in edge_cov.items():
        if cov >= pivot / 4.0:
            continue
        former, later = set(), set()
        for er in ds.encoded_reads:
            for i in range(len(er.nodes) - 1):
                a, b = er.nodes[i], er.nodes[i + 1]
                if _norm_key(a, b) != key:
                    continue
                fwd = a.chunk <= b.chunk
                if i + 2 < len(er.nodes):
                    (former if fwd else later).add(er.nodes[i + 2].chunk)
                if i - 1 >= 0:
                    (later if fwd else former).add(er.nodes[i - 1].chunk)
        hit = None
        for nxt in former:
            probe = (key[0], nxt) if key[0] <= nxt else (nxt, key[0])
            if edge_cov.get(probe, 0.0) > IMPROVE_THR * cov:
                hit = key[1]
                break
        if hit is None:
            for prv in later:
                probe = (key[1], prv) if key[1] <= prv else (prv, key[1])
                if edge_cov.get(probe, 0.0) > IMPROVE_THR * cov:
                    hit = key[0]
                    break
        if hit is not None:
            to_remove[key] = hit
    removed = 0
    for er in ds.encoded_reads:
        idxs = []
        for i in range(len(er.nodes) - 1):
            a, b = er.nodes[i], er.nodes[i + 1]
            k = _norm_key(a, b)
            if k in to_remove:
                idxs.append(i if to_remove[k] == a.chunk else i + 1)
        for off, i in enumerate(sorted(set(idxs))):
            er.remove(i - off)
            removed += 1
    ds.encoded_reads = [er for er in ds.encoded_reads if er.nodes]
    logger.info("remove_erroneous_nodes: removed %d node occurrences "
                "(%d weak edges)", removed, len(to_remove))
    ds.push_stage("RemoveErroneousNodes", [])
    return ds
