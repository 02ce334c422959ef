"""Purge diverged clusters and large-indel node occurrences.

Reference: ``haplotyper/src/purge_diverged.rs`` —
(a) ``purge``: drop (chunk, cluster) whose ALS-estimated error rate exceeds
THR=0.1 (:40) — their consensus failed, likely a collapsed repeat copy —
renumber the remaining clusters in nodes/posteriors and re-cluster affected
chunks (:238-322);
(b) ``purge_largeindel``: remove node occurrences whose CIGAR contains a
windowed indel run (Kadane max-region with DEL_WEIGHT 2 / MATCH_WEIGHT 1,
:63-90) larger than ``indel_size``, when a cluster-consistent fraction
(ACCEPT_RATE 0.5) of the cluster shows it (:49-187).
"""

from __future__ import annotations

import logging
from collections import defaultdict

import numpy as np

from ..datamodel import DataSet
from .error_rate import estimate_error_rate

logger = logging.getLogger(__name__)

THR = 0.1
ACCEPT_RATE = 0.5
DEL_WEIGHT = 2
MATCH_WEIGHT = 1


def max_region(xs) -> int:
    """Kadane maximum-sum region (misc.rs:345-373)."""
    best = cur = 0
    for x in xs:
        cur = max(cur + x, 0)
        best = max(best, cur)
    return best


def purge_diverged(ds: DataSet, re_cluster: bool = True) -> DataSet:
    erm = estimate_error_rate(ds)
    bad = {cc for cc, e in erm.chunk_err.items() if e > THR}
    # keep at least one cluster per chunk
    by_chunk = defaultdict(set)
    for c, cl in erm.chunk_err:
        by_chunk[c].add(cl)
    bad = {(c, cl) for (c, cl) in bad
           if any((c, o) not in bad for o in by_chunk[c])}
    if not bad:
        ds.push_stage("PurgeDiverged", [])
        return ds
    chunks = {c.id: c for c in ds.selected_chunks}
    # removal + cluster renumbering per chunk
    remap = {}
    for cid, chunk in chunks.items():
        kept = [cl for cl in range(chunk.cluster_num)
                if (cid, cl) not in bad]
        if len(kept) < chunk.cluster_num:
            remap[cid] = {old: new for new, old in enumerate(kept)}
            chunk.cluster_num = max(len(kept), 1)
    removed_nodes = 0
    for er in ds.encoded_reads:
        i = 0
        while i < len(er.nodes):
            n = er.nodes[i]
            if (n.chunk, n.cluster) in bad:
                er.remove(i)
                removed_nodes += 1
                continue
            m = remap.get(n.chunk)
            if m is not None:
                n.cluster = m.get(n.cluster, 0)
                post = np.array(n.posterior)
                keep = [old for old in range(len(post)) if old in m]
                if keep:
                    p = post[keep]
                    p = p - np.logaddexp.reduce(p)
                    n.posterior = p.tolist()
                else:
                    n.posterior = [0.0]
            i += 1
    ds.encoded_reads = [er for er in ds.encoded_reads if er.nodes]
    logger.info("purge_diverged: removed %d nodes over %d (chunk,cluster)",
                removed_nodes, len(bad))
    if re_cluster:
        from .local_clustering import local_clustering
        local_clustering(ds, selection={c for c, _ in bad})
    ds.push_stage("PurgeDiverged", [])
    return ds


def purge_largeindel(ds: DataSet, indel_size: int = 100,
                     occupy_fraction: float = ACCEPT_RATE) -> DataSet:
    """Remove node occurrences with a large windowed indel run, if a
    cluster-consistent fraction shows it."""
    # per (chunk, cluster): indel sizes of member nodes
    distr = defaultdict(list)
    for ri, er in enumerate(ds.encoded_reads):
        for ni, n in enumerate(er.nodes):
            xs = []
            for k, l in n.cigar:
                if k == "M":
                    xs.append(-l * MATCH_WEIGHT)
                else:
                    xs.append(l * DEL_WEIGHT)
            size = max_region(xs) // DEL_WEIGHT
            distr[(n.chunk, n.cluster)].append((ri, ni, size))
    to_remove = defaultdict(set)
    purged = set()
    for cc, members in distr.items():
        big = [m for m in members if m[2] > indel_size]
        if len(big) >= occupy_fraction * len(members) and len(big) >= 2:
            purged.add(cc)
            for ri, ni, _ in big:
                to_remove[ri].add(ni)
    removed = 0
    for ri, nis in to_remove.items():
        er = ds.encoded_reads[ri]
        for ni in sorted(nis, reverse=True):
            er.remove(ni)
            removed += 1
    ds.encoded_reads = [er for er in ds.encoded_reads if er.nodes]
    logger.info("purge_largeindel: removed %d nodes (%d clusters)",
                removed, len(purged))
    ds.push_stage("PurgeLargeIndel", [f"indel_size={indel_size}"])
    return ds
