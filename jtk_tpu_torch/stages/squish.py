"""Squish erroneous clusterings that are inconsistent with their neighbors.

Reference: ``haplotyper/src/squish_erroneous_clusters.rs`` — pairwise adjusted
Rand index between co-occurring clustered chunks computed on posterior-biased
nodes only (check_correl :213-252), a stiff/non-stiff partition of chunks by
10 rounds of greedy sweep + 1000-step Metropolis MCMC (classify_nodes
:281-365; edge score = count * {match_score if ari > thr else mismatch_score}
counted only between stiff endpoints), and chunks that are not stiff but
touch a stiff chunk are classed Suspicious and squished to one cluster
(:44-60, :137-160).  Chunks with copy_num > 2 are always Stiff.
"""

from __future__ import annotations

import logging
from collections import defaultdict

import numpy as np

from ..datamodel import DataSet
from .util import adjusted_rand_index

logger = logging.getLogger(__name__)

BIAS_THR = 0.2


def _chunk_pair_counts(ds: DataSet, clustered: set, count: int):
    """(c1, c2) -> co-occurrence count over biased node pairs within reads
    (all i<j position pairs, squish_erroneous_clusters.rs:79-90)."""
    pair_counts = defaultdict(int)
    for er in ds.encoded_reads:
        biased = [n.chunk for n in er.nodes if n.is_biased(BIAS_THR)]
        for i in range(len(biased)):
            for j in range(i + 1, len(biased)):
                a, b = biased[i], biased[j]
                key = (min(a, b), max(a, b))
                pair_counts[key] += 1
    return {k: v for k, v in pair_counts.items()
            if v > count and k[0] in clustered and k[1] in clustered}


def _check_correl(ds: DataSet, pairs):
    """Pair -> (rel_value, n_shared): ARI of the per-read min-cluster columns
    over reads carrying biased nodes of both chunks (rs:213-252)."""
    cols = defaultdict(lambda: ([], []))
    wanted_left = defaultdict(list)
    for (a, b) in pairs:
        wanted_left[a].append((a, b))
        wanted_left[b].append((a, b))
    for er in ds.encoded_reads:
        per_chunk = {}
        for n in er.nodes:
            if n.is_biased(BIAS_THR):
                cur = per_chunk.get(n.chunk)
                if cur is None or n.cluster < cur:
                    per_chunk[n.chunk] = n.cluster
        seen = set()
        for c in per_chunk:
            for key in wanted_left.get(c, ()):
                if key in seen:
                    continue
                seen.add(key)
                a, b = key
                if a in per_chunk and b in per_chunk:
                    cols[key][0].append(per_chunk[a])
                    cols[key][1].append(per_chunk[b])
    out = {}
    for key in pairs:
        c1, c2 = cols.get(key, ([], []))
        if not c1:
            out[key] = (0.0, 0)
            continue
        same1 = all(x == c1[0] for x in c1)
        same2 = all(x == c2[0] for x in c2)
        if same1 and same2:
            # both constant: uninformative agreement (cluster_num>1 is
            # guaranteed by the caller's filter, so rel = 1.0 per rs:242-246)
            out[key] = (1.0, len(c1))
            continue
        r = adjusted_rand_index(c1, c2)
        if not np.isfinite(r):
            r = 0.0
        out[key] = (float(r), len(c1))
    return out


def _classify_nodes(n: int, edges, ari_thr: float, match_score: float,
                    mismatch_score: float, seed: int = 3093240):
    """Stiff/non-stiff assignment: 10 x (greedy wipe + 1000-step Metropolis),
    score counted on edges whose BOTH endpoints are stiff (rs:281-365).

    ``edges``: list of (u, v, ari, count).  Returns boolean array (stiff)."""
    # CSR adjacency with per-edge scores (ari clamped to [0,1], rs:263)
    adj = [[] for _ in range(n)]
    for (u, v, ari, count) in edges:
        ari = min(max(ari, 0.0), 1.0)
        w = count * (mismatch_score if ari <= ari_thr else match_score)
        adj[u].append((v, w))
        adj[v].append((u, w))
    nbr_idx = [np.array([x for x, _ in a], dtype=np.int64) for a in adj]
    nbr_w = [np.array([w for _, w in a], dtype=np.float64) for a in adj]
    stiff = np.ones(n, dtype=bool)
    rng = np.random.default_rng(seed)

    def diff_on_flip(i):
        s = float(np.sum(nbr_w[i][stiff[nbr_idx[i]]])) if len(nbr_idx[i]) else 0.0
        return -s if stiff[i] else s

    for _round in range(10):
        # greedy wipe-through in index order
        for i in range(n):
            if diff_on_flip(i) > 0.0:
                stiff[i] = not stiff[i]
        # Metropolis: always accept improving flips, worsening with exp(diff)
        targets = rng.integers(0, n, size=1000)
        accept_draws = rng.random(1000)
        for i, u in zip(targets, accept_draws):
            d = diff_on_flip(int(i))
            if u < np.exp(min(d, 0.0)):
                stiff[int(i)] = not stiff[int(i)]
    return stiff


def squish_erroneous_clusters(ds: DataSet, ari: float = 0.5,
                              match_score: float = 4.0,
                              mismatch_score: float = -1.0,
                              count: int = 10) -> DataSet:
    clustered = {c.id for c in ds.selected_chunks if c.cluster_num > 1}
    pair_counts = _chunk_pair_counts(ds, clustered, count)
    rels = _check_correl(ds, list(pair_counts)) if pair_counts else {}
    copy_num = {c.id: (c.copy_num or 1) for c in ds.selected_chunks}

    # index the touched chunks; classify stiff via greedy+MCMC
    ids = sorted({c for key in rels for c in key})
    index = {c: i for i, c in enumerate(ids)}
    edges = [(index[a], index[b], r, cnt)
             for (a, b), (r, cnt) in rels.items()]
    if edges:
        stiff_arr = _classify_nodes(len(ids), edges, ari, match_score,
                                    mismatch_score)
        stiff_set = {c for c in ids if stiff_arr[index[c]]}
    else:
        stiff_set = set()

    touch = defaultdict(set)
    for (a, b) in rels:
        touch[a].add(b)
        touch[b].add(a)
    squished = set()
    for c in ds.selected_chunks:
        if c.id in stiff_set or copy_num.get(c.id, 1) > 2:
            continue  # Stiff
        if any(o in stiff_set for o in touch.get(c.id, ())):
            squished.add(c.id)  # Suspicious
        # else Isolated: left alone
    chunks = {c.id: c for c in ds.selected_chunks}
    for cid in squished:
        chunks[cid].cluster_num = 1
        chunks[cid].score = 0.0
    for er in ds.encoded_reads:
        for n in er.nodes:
            if n.chunk in squished:
                n.cluster = 0
                n.posterior = [0.0]
    logger.info("squish: %d/%d clustered chunks squished", len(squished),
                len(clustered))
    ds.push_stage("SquishErroneousClusters", [f"ari={ari}"])
    return ds
