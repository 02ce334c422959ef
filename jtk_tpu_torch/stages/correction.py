"""Clustering correction — global phasing smoothing by spectral clustering.

Reference: ``haplotyper/src/phmm_likelihood_correction.rs`` — per chunk, every
covering read becomes a context of ordered neighbor (chunk, posterior) arms
(to_context :242-261); pairwise read similarity aligns the chunk-symbol arms
with SWG (gap open -0.5, extension/mismatch -100, :481-533) where the match
score is the log-odds that both reads draw the same cluster from their
posteriors given the per-cluster copy numbers (sim/logit :534-566),
sigmoid-squashed; similarities are sparsified by keeping each row's top
~R/(4*copy_num) entries above 0.51 (filter_similarity :330-347); the
normalized graph Laplacian's eigenvalue count below 0.2 picks k, the spectral
embedding (+ appended posteriors, column-normalized per normalize_columns
:299) is k-means clustered with 20 restarts; per-chunk ARI on posterior-
biased nodes decides squishing of the bottom quantile (:31-129, :220-241),
and hard posteriors (0 / -10000) are written back.

Vectorized host implementation: match scores are precomputed per chunk as
(n_c, n_c) posterior-agreement matrices (one logsumexp broadcast per chunk),
the SWG DP runs as numpy loops over the (arm x arm) grid with the whole
read-pair batch as the vector dimension, and eigendecompositions use
``np.linalg.eigh`` (matrices are coverage-sized; SURVEY.md §2.4).
"""

from __future__ import annotations

import logging
from collections import defaultdict

import numpy as np

from ..datamodel import DataSet
from .util import adjusted_rand_index

logger = logging.getLogger(__name__)

ARM_LEN_MIN = 8      # lower bound on the adaptive arm cap
ARM_LEN_MAX = 64     # upper bound (a 128 kbp read at 2 kbp chunks)
ARM_LEN = ARM_LEN_MIN  # backwards-compatible alias
EIG_THR = 0.2
HARD_NEG = -10000.0
GAP_OPEN = -0.5
GAP_EXTEND = -100.0
MISM = -100.0
MOCK_CP = 1.5
BIAS_THR = 0.2
MIN_REQ = 0.51


def estimate_copy_number_of_cluster(ds: DataSet) -> dict:
    """chunk_id -> per-cluster copy numbers (posterior-weighted counts /
    haploid coverage, min 1, topped up to the chunk copy number)
    (phmm_likelihood_correction.rs:131-178)."""
    from .util import update_coverage
    cov = ds.coverage.unwrap() if ds.coverage.is_available \
        else update_coverage(ds)
    cov = max(cov, 1e-9)
    chunks = {c.id: c for c in ds.selected_chunks}
    obs = {cid: np.zeros(max(c.cluster_num, 1))
           for cid, c in chunks.items()}
    for er in ds.encoded_reads:
        for n in er.nodes:
            if n.chunk not in obs:
                continue
            p = np.asarray(n.posterior, float)
            if len(p) != len(obs[n.chunk]):
                continue
            t = np.logaddexp.reduce(p)
            obs[n.chunk] += np.exp(p - t)
    out = {}
    for cid, o in obs.items():
        est = np.maximum(np.round(o / max(cov, 1e-9)), 1.0)
        total = chunks[cid].copy_num
        while est.sum() < total:
            est[int(np.argmax(o - est * cov))] += 1
        out[cid] = est
    return out


def _logit_from_lnp(lnp):
    lnp = np.clip(lnp, -80.0, -1.8e-35)
    return np.clip(lnp - np.log1p(-np.exp(lnp)), -80.0, 80.0)


def _sim_matrix(P: np.ndarray, cps: np.ndarray) -> np.ndarray:
    """(n, k) log-posteriors -> (n, n) pairwise agreement log-odds
    (sim, phmm_likelihood_correction.rs:534-556)."""
    k = P.shape[1]
    if k <= 1:
        v = -np.log(max(float(np.sum(cps)), MOCK_CP) - 1.0) \
            if max(float(np.sum(cps)), MOCK_CP) > 1.0 else 80.0
        return np.full((len(P), len(P)), v)
    x = P[:, None, :] + P[None, :, :] - np.log(np.maximum(cps, 1e-9))[None, None, :]
    m = x.max(-1)
    lnp = m + np.log(np.sum(np.exp(x - m[..., None]), -1))
    lnp = np.minimum(lnp, -1e-30)
    return _logit_from_lnp(lnp)


def _swg_batch(M: np.ndarray, len1: np.ndarray, len2: np.ndarray) -> np.ndarray:
    """Batched SWG over precomputed match matrices M (B, A, A); gaps open
    -0.5 / extend -100, free tail (max over last row+column within lengths)
    (align_swg, :481-533).

    Row-streaming: only three (B, A+1) rows are live, and the in-row gap
    recurrence d2[j] = max(mat[j-1]+o, d1[j-1]+o, d2[j-1]+e) is solved in
    closed form as a cummax — d2[j] = j·e + max_{j'<=j}(x[j'-1] + o - j'·e)
    with x = max(mat, d1) — so the whole DP is O(A) vectorized steps instead
    of O(A^2) Python iterations (full arms, A up to 64, stay affordable)."""
    B, A, _ = M.shape
    LOW = -1e18
    j_idx = np.arange(A + 1)
    bidx = np.arange(B)
    mat_p = np.full((B, A + 1), LOW)
    mat_p[:, 0] = 0.0
    d1_p = np.full((B, A + 1), LOW)
    d2_p = np.full((B, A + 1), LOW)
    d2_p[:, 1:] = GAP_OPEN + (j_idx[1:] - 1) * GAP_EXTEND

    def tails(best, i, out):
        # column len2 contributes at every row i <= len1; row len1 (over
        # j <= len2) contributes once, when i == len1
        out = np.maximum(out, np.where(i <= len1, best[bidx, len2], LOW))
        at_end = i == len1
        if at_end.any():
            masked = np.where(j_idx[None, :] <= len2[:, None], best, LOW)
            out = np.maximum(out, np.where(at_end, masked.max(1), LOW))
        return out

    out = tails(np.maximum(mat_p, d2_p), 0, np.full(B, LOW))
    for i in range(1, A + 1):
        best_prev = np.maximum(np.maximum(mat_p[:, :-1], d2_p[:, :-1]),
                               d1_p[:, :-1])
        mat_c = np.full((B, A + 1), LOW)
        mat_c[:, 1:] = best_prev + M[:, i - 1, :]
        d1_c = np.empty((B, A + 1))
        d1_c[:, 0] = GAP_OPEN + (i - 1) * GAP_EXTEND
        d1_c[:, 1:] = np.maximum(
            np.maximum(mat_p[:, 1:] + GAP_OPEN, d2_p[:, 1:] + GAP_OPEN),
            d1_p[:, 1:] + GAP_EXTEND)
        x = np.maximum(mat_c[:, :-1], d1_c[:, :-1]) + GAP_OPEN
        cm = np.maximum.accumulate(x - j_idx[1:] * GAP_EXTEND, axis=1)
        d2_c = np.full((B, A + 1), LOW)
        d2_c[:, 1:] = cm + j_idx[1:] * GAP_EXTEND
        out = tails(np.maximum(np.maximum(mat_c, d2_c), d1_c), i, out)
        mat_p, d1_p, d2_p = mat_c, d1_c, d2_c
    return out


def _contexts(ds: DataSet, occ, arm_len: int | None = None):
    """Per occurrence: center posterior + oriented arm (chunk, flat posterior
    index) lists (to_context, :242-261).  The reference keeps FULL read arms;
    ``arm_len=None`` does the same (callers cap adaptively, see
    :func:`_adaptive_arm_cap`)."""
    ctxs = []
    for ri, ni in occ:
        er = ds.encoded_reads[ri]
        n = er.nodes[ni]
        before = [(m.chunk, (ri, i)) for i, m in enumerate(er.nodes[:ni])][::-1]
        after = [(m.chunk, (ri, i))
                 for i, m in enumerate(er.nodes[ni + 1:], start=ni + 1)]
        if n.is_forward:
            up, down = before, after
        else:
            up, down = after, before
        if arm_len is not None:
            up, down = up[:arm_len], down[:arm_len]
        ctxs.append((n, up, down))
    return ctxs


def _adaptive_arm_cap(ctxs) -> int:
    """95th-percentile arm length, clamped to [ARM_LEN_MIN, ARM_LEN_MAX] —
    full context for nearly every read without letting one ultra-long
    outlier quadratically inflate the SWG grid."""
    lens = [max(len(u), len(d)) for _n, u, d in ctxs] or [0]
    p95 = int(np.ceil(np.percentile(lens, 95)))
    return int(np.clip(p95, ARM_LEN_MIN, ARM_LEN_MAX))


def _pair_similarities(ds: DataSet, ctxs, cluster_cps,
                       arm_len: int | None = None):
    """(R, R) sigmoid similarity matrix for one chunk's contexts."""
    R = len(ctxs)
    A_LEN = _adaptive_arm_cap(ctxs) if arm_len is None else arm_len
    ctxs = [(n, up[:A_LEN], down[:A_LEN]) for n, up, down in ctxs]
    # register every arm entry per chunk for grouped sim computation
    entry_index = {}   # (ri, ni) -> (chunk, idx within chunk group)
    groups = defaultdict(list)
    for _n, up, down in ctxs:
        for ch, key in up + down:
            if key not in entry_index:
                entry_index[key] = (ch, len(groups[ch]))
                groups[ch].append(key)
    sims = {}
    for ch, keys in groups.items():
        cps = cluster_cps.get(ch, np.ones(1))
        P = []
        for (ri, ni) in keys:
            p = np.asarray(ds.encoded_reads[ri].nodes[ni].posterior, float)
            P.append(p)
        k = max(len(p) for p in P)
        Pm = np.full((len(P), k), -30.0)
        for i, p in enumerate(P):
            Pm[i, :len(p)] = p
        if len(cps) != k:
            cps = np.ones(k)
        sims[ch] = _sim_matrix(Pm, cps)

    # per-occurrence arm arrays
    up_ch = np.full((R, A_LEN), -1, np.int64)
    up_ix = np.zeros((R, A_LEN), np.int64)
    up_len = np.zeros(R, np.int64)
    dn_ch = np.full((R, A_LEN), -1, np.int64)
    dn_ix = np.zeros((R, A_LEN), np.int64)
    dn_len = np.zeros(R, np.int64)
    for i, (_n, up, down) in enumerate(ctxs):
        for a, (ch, key) in enumerate(up):
            up_ch[i, a] = ch
            up_ix[i, a] = entry_index[key][1]
        up_len[i] = len(up)
        for a, (ch, key) in enumerate(down):
            dn_ch[i, a] = ch
            dn_ix[i, a] = entry_index[key][1]
        dn_len[i] = len(down)

    # center similarity
    center_chunk = ctxs[0][0].chunk
    kc = max(len(c[0].posterior) for c in ctxs)
    Pc = np.full((R, kc), -30.0)
    for i, (n, _u, _d) in enumerate(ctxs):
        Pc[i, :len(n.posterior)] = n.posterior
    cps_c = cluster_cps.get(center_chunk, np.ones(kc))
    if len(cps_c) != kc:
        cps_c = np.ones(kc)
    center_sim = _sim_matrix(Pc, cps_c)

    # batched arm alignment over all R^2 pairs, sliced so the (B, A, A)
    # match-matrix block stays bounded regardless of coverage x arm length
    ii_all, jj_all = np.meshgrid(np.arange(R), np.arange(R), indexing="ij")
    ii_all, jj_all = ii_all.reshape(-1), jj_all.reshape(-1)
    slice_b = max(int(3e7) // max(A_LEN * A_LEN, 1), 256)

    def arm_scores(ch_arr, ix_arr, len_arr, ii, jj):
        B = len(ii)
        M = np.full((B, A_LEN, A_LEN), MISM)
        c1 = ch_arr[ii]          # (B, A)
        c2 = ch_arr[jj]
        same = (c1[:, :, None] == c2[:, None, :]) & (c1[:, :, None] >= 0)
        # fill sim values chunk by chunk
        for ch, S in sims.items():
            m1 = c1 == ch
            m2 = c2 == ch
            if not m1.any() or not m2.any():
                continue
            pick = same & m1[:, :, None] & m2[:, None, :]
            b, a1, a2 = np.nonzero(pick)
            M[b, a1, a2] = S[ix_arr[ii][b, a1], ix_arr[jj][b, a2]]
        return _swg_batch(M, len_arr[ii], len_arr[jj])

    total = np.empty(R * R)
    for s in range(0, R * R, slice_b):
        ii, jj = ii_all[s:s + slice_b], jj_all[s:s + slice_b]
        total[s:s + slice_b] = arm_scores(up_ch, up_ix, up_len, ii, jj) \
            + arm_scores(dn_ch, dn_ix, dn_len, ii, jj) \
            + center_sim[ii, jj]
    A = 1.0 / (1.0 + np.exp(-np.clip(total, -60, 60)))
    A = A.reshape(R, R)
    np.fill_diagonal(A, 0.0)
    return A


def _filter_similarity(A: np.ndarray, copy_num: int) -> np.ndarray:
    """Keep each row's entries above max(nth-smallest, 0.51), symmetrized
    (filter_similarity, :330-347).  A floor of 5 kept neighbors guards the
    low-coverage degenerate case where top-R/(4*copy) fragments each
    haplotype into posterior-label subgroups."""
    R = len(A)
    keep_n = max(R // max(copy_num, 1) // 4, 5)
    nth = max(R - keep_n, 0)
    keep = np.zeros_like(A, bool)
    for i in range(R):
        row = np.sort(A[i])
        thr = max(row[min(nth, R - 1)], MIN_REQ)
        keep[i] = A[i] >= thr
    keep |= keep.T
    return np.where(keep, A, 0.0)


def correct_clustering(ds: DataSet, repeat_num: int = 5,
                       coverage_thr: int = 5,
                       squish_quantile: float = 0.05,
                       seed: int = 42) -> DataSet:
    rng = np.random.default_rng(seed)
    chunks = {c.id: c for c in ds.selected_chunks}
    cluster_cps = estimate_copy_number_of_cluster(ds)
    occurrences = defaultdict(list)  # chunk -> [(read_idx, node_idx)]
    for ri, er in enumerate(ds.encoded_reads):
        for ni, n in enumerate(er.nodes):
            occurrences[n.chunk].append((ri, ni))
    aris = {}
    new_assignments = {}
    for cid, occ in occurrences.items():
        chunk = chunks.get(cid)
        if chunk is None or len(occ) < coverage_thr:
            continue
        if chunk.cluster_num <= 1:
            continue
        R = len(occ)
        ctxs = _contexts(ds, occ)
        A = _pair_similarities(ds, ctxs, cluster_cps)
        A = _filter_similarity(A, chunk.copy_num)
        d = A.sum(1) + 1e-9
        Dm = 1.0 / np.sqrt(d)
        L = np.eye(R) - Dm[:, None] * A * Dm[None, :]
        evals, evecs = np.linalg.eigh(L)
        pick_k = int(max(np.sum(evals < EIG_THR), 1))
        k = int(min(chunk.cluster_num, pick_k))
        if k <= 1:
            asn = np.zeros(R, np.int64)
        else:
            emb = evecs[:, :pick_k] * Dm[:, None]
            post = np.array([np.exp(np.asarray(c[0].posterior))
                             if len(c[0].posterior) == chunk.cluster_num
                             else np.zeros(chunk.cluster_num)
                             for c in ctxs])
            if post.shape[1] > 0:
                emb = np.concatenate([emb, post], axis=1)
            # the reference normalizes COLUMNS (normalize_columns, :299)
            emb = emb / (np.linalg.norm(emb, axis=0, keepdims=True) + 1e-9)
            asn = _kmeans_multi(emb, k, rng, restarts=20)
        old = np.array([ds.encoded_reads[ri].nodes[ni].cluster
                        for ri, ni in occ])
        # ARI restricted to posterior-biased nodes (adj_rand_on_biased)
        biased = np.array([ds.encoded_reads[ri].nodes[ni].is_biased(BIAS_THR)
                           for ri, ni in occ])
        if biased.sum() >= 2:
            ari = adjusted_rand_index(old[biased], asn[biased])
            if np.isnan(ari):
                ari = 1.0
        else:
            ari = adjusted_rand_index(old, asn)
        aris[cid] = ari
        new_assignments[cid] = (asn, k)
    if not new_assignments:
        ds.push_stage("ClusteringCorrection", [])
        return ds
    # squish low-agreement chunks unless protected by a high clustering score
    ari_vals = sorted(aris.values())
    cutoff = min(ari_vals[max(int(len(ari_vals) * squish_quantile) - 1, 0)]
                 if ari_vals else -1.0, 0.5)
    scores = [chunks[c].score for c in aris]
    protect_score = np.quantile(scores, 0.5) if scores else 0.0
    for cid, (asn, k) in new_assignments.items():
        chunk = chunks[cid]
        if aris[cid] < cutoff and chunk.score < protect_score:
            chunk.cluster_num = 1
            for ri, ni in occurrences[cid]:
                node = ds.encoded_reads[ri].nodes[ni]
                node.cluster = 0
                node.posterior = [0.0]
            continue
        chunk.cluster_num = int(k)
        for (ri, ni), a in zip(occurrences[cid], asn):
            node = ds.encoded_reads[ri].nodes[ni]
            node.cluster = int(a)
            node.posterior = [0.0 if c == a else HARD_NEG for c in range(k)]
    logger.info("correct_clustering: %d chunks corrected, mean ARI %.3f",
                len(new_assignments), float(np.mean(list(aris.values()))))
    ds.push_stage("ClusteringCorrection", [])
    return ds


def _kmeans_multi(X, k, rng, restarts=20, iters=30):
    best, best_obj = None, np.inf
    R = len(X)
    for _ in range(restarts):
        centers = X[rng.choice(R, size=k, replace=False)]
        for _ in range(iters):
            d = ((X[:, None] - centers[None]) ** 2).sum(-1)
            asn = d.argmin(1)
            for c in range(k):
                m = asn == c
                if m.any():
                    centers[c] = X[m].mean(0)
        obj = ((X - centers[asn]) ** 2).sum()
        if obj < best_obj:
            best, best_obj = asn.copy(), obj
    return best
