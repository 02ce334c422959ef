"""Clustering on the device: k-means++ init + Metropolis refinement.

Counterpart of ``jtk_tpu/ops/cluster.py``.  Objective ``get_lk``: Poisson
cluster-size prior (best multiple of haploid coverage) plus, for every
*used* column, the positive part of each cluster's column gain.  All
restarts of many chunks run as parallel lanes (B, restarts) of one
Metropolis chain in plain PyTorch; each step is O(K·V) tensor work per lane.

The random draws are injectable (``draws``): the Gumbel noise behind the
k-means++ categorical picks and, per step, ``u_idx`` (which read), ``prop``
(which other cluster) and ``u`` (the acceptance uniform).  Production draws
them from a ``torch.Generator``; a test can feed the JAX package's draws and
get identical assignments.
"""

from __future__ import annotations

import numpy as np
import torch

POS_THR = 1e-5
POS_FRAC = 0.70
IN_POS_RATIO = 2.0
DRAW_BLOCK = 1024   # steps of random draws generated at a time


def poisson_size_table(Rmax: int, cov: float, K: int) -> np.ndarray:
    """size_to_lk[x] = max_{1<=c<=K} log Poisson(x | c*cov)."""
    xs = np.arange(Rmax + 1, dtype=np.float64)
    best = np.full(Rmax + 1, -np.inf)
    for c in range(1, max(K, 1) + 1):
        lam = max(cov * c, 1e-3)
        lp = xs * np.log(lam) - lam - np.array(
            [np.sum(np.log(np.arange(1, int(x) + 1))) if x > 0 else 0.0 for x in xs])
        best = np.maximum(best, lp)
    return best.astype(np.float32)


def _objective(agg_gain, agg_pos, agg_neg, counts, size_lk):
    """Vectorized get_lk: (…, K, V) aggregates -> (…,) scalar."""
    informative = (agg_gain > 0) & (
        agg_pos > POS_FRAC * (agg_pos + agg_neg + 1e-7))
    any_inf = informative.any(-2)                                 # (..., V)
    pos_in_use = torch.where(agg_gain > 0, agg_pos, 0.0).sum(-2)
    pos_in_neg = torch.where(agg_gain <= 0, agg_pos, 0.0).sum(-2)
    used = any_inf & (pos_in_neg * IN_POS_RATIO < pos_in_use)     # (..., V)
    gain_term = torch.where(used[..., None, :], agg_gain.clamp(min=0.0),
                            0.0).sum((-1, -2))
    cidx = counts.to(torch.int64).clamp(0, size_lk.shape[-1] - 1)
    size_term = torch.gather(size_lk.expand(*cidx.shape[:-1], -1), -1,
                             cidx).sum(-1)
    return gain_term + size_term


def _one_hot(idx, K, dtype):
    return torch.nn.functional.one_hot(idx, K).to(dtype)


def _aggregates(X, w, assign, K):
    """(…, R, V) features, (…, R) weights, (…, R) assignment -> per-cluster
    (gain, pos, neg, counts)."""
    oh = _one_hot(assign, K, X.dtype) * w[..., None]              # (…, R, K)
    ohT = oh.transpose(-1, -2)                                    # (…, K, R)
    agg_gain = ohT @ X
    agg_pos = ohT @ (X > POS_THR).to(X.dtype)
    agg_neg = ohT @ (X < -POS_THR).to(X.dtype)
    counts = oh.sum(-2)
    return agg_gain, agg_pos, agg_neg, counts


def _kmeanspp_init(X, w, gumbel, K, lloyd_iters=10):
    """k-means++ seeding + Lloyd iterations for every (batch, restart) lane.

    X (B, R, V), w (B, R), gumbel (B, S, K, R) noise: pick j is
    argmax(logits + gumbel[:, :, j]) (a categorical draw).
    Returns assign (B, S, R)."""
    B, R, V = X.shape
    S = gumbel.shape[1]
    bidx = torch.arange(B, device=X.device)[:, None]
    logw = torch.where(w > 0, 0.0, -torch.inf)                   # (B, R)
    first = torch.argmax(gumbel[:, :, 0] + logw[:, None], -1)     # (B, S)
    centers = torch.zeros((B, S, K, V), dtype=X.dtype, device=X.device)
    centers[:, :, 0] = X[bidx, first]
    Xe = X[:, None, None]                                         # (B,1,1,R,V)

    def dist2(c):
        return ((Xe - c[:, :, :, None]) ** 2).sum(-1)             # (B,S,K,R)

    kk = torch.arange(K, device=X.device)[:, None]
    for j in range(1, K):
        d2 = torch.where(kk < j, dist2(centers), torch.inf).min(2).values
        logits = torch.where(w[:, None] > 0, torch.log(d2 + 1e-9), -torch.inf)
        nxt = torch.argmax(gumbel[:, :, j] + logits, -1)
        centers[:, :, j] = X[bidx, nxt]
    for _ in range(lloyd_iters):
        assign = torch.argmin(dist2(centers), 2)                  # (B, S, R)
        oh = _one_hot(assign, K, X.dtype) * w[:, None, :, None]   # (B,S,R,K)
        tot = oh.sum(2)[..., None] + 1e-9
        newc = (oh.transpose(-1, -2) @ X[:, None]) / tot
        keep = (oh.sum(2) > 0)[..., None]
        centers = torch.where(keep, newc, centers)
    assign = torch.argmin(dist2(centers), 2)
    return torch.where(w[:, None] > 0, assign, 0)


def _gumbel(shape, gen, device):
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp(min=1e-20)))


def mcmc_cluster_batch(X, R_actual, size_lk, K: int, steps: int,
                       restarts: int, generator=None, draws=None,
                       device=None):
    """Cluster a batch of feature matrices.

    X: (B, Rmax, V) float32, padded rows zero.  R_actual: (B,).
    size_lk: (B, Rmax+1) Poisson size prior tables.  Random draws come from
    ``generator`` (a torch.Generator on the device) unless ``draws`` gives
    them: ``init_gumbel`` (B, restarts, K, Rmax), and per step ``u_idx``,
    ``prop`` (ints in [0, K-1)) and ``u``, each (steps, B, restarts).
    Returns numpy (best_assign (B, Rmax) int32, best_score (B,) f32)."""
    from ..runtime import resolve
    dev = resolve(device)
    X = torch.as_tensor(np.asarray(X, np.float32), device=dev)
    B, Rmax, V = X.shape
    Ra = torch.as_tensor(np.asarray(R_actual), device=dev)
    size_lk = torch.as_tensor(np.asarray(size_lk, np.float32), device=dev)
    w = (torch.arange(Rmax, device=dev)[None] < Ra[:, None]).to(X.dtype)
    S = restarts

    def drawn(name, t0, t1, dtype):
        return torch.as_tensor(np.asarray(draws[name][t0:t1]), dtype=dtype,
                               device=dev)

    if draws is not None:
        g0 = torch.as_tensor(np.asarray(draws["init_gumbel"], np.float32),
                             device=dev)
    else:
        g0 = _gumbel((B, S, K, Rmax), generator, dev)
    assign = _kmeanspp_init(X, w, g0, K)                          # (B, S, R)
    Xl = X[:, None].expand(B, S, Rmax, V)
    agg_gain, agg_pos, agg_neg, counts = _aggregates(
        Xl, w[:, None].expand(B, S, Rmax), assign, K)
    sl = size_lk[:, None, :]
    lk = _objective(agg_gain, agg_pos, agg_neg, counts, sl)
    best_lk, best_assign = lk, assign
    bidx = torch.arange(B, device=dev)[:, None]
    Rf = Ra.to(torch.float32)[:, None]
    for t0 in range(0, steps, DRAW_BLOCK):
        t1 = min(steps, t0 + DRAW_BLOCK)
        if draws is not None:
            U_idx = drawn("u_idx", t0, t1, torch.float32)
            PROP = drawn("prop", t0, t1, torch.int64)
            U = drawn("u", t0, t1, torch.float32)
        else:
            shp = (t1 - t0, B, S)
            U_idx = torch.rand(shp, generator=generator, device=dev)
            PROP = torch.randint(0, K - 1, shp, generator=generator,
                                 device=dev)
            U = torch.rand(shp, generator=generator, device=dev)
        for t in range(t1 - t0):
            idx = torch.floor(U_idx[t] * Rf).to(torch.int64) \
                .clamp(0, Rmax - 1)
            old = torch.gather(assign, 2, idx[..., None])[..., 0]
            prop = PROP[t]
            new = prop + (prop >= old).to(torch.int64)
            x_row = X[bidx, idx]                                  # (B, S, V)
            p_row = (x_row > POS_THR).to(X.dtype)
            n_row = (x_row < -POS_THR).to(X.dtype)
            delta = -_one_hot(old, K, X.dtype) + _one_hot(new, K, X.dtype)
            dl = delta[..., None]
            g_n = agg_gain + dl * x_row[..., None, :]
            p_n = agg_pos + dl * p_row[..., None, :]
            n_n = agg_neg + dl * n_row[..., None, :]
            c_n = counts + delta
            lk_new = _objective(g_n, p_n, n_n, c_n, sl)
            accept = (lk_new - lk) > torch.log(U[t] + 1e-30)
            acc = accept[..., None]
            accm = accept[..., None, None]
            assign = torch.where(acc, assign.scatter(2, idx[..., None],
                                                     new[..., None]), assign)
            agg_gain = torch.where(accm, g_n, agg_gain)
            agg_pos = torch.where(accm, p_n, agg_pos)
            agg_neg = torch.where(accm, n_n, agg_neg)
            counts = torch.where(acc, c_n, counts)
            lk = torch.where(accept, lk_new, lk)
            better = lk > best_lk
            best_lk = torch.where(better, lk, best_lk)
            best_assign = torch.where(better[..., None], assign, best_assign)
    best_r = torch.argmax(best_lk, 1)
    out_assign = best_assign[torch.arange(B, device=dev), best_r]
    best_score = best_lk.max(1).values
    return (out_assign.cpu().numpy().astype(np.int32),
            best_score.cpu().numpy().astype(np.float32))


def used_columns_and_gains(X: np.ndarray, assign: np.ndarray, k: int):
    """Host-side get_used_columns + per-(read,cluster) gains
    (pseudo_mcmc.rs:846-869, :354-379).  X: (R, V)."""
    R, V = X.shape
    agg_gain = np.zeros((k, V))
    agg_pos = np.zeros((k, V))
    agg_neg = np.zeros((k, V))
    for r in range(R):
        a = assign[r]
        agg_gain[a] += X[r]
        agg_pos[a] += X[r] > POS_THR
        agg_neg[a] += X[r] < -POS_THR
    informative = (agg_gain > 0) & (agg_pos > POS_FRAC * (agg_pos + agg_neg + 1e-7))
    pos_in_use = np.where(agg_gain > 0, agg_pos, 0).sum(0)
    pos_in_neg = np.where(agg_gain <= 0, agg_pos, 0).sum(0)
    used = informative.any(0) & (pos_in_neg * IN_POS_RATIO < pos_in_use)
    # likelihood gains: read x cluster sums over used columns with positive
    # cluster gain
    sel = used[None, :] & (agg_gain > POS_THR)        # (k, V)
    lk_gain = X @ np.where(sel, 1.0, 0.0).T           # (R, k)
    return used, lk_gain
