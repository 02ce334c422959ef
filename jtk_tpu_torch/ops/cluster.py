"""Clustering on the device: k-means++ init + Metropolis refinement.

Counterpart of ``jtk_tpu/ops/cluster.py``.  Objective ``get_lk``: Poisson
cluster-size prior (best multiple of haploid coverage) plus, for every
*used* column, the positive part of each cluster's column gain.  All
restarts of many chunks run as parallel lanes (B, restarts) of one
Metropolis chain.  The seeding (k-means++ and Lloyd steps), the starting
aggregates and the final pick of the best restart are plain PyTorch; the
chain itself (``jtk_tpu``'s ``lax.scan``) is :func:`mcmc_chain`, the
kernel of ``csrc/mcmc_chain.cu`` on a CUDA tensor and
:func:`mcmc_chain_plain` on a CPU tensor, launched once per block of
DRAW_BLOCK steps.  The objective sums in a fixed order, so kernel and
plain chain give the same bits.

The random draws are injectable (``draws``): the Gumbel noise behind the
k-means++ categorical picks and, per step, ``u_idx`` (which read), ``prop``
(which other cluster) and ``u`` (the acceptance uniform).  Production draws
them from a ``torch.Generator``, a block at a time; a test can feed the JAX
package's draws and get identical assignments.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_build import Launches, check, launch

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


def _tree_sum(s):
    """Sum over the last dim by a fixed pairwise tree: padded with zeros to a
    power of two, then ``s[..., :h] + s[..., h:2h]``, halving.  A warp's
    ``__shfl_down_sync`` tree over 32 lanes (``csrc/mcmc_chain.cu``) adds
    the same pairs in the same order."""
    V = s.shape[-1]
    P = 1 << max(V - 1, 0).bit_length()
    s = torch.nn.functional.pad(s, (0, P - V))
    while P > 1:
        P //= 2
        s = s[..., :P] + s[..., P:2 * P]
    return s[..., 0]


def _objective(agg_gain, agg_pos, agg_neg, counts, size_lk):
    """Vectorized get_lk: (…, K, V) aggregates -> (…,) scalar.

    The float sums run in a fixed order that the chain kernel reproduces
    bit for bit: a column's K clusters in index order, then the columns by
    :func:`_tree_sum`; the size term's K terms in index order.  (The
    positive counts are whole numbers: their sums are exact in any
    order.)"""
    informative = (agg_gain > 0) & (
        agg_pos > POS_FRAC * (agg_pos + agg_neg + 1e-7))
    any_inf = informative.any(-2)                                 # (..., V)
    pos_in_use = torch.where(agg_gain > 0, agg_pos, 0.0).sum(-2)
    pos_in_neg = torch.where(agg_gain <= 0, agg_pos, 0.0).sum(-2)
    used = any_inf & (pos_in_neg * IN_POS_RATIO < pos_in_use)     # (..., V)
    pos = torch.where(used[..., None, :], agg_gain.clamp(min=0.0), 0.0)
    col = pos[..., 0, :]
    for k in range(1, pos.shape[-2]):
        col = col + pos[..., k, :]
    cidx = counts.to(torch.int64).clamp(0, size_lk.shape[-1] - 1)
    size = torch.gather(size_lk.expand(*cidx.shape[:-1], -1), -1, cidx)
    size_term = size[..., 0]
    for k in range(1, size.shape[-1]):
        size_term = size_term + size[..., k]
    return _tree_sum(col) + size_term


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


def chain_start(X, w, size_lk, K: int, gumbel):
    """The chain's starting state from k-means++ seeding and Lloyd steps:
    a dict of tensors (``assign``, ``best_assign`` (B, S, R) int32;
    ``agg_gain``, ``agg_pos``, ``agg_neg`` (B, S, K, V) f32; ``counts``
    (B, S, K) f32; ``lk``, ``best_lk`` (B, S) f32).  X (B, R, V), w (B, R)
    row weights, size_lk (B, R + 1), gumbel (B, S, K, R)."""
    B, Rmax, V = X.shape
    S = gumbel.shape[1]
    assign = _kmeanspp_init(X, w, gumbel, K)                      # (B, S, R)
    agg_gain, agg_pos, agg_neg, counts = _aggregates(
        X[:, None].expand(B, S, Rmax, V), w[:, None].expand(B, S, Rmax),
        assign, K)
    lk = _objective(agg_gain, agg_pos, agg_neg, counts, size_lk[:, None, :])
    assign = assign.to(torch.int32)
    return dict(assign=assign, best_assign=assign.clone(),
                agg_gain=agg_gain.contiguous(), agg_pos=agg_pos.contiguous(),
                agg_neg=agg_neg.contiguous(), counts=counts.contiguous(),
                lk=lk.contiguous(), best_lk=lk.clone())


def generator_block(generator, shape, K: int, device):
    """One draw block's uniforms from ``generator``: (U_idx, PROP, U),
    each ``shape`` = (T, B, S), by the calls and in the order the chain has
    always drawn them."""
    U_idx = torch.rand(shape, generator=generator, device=device)
    PROP = torch.randint(0, K - 1, shape, generator=generator, device=device)
    U = torch.rand(shape, generator=generator, device=device)
    return U_idx, PROP, U


def block_draws(U_idx, PROP, U, R_actual, Rmax: int):
    """One draw block's steps from its uniforms: (idx, prop, logu), each
    (T, B, S).  The same tensor expressions as a step's, on the whole block
    (they are elementwise)."""
    Rf = R_actual.to(torch.float32)[:, None]
    idx = torch.floor(U_idx * Rf).to(torch.int64).clamp(0, Rmax - 1)
    return idx, PROP.to(torch.int64), torch.log(U + 1e-30)


def mcmc_chain_plain(st, X, size_lk, idx, prop, logu):
    """Plain PyTorch version of the chain kernel: advance the chain state
    ``st`` (see :func:`chain_start`) in place over the steps of one draw
    block (idx, prop, logu: (T, B, S)).  Each step picks read idx, moves it
    to cluster prop (skipping its own), re-scores the objective and accepts
    if lk_new - lk > logu; the best state is kept on a strict >."""
    B, Rmax, V = X.shape
    K = st["counts"].shape[-1]
    assign, best_assign = st["assign"], st["best_assign"]
    agg_gain, agg_pos, agg_neg = st["agg_gain"], st["agg_pos"], st["agg_neg"]
    counts, lk, best_lk = st["counts"], st["lk"], st["best_lk"]
    bidx = torch.arange(B, device=X.device)[:, None]
    sl = size_lk[:, None, :]
    for t in range(idx.shape[0]):
        i = idx[t]
        old = torch.gather(assign, 2, i[..., None])[..., 0].to(torch.int64)
        new = prop[t] + (prop[t] >= old).to(torch.int64)
        x_row = X[bidx, i]                                        # (B, S, V)
        p_row = (x_row > POS_THR).to(X.dtype)
        n_row = (x_row < -POS_THR).to(X.dtype)
        delta = -_one_hot(old, K, X.dtype) + _one_hot(new, K, X.dtype)
        dl = delta[..., None]
        g_n = agg_gain + dl * x_row[..., None, :]
        p_n = agg_pos + dl * p_row[..., None, :]
        n_n = agg_neg + dl * n_row[..., None, :]
        c_n = counts + delta
        lk_new = _objective(g_n, p_n, n_n, c_n, sl)
        accept = (lk_new - lk) > logu[t]
        acc = accept[..., None]
        accm = accept[..., None, None]
        assign = torch.where(acc, assign.scatter(
            2, i[..., None], new[..., None].to(assign.dtype)), assign)
        agg_gain = torch.where(accm, g_n, agg_gain)
        agg_pos = torch.where(accm, p_n, agg_pos)
        agg_neg = torch.where(accm, n_n, agg_neg)
        counts = torch.where(acc, c_n, counts)
        lk = torch.where(accept, lk_new, lk)
        better = lk > best_lk
        best_lk = torch.where(better, lk, best_lk)
        best_assign = torch.where(better[..., None], assign, best_assign)
    for name, v in (("assign", assign), ("best_assign", best_assign),
                    ("agg_gain", agg_gain), ("agg_pos", agg_pos),
                    ("agg_neg", agg_neg), ("counts", counts), ("lk", lk),
                    ("best_lk", best_lk)):
        if v is not st[name]:
            st[name].copy_(v)


CHAIN_LAUNCHES = Launches("mcmc_chain")
SMEM_LIMIT = 232448      # bytes of shared memory a block may use (H100)


def chain_smem_bytes(K: int, V: int, Rmax: int) -> int:
    """Shared memory of one chain (one warp) in the general form: the K x
    Vp aggregates (Vp = V padded to 32 times a power of two), a column
    scratch, the counts and the assignment (``csrc/mcmc_chain.cu``; the
    register form takes less, the size table and two assignments)."""
    Vp = 32 * chain_groups(V)
    return 4 * (3 * K * Vp + Vp + K + Rmax)


def chain_groups(V: int) -> int:
    """Column groups of 32 a lane walks: V padded to a power of two,
    over 32 (at least 1)."""
    P = 1 << max(V - 1, 0).bit_length()
    return max(1, P // 32)


def chain_form(K: int, V: int, Rmax: int) -> str:
    """The kernel's form for K clusters, V columns and Rmax reads:
    "registers" (K 2..4, V <= 32 and the Rmax x V features within a block's
    shared memory: each lane keeps its column's aggregates in registers)
    or "general" (the aggregates in shared memory)."""
    small = 4 * (Rmax * V + 3 * Rmax + 1) <= SMEM_LIMIT
    return "registers" if 2 <= K <= 4 and V <= 32 and small else "general"


def mcmc_chain(st, X, size_lk, idx, prop, logu, general: bool = False):
    """Advance the chain state ``st`` in place over one draw block.

    On CUDA tensors this launches the kernel of ``csrc/mcmc_chain.cu``, one
    warp per (chunk, restart) lane, bit-exact against
    :func:`mcmc_chain_plain`, in the form :func:`chain_form` picks (the
    general form for every K and V with ``general``, for timing the two
    against each other); on CPU tensors it runs the plain version."""
    if X.device.type == "cpu":
        return mcmc_chain_plain(st, X, size_lk, idx, prop, logu)
    B, Rmax, V = X.shape
    T, _, S = idx.shape
    K = st["counts"].shape[-1]
    smem = chain_smem_bytes(K, V, Rmax)
    if smem > SMEM_LIMIT:
        raise ValueError(f"mcmc_chain: K {K}, V {V} and Rmax {Rmax} need "
                         f"{smem} bytes of shared memory a chain, above "
                         f"{SMEM_LIMIT}")
    f32, i32 = torch.float32, torch.int32
    idx32 = idx.to(i32).contiguous()
    prop32 = prop.to(i32).contiguous()
    for t, name, dt, shape in (
            (X, "X", f32, (B, Rmax, V)), (size_lk, "size_lk", f32,
                                          (B, Rmax + 1)),
            (idx32, "idx", i32, (T, B, S)), (prop32, "prop", i32, (T, B, S)),
            (logu, "logu", f32, (T, B, S)),
            (st["assign"], "assign", i32, (B, S, Rmax)),
            (st["best_assign"], "best_assign", i32, (B, S, Rmax)),
            (st["agg_gain"], "agg_gain", f32, (B, S, K, V)),
            (st["agg_pos"], "agg_pos", f32, (B, S, K, V)),
            (st["agg_neg"], "agg_neg", f32, (B, S, K, V)),
            (st["counts"], "counts", f32, (B, S, K)),
            (st["lk"], "lk", f32, (B, S)),
            (st["best_lk"], "best_lk", f32, (B, S))):
        check(t, dt, shape, f"mcmc_chain {name}")
    launch("mcmc_chain", "mcmc_chain_launch", X, size_lk, idx32, prop32,
           logu, st["assign"], st["best_assign"], st["agg_gain"],
           st["agg_pos"], st["agg_neg"], st["counts"], st["lk"],
           st["best_lk"], B, S, Rmax, K, V, chain_groups(V), T, smem,
           int(general))
    CHAIN_LAUNCHES.add((B, S, K, V, Rmax))


def mcmc_cluster_batch(X, R_actual, size_lk, K: int, steps: int,
                       restarts: int, generator=None, draws=None,
                       device=None):
    """Cluster a batch of feature matrices.

    X: (B, Rmax, V) float32, padded rows zero.  R_actual: (B,).
    size_lk: (B, Rmax+1) Poisson size prior tables.  Random draws come from
    ``generator`` (a torch.Generator on the device) unless ``draws`` gives
    them: ``init_gumbel`` (B, restarts, K, Rmax), and per step ``u_idx``,
    ``prop`` (ints in [0, K-1)) and ``u``, each (steps, B, restarts).  The
    chain runs a draw block of DRAW_BLOCK steps at a time
    (:func:`mcmc_chain`).  Returns numpy (best_assign (B, Rmax) int32,
    best_score (B,) f32)."""
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
    st = chain_start(X, w, size_lk, K, g0)
    for t0 in range(0, steps, DRAW_BLOCK):
        t1 = min(steps, t0 + DRAW_BLOCK)
        if draws is not None:
            U_idx = drawn("u_idx", t0, t1, torch.float32)
            PROP = drawn("prop", t0, t1, torch.int64)
            U = drawn("u", t0, t1, torch.float32)
        else:
            U_idx, PROP, U = generator_block(generator, (t1 - t0, B, S), K,
                                             dev)
        mcmc_chain(st, X, size_lk, *block_draws(U_idx, PROP, U, Ra, Rmax))
    best_lk = st["best_lk"]
    best_r = torch.argmax(best_lk, 1)
    out_assign = st["best_assign"][torch.arange(B, device=dev), best_r]
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
