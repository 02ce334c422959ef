"""The Metropolis chain of the port (``ops/cluster.py``): the objective's
fixed summation order, which the chain kernel (``csrc/mcmc_chain.cu``)
reproduces bit for bit, and the plain chain run a draw block at a time.

Tolerances: the fixed-order objective against a float64 evaluation of the
same terms within float32 rounding of a sum of n terms, (n + 1) * 2^-24
times the sum of their magnitudes; everything else bit-exact.
"""

import numpy as np
import pytest
import torch

from jtk_tpu_torch.ops import cluster as pcl
from test_cluster import _ari, _sim_gain_matrix
from torch_util import port_on_cpu  # noqa: F401


def _aggregates(rng, lanes, K, V, R=40):
    """Aggregates of random assignments of random reads: (lanes, K, V)
    gains, positive and negative counts, (lanes, K) sizes."""
    X = rng.normal(0.0, 1.0, (lanes, R, V)).astype(np.float32)
    X[rng.random(X.shape) < 0.1] = 0.0
    asg = rng.integers(0, K, (lanes, R))
    oh = np.eye(K, dtype=np.float32)[asg]                         # (l, R, K)
    g = np.einsum("lrk,lrv->lkv", oh, X)
    p = np.einsum("lrk,lrv->lkv", oh, (X > pcl.POS_THR).astype(np.float32))
    n = np.einsum("lrk,lrv->lkv", oh, (X < -pcl.POS_THR).astype(np.float32))
    return (torch.tensor(g), torch.tensor(p), torch.tensor(n),
            torch.tensor(oh.sum(1)))


def _used(g, p, n):
    """The used-column mask in float32, the objective's own expressions."""
    informative = (g > 0) & (p > pcl.POS_FRAC * (p + n + 1e-7))
    pos_in_use = torch.where(g > 0, p, 0.0).sum(-2)
    pos_in_neg = torch.where(g <= 0, p, 0.0).sum(-2)
    return informative.any(-2) & (pos_in_neg * pcl.IN_POS_RATIO < pos_in_use)


def _kernel_order(g, used, size_terms):
    """The chain kernel's sums, emulated in numpy float32 for one lane:
    column v on warp lane v % 32, group v // 32; the K clusters of a column
    in index order; the groups by the in-lane tree; the 32 lanes by
    __shfl_down_sync (a lane past 31 reads its own value); the size terms
    in index order."""
    K, V = g.shape
    M = pcl.chain_groups(V)
    f32 = np.float32
    col = np.zeros((M, 32), f32)
    for v in range(V):
        s = f32(max(g[0, v], f32(0)))
        for k in range(1, K):
            s = f32(s + f32(max(g[k, v], f32(0))))
        col[v // 32, v % 32] = s if used[v] else f32(0)
    h = M // 2
    while h >= 1:
        col[:h] = col[:h] + col[h:2 * h]
        h //= 2
    lanes = col[0].copy()
    for h in (16, 8, 4, 2, 1):
        lanes = np.array([lanes[i] + (lanes[i + h] if i + h < 32 else lanes[i])
                          for i in range(32)], f32)
    size = f32(size_terms[0])
    for k in range(1, K):
        size = f32(size + f32(size_terms[k]))
    return f32(lanes[0] + size)


@pytest.mark.parametrize("K,V", [(2, 6), (2, 24), (3, 24), (3, 40), (8, 6),
                                 (8, 40)])
def test_objective_fixed_order(K, V):
    """The objective's fixed-order float32 sums: the kernel's order
    emulated lane by lane gives the same bits, and a float64 evaluation
    of the same terms agrees within float32 rounding."""
    rng = np.random.default_rng(100 * K + V)
    lanes, R = 12, 40
    g, p, n, counts = _aggregates(rng, lanes, K, V, R)
    size_lk = torch.tensor(pcl.poisson_size_table(R, R / K, K))[None]
    got = pcl._objective(g, p, n, counts, size_lk.expand(lanes, -1))
    used = _used(g, p, n)
    for ln in range(lanes):
        terms = size_lk[0, counts[ln].long()].numpy()
        assert got[ln].numpy() == _kernel_order(g[ln].numpy(),
                                                used[ln].numpy(), terms)
        pos = np.where(used[ln].numpy()[None], np.maximum(g[ln].numpy(), 0),
                       0).astype(np.float64)
        want = pos.sum() + terms.astype(np.float64).sum()
        mag = np.abs(pos).sum() + np.abs(terms).sum()
        assert abs(float(got[ln]) - want) <= (K * V + K + 1) * 2.0**-24 * mag
    assert used.any()


def _step_by_step(X, R_actual, size_lk, K, steps, draws):
    """The chain computing idx and logu a step at a time from the draws,
    with the fixed-order objective: the plain loop before draw blocks."""
    B, Rmax, V = X.shape
    Ra = torch.as_tensor(R_actual)
    w = (torch.arange(Rmax)[None] < Ra[:, None]).to(X.dtype)
    st = pcl.chain_start(X, w, size_lk, K, torch.tensor(draws["init_gumbel"]))
    assign = st["assign"].to(torch.int64)
    agg_gain, agg_pos, agg_neg = st["agg_gain"], st["agg_pos"], st["agg_neg"]
    counts, lk = st["counts"], st["lk"]
    best_lk, best_assign = lk, assign
    Rf = Ra.to(torch.float32)[:, None]
    bidx = torch.arange(B)[:, None]
    sl = size_lk[:, None, :]
    for t in range(steps):
        idx = torch.floor(torch.tensor(draws["u_idx"][t]) * Rf) \
            .to(torch.int64).clamp(0, Rmax - 1)
        old = torch.gather(assign, 2, idx[..., None])[..., 0]
        prop = torch.tensor(draws["prop"][t])
        new = prop + (prop >= old).to(torch.int64)
        x_row = X[bidx, idx]
        p_row = (x_row > pcl.POS_THR).to(X.dtype)
        n_row = (x_row < -pcl.POS_THR).to(X.dtype)
        delta = (-torch.nn.functional.one_hot(old, K)
                 + torch.nn.functional.one_hot(new, K)).to(X.dtype)
        dl = delta[..., None]
        g_n = agg_gain + dl * x_row[..., None, :]
        p_n = agg_pos + dl * p_row[..., None, :]
        n_n = agg_neg + dl * n_row[..., None, :]
        c_n = counts + delta
        lk_new = pcl._objective(g_n, p_n, n_n, c_n, sl)
        logu = torch.log(torch.tensor(draws["u"][t]) + 1e-30)
        accept = (lk_new - lk) > logu
        assign = torch.where(accept[..., None],
                             assign.scatter(2, idx[..., None], new[..., None]),
                             assign)
        agg_gain = torch.where(accept[..., None, None], g_n, agg_gain)
        agg_pos = torch.where(accept[..., None, None], p_n, agg_pos)
        agg_neg = torch.where(accept[..., None, None], n_n, agg_neg)
        counts = torch.where(accept[..., None], c_n, counts)
        lk = torch.where(accept, lk_new, lk)
        better = lk > best_lk
        best_lk = torch.where(better, lk, best_lk)
        best_assign = torch.where(better[..., None], assign, best_assign)
    return dict(assign=assign, best_assign=best_assign, agg_gain=agg_gain,
                agg_pos=agg_pos, agg_neg=agg_neg, counts=counts, lk=lk,
                best_lk=best_lk)


@pytest.mark.parametrize("K", [2, 3])
def test_chain_in_draw_blocks_matches_step_by_step(K):
    """mcmc_chain_plain over draw blocks of DRAW_BLOCK steps (idx and logu
    computed for a whole block) ends in the same bits as the loop that
    computes them a step at a time, through two whole blocks and a part."""
    rng = np.random.default_rng(40 + K)
    B, Rmax, V, S = 2, 24, 8, 3
    steps = 2 * pcl.DRAW_BLOCK + 150
    X = np.stack([_sim_gain_matrix(rng, Rmax, V, K)[0] for _ in range(B)])
    Rs = np.array([Rmax, Rmax - 4], np.int32)
    X[1, Rs[1]:] = 0
    size_lk = np.stack([pcl.poisson_size_table(Rmax, Rmax / K, K)] * B)
    draws = dict(
        init_gumbel=rng.gumbel(size=(B, S, K, Rmax)).astype(np.float32),
        u_idx=rng.random((steps, B, S)).astype(np.float32),
        prop=rng.integers(0, K - 1, (steps, B, S)),
        u=rng.random((steps, B, S)).astype(np.float32))
    Xt, slt = torch.tensor(X), torch.tensor(size_lk)
    want = _step_by_step(Xt, Rs, slt, K, steps, draws)
    w = (torch.arange(Rmax)[None] < torch.tensor(Rs)[:, None]).float()
    st = pcl.chain_start(Xt, w, slt, K, torch.tensor(draws["init_gumbel"]))
    for t0 in range(0, steps, pcl.DRAW_BLOCK):
        t1 = min(steps, t0 + pcl.DRAW_BLOCK)
        pcl.mcmc_chain(st, Xt, slt, *pcl.block_draws(
            torch.tensor(draws["u_idx"][t0:t1]),
            torch.tensor(draws["prop"][t0:t1]),
            torch.tensor(draws["u"][t0:t1]), torch.tensor(Rs), Rmax))
    for name, v in want.items():
        assert torch.equal(st[name].to(v.dtype), v), name
    got_a, got_s = pcl.mcmc_cluster_batch(X, Rs, size_lk, K, steps, S,
                                          draws=draws)
    best_r = want["best_lk"].argmax(1)
    np.testing.assert_array_equal(
        got_a, want["best_assign"][torch.arange(B), best_r].numpy())
    np.testing.assert_array_equal(got_s, want["best_lk"].max(1).values)


@pytest.mark.parametrize("K", [3, 4])
def test_chain_in_draw_blocks_recovers_clusters(K):
    """With its own generator over several draw blocks, the chain still
    recovers planted clusters."""
    rng = np.random.default_rng(7 * K)
    B, Rmax, V = 2, 48, 12
    Xs, truths = zip(*[_sim_gain_matrix(rng, Rmax, V, K) for _ in range(B)])
    size_lk = np.stack([pcl.poisson_size_table(Rmax, Rmax / K, K)] * B)
    gen = torch.Generator().manual_seed(K)
    assign, score = pcl.mcmc_cluster_batch(
        np.stack(Xs), np.full(B, Rmax, np.int32), size_lk, K,
        2 * pcl.DRAW_BLOCK + 500, 4, generator=gen)
    for b in range(B):
        assert _ari(truths[b], assign[b]) > 0.8
    assert np.isfinite(score).all()


@pytest.mark.parametrize("V,M", [(1, 1), (8, 1), (32, 1), (33, 2), (64, 2),
                                 (65, 4), (256, 8)])
def test_chain_column_groups(V, M):
    """The kernel's column groups: V padded to a power of two, over 32
    lanes; its shared memory per chain."""
    assert pcl.chain_groups(V) == M
    assert pcl.chain_smem_bytes(2, V, 128) == 4 * (3 * 2 * 32 * M + 32 * M
                                                   + 2 + 128)


def _tree(col, width):
    """The __shfl_down_sync tree of the chain kernel over the first
    ``width`` lanes (a power of two; a lane past 31 reads its own value),
    in numpy float32: lane 0's sum."""
    lanes = col.copy()
    h = width // 2
    while h >= 1:
        lanes = np.array([lanes[i] + (lanes[i + h] if i + h < 32 else
                                      lanes[i]) for i in range(32)],
                         np.float32)
        h //= 2
    return lanes[0]


def _column_terms(g, used):
    """A column's term, lane by lane as the kernel forms it: the K
    clusters' positive gains in index order where the column is used, the
    literal +0 elsewhere (lanes from V on too)."""
    K, V = g.shape
    f32 = np.float32
    col = np.zeros(32, f32)
    for v in range(V):
        s = f32(max(g[0, v], f32(0)))
        for k in range(1, K):
            s = f32(s + f32(max(g[k, v], f32(0))))
        col[v] = s if used[v] else f32(0)
    return col


@pytest.mark.parametrize("K,V", [(2, 1), (2, 5), (2, 8), (4, 8), (2, 9),
                                 (3, 24)])
def test_objective_tree_levels_skip_zero_lanes(K, V):
    """The register form's shuffle tree runs 3 levels up to V 8 (5 above):
    the levels it skips add the +0 of lanes at and past V, and no column
    term is -0 (an unused column is the literal +0, a used one holds a
    positive gain), so the skipped levels change no bit, the sign of a
    zero included, here with gains of -0.0 planted in the aggregates."""
    rng = np.random.default_rng(300 + 10 * K + V)
    lanes, R = 16, 40
    g, p, n, counts = _aggregates(rng, lanes, K, V, R)
    g[rng.random(g.shape) < 0.3] = -0.0
    g[::3, :, ::2] = -0.0   # whole columns of -0.0 gains in some lanes
    size_lk = torch.tensor(pcl.poisson_size_table(R, R / K, K))[None]
    got = pcl._objective(g, p, n, counts, size_lk.expand(lanes, -1))
    used = _used(g, p, n)
    width = 8 if V <= 8 else 32
    for ln in range(lanes):
        col = _column_terms(g[ln].numpy(), used[ln].numpy())
        assert not np.signbit(col).any()
        short, full = _tree(col, width), _tree(col, 32)
        assert short.view(np.int32) == full.view(np.int32)
        terms = size_lk[0, counts[ln].long()].numpy()
        size = np.float32(terms[0])
        for k in range(1, K):
            size = np.float32(size + np.float32(terms[k]))
        want = np.float32(short + size)
        assert got[ln].numpy().view(np.int32) == want.view(np.int32)
    assert (g == 0).any() and (used.any() or V == 1)


def _register_form_block(st, X, size_lk, idx, prop, logu):
    """The register form of the chain kernel (csrc/mcmc_chain.cu,
    mcmc_chain_reg) emulated lane by lane in numpy float32 over one draw
    block, in its own order: the next step's X row and old cluster read a
    step ahead (the old cluster patched when a step accepts the same read),
    both moves of each cluster computed and one selected, the column terms
    by the shuffle tree over 8 lanes up to V 8 (32 above), the cluster
    sizes as integers.  Returns the state after the block (numpy) and the
    number of accepted steps."""
    f32 = np.float32
    X, size_lk = X.numpy(), size_lk.numpy()
    idx, prop, logu = idx.numpy(), prop.numpy(), logu.numpy()
    out = {k: v.numpy().copy() for k, v in st.items()}
    B, S, K, V = out["agg_gain"].shape
    R = out["assign"].shape[2]
    T = idx.shape[0]
    width = 8 if V <= 8 else 32
    accepted = 0
    for b in range(B):
        for s in range(S):
            g, p, n = (out[k][b, s].copy() for k in ("agg_gain", "agg_pos",
                                                      "agg_neg"))
            c = out["counts"][b, s].astype(np.int64)
            A = out["assign"][b, s].copy()
            best_a = out["best_assign"][b, s].copy()
            cur, best = f32(out["lk"][b, s]), f32(out["best_lk"][b, s])
            old = int(A[idx[0, b, s]])
            for t in range(T):
                i, pr = int(idx[t, b, s]), int(prop[t, b, s])
                lu = logu[t, b, s]
                i1 = int(idx[t + 1, b, s]) if t + 1 < T else 0
                old1 = int(A[i1])          # read a step ahead
                nw = pr + (pr >= old)
                x = X[b, i]
                px = (x > f32(pcl.POS_THR)).astype(f32)
                nx = (x < f32(-pcl.POS_THR)).astype(f32)
                gm, ga = g - x, g + x
                sel = np.arange(K)[:, None]
                gn = np.where(sel == old, gm, np.where(sel == nw, ga, g))
                pn = np.where(sel == old, p - px, np.where(sel == nw, p + px,
                                                           p))
                qn = np.where(sel == old, n - nx, np.where(sel == nw, n + nx,
                                                           n))
                informative = (gn > 0) & (pn > f32(pcl.POS_FRAC) * (
                    (pn + qn) + f32(1e-7)))
                piu = np.zeros(V, f32)
                pin = np.zeros(V, f32)
                for k in range(K):
                    piu = np.where(gn[k] > 0, f32(piu + pn[k]), piu)
                    pin = np.where(gn[k] > 0, pin, f32(pin + pn[k]))
                used = informative.any(0) & (f32(pin * f32(2)) < piu)
                gain = _tree(_column_terms(gn, used), width)
                cn = c + (np.arange(K) == nw) - (np.arange(K) == old)
                terms = size_lk[b, np.clip(cn, 0, R)]
                size = f32(terms[0])
                for k in range(1, K):
                    size = f32(size + terms[k])
                lk_new = f32(gain + size)
                accept = f32(lk_new - cur) > lu
                if accept:
                    accepted += 1
                    g, p, n, c = gn, pn, qn, cn
                    A[i] = nw
                    cur = lk_new
                    if cur > best:
                        best = cur
                        best_a = A.copy()
                old = nw if accept and i1 == i else old1
            out["agg_gain"][b, s], out["agg_pos"][b, s] = g, p
            out["agg_neg"][b, s], out["counts"][b, s] = n, c.astype(f32)
            out["assign"][b, s], out["best_assign"][b, s] = A, best_a
            out["lk"][b, s], out["best_lk"][b, s] = cur, best
    return out, accepted


@pytest.mark.parametrize("K,V", [(2, 8), (3, 5), (2, 20)])
def test_register_form_order_matches_plain_chain(K, V):
    """The register form's order (a numpy emulation of mcmc_chain_reg)
    gives the plain chain's bits over a draw block: the assignments, the
    best assignments, lk and best_lk bit for bit, the aggregates and sizes
    equal (the plain chain adds 0 * x to a cluster the move leaves, which
    can turn a -0 gain into +0; the kernel leaves it)."""
    rng = np.random.default_rng(60 + 10 * K + V)
    B, S, Rmax, T = 2, 3, 24, 300
    # weak clusters, so that the chain accepts moves
    X = np.stack([_sim_gain_matrix(rng, Rmax, V, K)[0] for _ in range(B)])
    X = (0.1 * X + rng.normal(0, 1, X.shape)).astype(np.float32)
    X[rng.random(X.shape) < 0.2] = 0.0
    Rs = np.array([Rmax, Rmax - 3], np.int64)
    X[1, Rs[1]:] = 0
    size_lk = np.stack([pcl.poisson_size_table(Rmax, Rmax / K, K)] * B)
    Xt, slt = torch.tensor(X), torch.tensor(size_lk)
    w = (torch.arange(Rmax)[None] < torch.tensor(Rs)[:, None]).float()
    gen = torch.Generator().manual_seed(K + V)
    st = pcl.chain_start(Xt, w, slt, K, pcl._gumbel((B, S, K, Rmax), gen,
                                                    "cpu"))
    draws = pcl.block_draws(*pcl.generator_block(gen, (T, B, S), K, "cpu"),
                            torch.tensor(Rs), Rmax)
    want, accepted = _register_form_block(st, Xt, slt, *draws)
    pcl.mcmc_chain_plain(st, Xt, slt, *draws)
    for name in ("assign", "best_assign", "lk", "best_lk"):
        got = st[name].numpy()
        assert got.tobytes() == want[name].astype(got.dtype).tobytes(), name
    for name in ("agg_gain", "agg_pos", "agg_neg", "counts"):
        np.testing.assert_array_equal(st[name].numpy(), want[name])
    assert accepted > 20
