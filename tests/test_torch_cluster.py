"""MCMC clustering in the port: with the JAX package's random draws fed in,
the port reaches identical assignments; with its own generator it still
recovers planted clusters."""

import jax
import numpy as np
import pytest

from jtk_tpu.ops import cluster as jcl
from jtk_tpu_torch.ops import cluster as pcl
from test_cluster import _ari, _sim_gain_matrix
from torch_util import port_on_cpu  # noqa: F401


def _jax_draws(key, B, restarts, K, Rmax, steps):
    """The draws jtk_tpu.ops.cluster.mcmc_cluster_batch takes from ``key``:
    k-means++ categorical picks as Gumbel noise, then per step u_idx, prop
    and u."""
    lane_keys = jax.random.split(key, B * restarts)
    g = np.zeros((B * restarts, K, Rmax), np.float32)
    for n in range(B * restarts):
        k0, kk = jax.random.split(lane_keys[n])
        g[n, 0] = jax.random.gumbel(k0, (Rmax,), np.float32)
        for j in range(1, K):
            kk, sub = jax.random.split(kk)
            g[n, j] = jax.random.gumbel(sub, (Rmax,), np.float32)
    u_idx = np.zeros((steps, B, restarts), np.float32)
    prop = np.zeros((steps, B, restarts), np.int64)
    u = np.zeros((steps, B, restarts), np.float32)
    for t in range(steps):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(key, t), 3)
        u_idx[t] = jax.random.uniform(k1, (B, restarts))
        prop[t] = jax.random.randint(k2, (B, restarts), 0, K - 1)
        u[t] = jax.random.uniform(k3, (B, restarts))
    return dict(init_gumbel=g.reshape(B, restarts, K, Rmax), u_idx=u_idx,
                prop=prop, u=u)


def _relabel(a, b):
    """b's labels mapped onto a's where the partitions agree, else None."""
    m = {}
    for x, y in zip(b, a):
        if m.setdefault(int(x), int(y)) != int(y):
            return None
    return np.array([m[int(x)] for x in b])


@pytest.mark.parametrize("K", [2, 3])
def test_mcmc_with_jax_draws_matches(K):
    """K = 2: identical assignments.  K = 3: restarts that reach the same
    partition under permuted labels score equal up to float32 rounding,
    and which of them wins follows the last bit of each engine's sums; the
    assignments are then identical up to that relabelling."""
    rng = np.random.default_rng(10 + K)
    B, Rmax, V, steps, restarts = 3, 24, 8, 400, 4
    Xs = [_sim_gain_matrix(rng, Rmax, V, K)[0] for _ in range(B)]
    X = np.stack(Xs)
    Rs = np.array([Rmax, Rmax - 5, Rmax - 2], np.int32)
    for b in range(B):
        X[b, Rs[b]:] = 0
    size_lk = np.stack([jcl.poisson_size_table(Rmax, Rmax / K, K)] * B)
    key = jax.random.PRNGKey(977 * K + 5)
    want_a, want_s = jcl.mcmc_cluster_batch(X, Rs, size_lk, key, K, steps,
                                            restarts)
    draws = _jax_draws(key, B, restarts, K, Rmax, steps)
    got_a, got_s = pcl.mcmc_cluster_batch(X, Rs, size_lk, K, steps, restarts,
                                          draws=draws)
    want_a = np.asarray(want_a)
    np.testing.assert_allclose(got_s, np.asarray(want_s), rtol=1e-6)
    if K == 2:
        np.testing.assert_array_equal(got_a, want_a)
    for b in range(B):
        same = _relabel(want_a[b, :Rs[b]], got_a[b, :Rs[b]])
        assert same is not None
        np.testing.assert_array_equal(same, want_a[b, :Rs[b]])


def test_mcmc_own_generator_recovers_two_clusters():
    import torch
    rng = np.random.default_rng(0)
    B, Rmax, V, K = 3, 40, 8, 2
    Xs, truths = zip(*[_sim_gain_matrix(rng, Rmax, V, K) for _ in range(B)])
    size_lk = np.stack([pcl.poisson_size_table(Rmax, Rmax / K, K)] * B)
    gen = torch.Generator().manual_seed(0)
    assign, score = pcl.mcmc_cluster_batch(
        np.stack(Xs), np.full(B, Rmax, np.int32), size_lk, K, 1500, 6,
        generator=gen)
    for b in range(B):
        assert _ari(truths[b], assign[b]) > 0.8
    assert score.min() > 0
