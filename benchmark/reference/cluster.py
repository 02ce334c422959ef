"""The clustering objective in plain NumPy float64, for the correctness
check: the score ``pseudo_mcmc.rs``'s chain maximises for an assignment of
reads to K clusters over their variant features.

A column counts where some cluster's summed gain is positive with more
than 70 % of its non-zero entries positive, and the positive entries in
clusters of positive gain outnumber twice those in the others; the score
is the sum of the positive cluster gains of those columns plus, for each
cluster, the best log-Poisson of its size over 1..K copies of the
coverage.  Imports nothing of the program under test.
"""

from __future__ import annotations

import math

import numpy as np

POS_THR = 1e-5
POS_FRAC = 0.70
IN_POS_RATIO = 2.0


def size_table(n: int, coverage: float, K: int) -> np.ndarray:
    """size_lk[x] = max over 1 <= c <= K of log Poisson(x | c * coverage),
    x = 0..n."""
    xs = np.arange(n + 1, dtype=np.float64)
    lgam = np.array([math.lgamma(x + 1) for x in xs])
    best = np.full(n + 1, -np.inf)
    for c in range(1, max(K, 1) + 1):
        lam = max(coverage * c, 1e-3)
        best = np.maximum(best, xs * math.log(lam) - lam - lgam)
    return best


def objective(X, assign, coverage: float, K: int, dtype=None) -> float:
    """The score of ``assign`` (R,) over ``X`` (R, V), in float64, or in
    the torch type ``dtype`` (the control) throughout."""
    X = np.asarray(X, np.float64)
    assign = np.asarray(assign, np.int64)
    oh = np.zeros((len(assign), K))
    oh[np.arange(len(assign)), assign] = 1.0
    size = size_table(len(assign), coverage, K)[oh.sum(0).astype(np.int64)]
    if dtype is not None:
        import torch
        t = lambda a: torch.as_tensor(a).to(dtype)  # noqa: E731
        Xt, oht = t(X), t(oh)
        gain = oht.T @ Xt
        pos = oht.T @ (Xt > POS_THR).to(dtype)
        neg = oht.T @ (Xt < -POS_THR).to(dtype)
        informative = (gain > 0) & (pos > POS_FRAC * (pos + neg + 1e-7))
        in_use = torch.where(gain > 0, pos, 0).sum(0)
        in_neg = torch.where(gain <= 0, pos, 0).sum(0)
        used = informative.any(0) & (in_neg * IN_POS_RATIO < in_use)
        col = torch.where(used[None], gain.clamp(min=0), 0).sum()
        return float(col + t(size).sum())
    gain = oh.T @ X
    pos = oh.T @ (X > POS_THR)
    neg = oh.T @ (X < -POS_THR)
    informative = (gain > 0) & (pos > POS_FRAC * (pos + neg + 1e-7))
    in_use = np.where(gain > 0, pos, 0).sum(0)
    in_neg = np.where(gain <= 0, pos, 0).sum(0)
    used = informative.any(0) & (in_neg * IN_POS_RATIO < in_use)
    col = np.where(used[None], np.clip(gain, 0, None), 0).sum()
    return float(col + size.sum())
