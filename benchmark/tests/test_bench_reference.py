"""The plain reference against scalar definitions."""

import math

import numpy as np
import pytest
import torch

from reference import cluster as rcl
from reference import edit as red
from reference import phmm as rph

HMM = {"mat_mat": 0.97, "mat_ins": 0.01, "mat_del": 0.01, "ins_mat": 0.97,
       "ins_ins": 0.01, "ins_del": 0.01, "del_mat": 0.97, "del_ins": 0.01,
       "del_del": 0.01,
       "mat_emit": [0.97 if a == b else 0.01 for a in range(4)
                    for b in range(4)],
       "ins_emit": [0.25] * 20}


def _lse(*xs):
    xs = [x for x in xs if x > -math.inf]
    if not xs:
        return -math.inf
    m = max(xs)
    return m + math.log(sum(math.exp(x - m) for x in xs))


def _forward(q, t, p):
    """The pair HMM's forward, cell by cell in log space."""
    lg = math.log
    me = np.array(p["mat_emit"]).reshape(4, 4)
    ie = np.array(p["ins_emit"]).reshape(5, 4)
    Q, T = len(q), len(t)
    M = np.full((Q + 1, T + 1), -np.inf)
    I, D = M.copy(), M.copy()
    M[0, 0] = 0.0
    for i in range(Q + 1):
        for j in range(T + 1):
            if i and j:
                M[i, j] = lg(me[t[j - 1], q[i - 1]]) + _lse(
                    lg(p["mat_mat"]) + M[i - 1, j - 1],
                    lg(p["ins_mat"]) + I[i - 1, j - 1],
                    lg(p["del_mat"]) + D[i - 1, j - 1])
            if i:
                ctx = q[i - 2] if i >= 2 else 4
                I[i, j] = lg(ie[ctx, q[i - 1]]) + _lse(
                    lg(p["mat_ins"]) + M[i - 1, j],
                    lg(p["ins_ins"]) + I[i - 1, j],
                    lg(p["del_ins"]) + D[i - 1, j])
            if j:
                D[i, j] = _lse(lg(p["mat_del"]) + M[i, j - 1],
                               lg(p["ins_del"]) + I[i, j - 1],
                               lg(p["del_del"]) + D[i, j - 1])
    return _lse(M[Q, T], I[Q, T], D[Q, T])


def test_forward_matches_the_cell_by_cell_definition():
    rng = np.random.default_rng(3)
    t = rng.integers(0, 4, 30).astype(np.int8)
    qs = [np.concatenate([t[:8], t[10:20], [2], t[20:]]).astype(np.int8),
          t.copy(), t[4:]]
    ts = [t, rph.apply_edit(t, 1, 5), rph.apply_edit(t, 12, 9)]
    got = rph.forward_lk(qs, ts, [True, False, True], [HMM, HMM], "cpu")
    want = [_forward(q, tt, HMM) for q, tt in zip(qs, ts)]
    np.testing.assert_allclose(got, want, rtol=1e-12)
    low = rph.forward_lk(qs, ts, [True] * 3, [HMM, HMM], "cpu",
                         dtype=torch.bfloat16)
    assert np.abs(low - np.array(want)).max() > 0.01


def test_edits_follow_the_table_columns():
    t = np.array([0, 1, 2, 3, 0], np.int8)
    assert rph.apply_edit(t, 2, 1).tolist() == [0, 2, 2, 3, 0]
    assert rph.apply_edit(t, 7, 1).tolist() == [0, 3, 1, 2, 3, 0]
    assert rph.apply_edit(t, 9, 1).tolist() == [0, 1, 2, 1, 2, 3, 0]
    assert rph.apply_edit(t, 12, 1).tolist() == [0, 3, 0]


def _edit(q, t):
    D = np.arange(len(t) + 1)
    for i in range(1, len(q) + 1):
        new = np.empty_like(D)
        new[0] = i
        for j in range(1, len(t) + 1):
            new[j] = min(D[j - 1] + (q[i - 1] != t[j - 1]), D[j] + 1,
                         new[j - 1] + 1)
        D = new
    return int(D[-1])


def test_edit_distance_and_cigar_cost():
    rng = np.random.default_rng(4)
    qs = [rng.integers(0, 4, n).astype(np.int8) for n in (40, 55, 1)]
    ts = [rng.integers(0, 4, n).astype(np.int8) for n in (50, 45, 9)]
    d, rows = red.edit_distance(qs, ts, "cpu", keep_rows=True)
    assert d.tolist() == [_edit(q, t) for q, t in zip(qs, ts)]
    for b, (q, t) in enumerate(zip(qs, ts)):
        assert red.cigar_cost(red.traceback(rows, b, q, t), q, t) == d[b]
    assert red.cigar_cost([("M", 3)], qs[0][:3], ts[0][:2]) == red.BIG
    # cells held in int8 wrap: the walk's CIGAR costs more
    long_q = rng.integers(0, 4, 300).astype(np.int8)
    long_t = rng.integers(0, 4, 300).astype(np.int8)
    best = red.edit_distance([long_q], [long_t], "cpu")
    _q, _t, _b, cg = red.control_cigars([long_q], [long_t], best, 1,
                                        torch.int8, "cpu")
    assert red.cigar_cost(cg[0], long_q, long_t) > best[0]


def test_objective_counts_used_columns_and_sizes():
    X = np.array([[2.0, -1.0], [1.5, -1.0], [-1.0, 3.0], [-1.0, 2.0]])
    got = rcl.objective(X, np.array([0, 0, 1, 1]), 2.0, 2)
    size = rcl.size_table(4, 2.0, 2)
    assert got == pytest.approx(3.5 + 5.0 + 2 * size[2])
    assert rcl.size_table(4, 2.0, 1)[2] == pytest.approx(
        2 * math.log(2.0) - 2.0 - math.log(2))
    low = rcl.objective(X * 1.001, np.array([0, 0, 1, 1]), 2.0, 2,
                        dtype=torch.bfloat16)
    assert low == pytest.approx(got, rel=1e-2)
