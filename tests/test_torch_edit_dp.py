"""K3 in the port (ops/edit_dp.py, ops/banded_align.py) against the JAX
package: bit-exact packed results and CIGARs, and against the O(QT) oracle."""

import numpy as np
import pytest
import torch

from jtk_tpu.ops import banded_align as jba
from jtk_tpu.ops import oracle
from jtk_tpu_torch.ops import banded_align as pba
from jtk_tpu_torch.ops import edit_dp as k3
from test_pallas_k3 import _mk_batch
from torch_util import port_on_cpu  # noqa: F401


def _hostwin_batch(seed):
    rng = np.random.default_rng(seed)
    return _mk_batch(rng)


@pytest.mark.parametrize("seed", [2, 5])
def test_extend_hostwin_bit_exact(seed):
    (blob, clens, cand, rs, ws, astart, t_lens,
     W, Qpad, Tpad, margin) = _hostwin_batch(seed)
    want = jba._extend_hostwin(blob, clens, cand, jba.pack2bit(rs), ws,
                               astart, t_lens, W, Qpad, Tpad, margin)
    want = [np.asarray(x) for x in want]
    got = k3.extend_hostwin(blob, clens, cand, rs, ws, astart, t_lens, W,
                            Qpad, Tpad, margin)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(g, w)
    q_lens = [int(clens[c]) for c in cand]
    assert pba.decode_indexed(*got, q_lens) == \
        jba.decode_indexed(*want, q_lens)


def _pairs(rng, B=6, Q=200, lead=20, tail=15, err=0.08):
    qs = rng.integers(0, 4, (B, Q)).astype(np.int8)
    T = Q + lead + tail + 20
    rs = np.full((B, T), 4, np.int8)
    ql = np.full(B, Q, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        s = qs[b].copy()
        m = rng.random(Q) < err
        s[m] = (s[m] + 1) % 4
        keep = rng.random(Q) > err / 3
        s = np.concatenate([rng.integers(0, 4, lead), s[keep],
                            rng.integers(0, 4, tail)]).astype(np.int8)
        rs[b, :len(s)] = s
        tl[b] = len(s)
    return qs, rs, ql, tl


def _cigar_cost(q, r, cigar, start):
    i, j, cost = 0, start, 0
    for kind, n in cigar:
        for _ in range(n):
            if kind == "M":
                cost += int(q[i] != r[j])
                i += 1
                j += 1
            elif kind == "I":
                cost += 1
                i += 1
            else:
                cost += 1
                j += 1
    return cost, i, j


@pytest.mark.parametrize("mode", ["global", "infix"])
def test_align_with_cigar_batch_matches_jax_and_oracle(mode):
    rng = np.random.default_rng(11 if mode == "global" else 12)
    qs, rs, ql, tl = _pairs(rng)
    Q = qs.shape[1]
    if mode == "global":
        W = 128
        offs = np.stack([jba.linear_offsets(Q, int(t), Q, W) for t in tl])
    else:
        W = 64
        offs = np.stack([jba.diagonal_offsets(Q, 20, int(t), Q, W)
                         for t in tl])
    want = jba.align_with_cigar_batch(qs, rs, offs, ql, tl, W, mode)
    got = pba.align_with_cigar_batch(qs, rs, offs, ql, tl, W, mode)
    for key in ("score", "end_j", "start_j"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["cigar"] == want["cigar"]
    for b in range(len(qs)):
        r = rs[b, :tl[b]]
        score, _ops, _rs, re_ = oracle.edit_dp(qs[b], r, mode)
        assert int(got["score"][b]) == score
        if mode == "global":
            assert int(got["end_j"][b]) == re_
        cost, i_end, j_end = _cigar_cost(qs[b], r, got["cigar"][b],
                                         int(got["start_j"][b]))
        assert (cost, i_end, j_end) == (score, Q, int(got["end_j"][b]))


@pytest.mark.parametrize("mode", ["global", "infix"])
def test_banded_align_batch_and_edit_align(mode):
    rng = np.random.default_rng(21)
    qs, rs, ql, tl = _pairs(rng, B=4, Q=160)
    Q = qs.shape[1]
    W = 96
    offs = np.stack([jba.linear_offsets(Q, int(t), Q, W) if mode == "global"
                     else jba.diagonal_offsets(Q, 20, int(t), Q, W)
                     for t in tl])
    want = jba.banded_align_batch(qs, rs, offs, ql, tl, W, mode)
    got = pba.banded_align_batch(qs, rs, offs, ql, tl, W, mode)
    for key in ("score", "end_j", "ptrs"):
        np.testing.assert_array_equal(got[key], want[key])
    q, r = qs[0], rs[0, :tl[0]]
    assert pba.edit_align(q, r, W=W, mode=mode, diag=20) == \
        jba.edit_align(q, r, W=W, mode=mode, diag=20)


def test_stable_topk_keeps_lower_index_among_ties():
    dels = torch.tensor([[0, 3, 0, 3, 1, 0]], dtype=torch.int32)
    ops = torch.zeros((1, 6), dtype=torch.uint8)
    z = torch.zeros(1, dtype=torch.int64)
    _meta, _bits, delpack = k3.pack_results(z, z, z, dels, ops)
    k = delpack.shape[1] // 2
    assert delpack[0, :k].tolist() == [3, 3, 1, 0, 0, 0]
    assert delpack[0, k:].tolist() == [1, 3, 4, 0, 2, 5]
