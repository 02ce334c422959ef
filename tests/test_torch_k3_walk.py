"""The K3 traceback walk and the K3 kernel's row formulation, on the CPU.

- The port's plain walk (``traceback_packed_plain``, what
  ``traceback_packed`` runs on a CPU tensor) against the JAX package's
  device walk ``jtk_tpu/ops/pallas_k3.py::_traceback_packed``, bit-exact,
  on synthetic streams and on the streams of real alignments (ragged
  q_len with 0 and 1, infix and global mode, left runs at the band edges).
- The formulation ``csrc/edit_dp.cu`` computes a row with: one (value,
  index) prefix min of cand - k, ties to the larger index, giving both the
  new row and each LEFT cell's run start; unit-step columns kept as one
  column a pair.  Written here in plain PyTorch and held bit-exact against
  ``edit_dp_plain`` on hypothesis-drawn inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from jtk_tpu.ops import banded_align as jba
from jtk_tpu.ops.pallas_k3 import _traceback_packed
from jtk_tpu_torch.ops import edit_dp as k3
from torch_util import port_on_cpu  # noqa: F401

INF = k3.INF


def _walk_both(packed, off, q_len, end_j, W):
    got = k3.traceback_packed(torch.as_tensor(packed), torch.as_tensor(off),
                              torch.as_tensor(q_len), torch.as_tensor(end_j),
                              W)
    want = _traceback_packed(jnp.asarray(packed), jnp.asarray(off),
                             jnp.asarray(q_len), jnp.asarray(end_j), W)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _assert_walks_equal(got, want):
    (gd, go, gs), (wd, wo, ws) = got, want
    np.testing.assert_array_equal(gd, wd.astype(np.int32))
    np.testing.assert_array_equal(go, wo)
    np.testing.assert_array_equal(gs, ws.astype(np.int64))


@pytest.mark.parametrize("seed,W", [(0, 8), (1, 32), (2, 64), (3, 13)])
def test_walk_matches_jax_on_synthetic_streams(seed, W):
    """Arbitrary cells (any ptr, runs up to W, so walks that run off both
    band edges and clamp), unit-step offsets, q_len 0 and 1 among them."""
    rng = np.random.default_rng(seed)
    B, Q = 7, 40
    ptr = rng.integers(0, 3, (Q, B, W))
    run = np.where(ptr == 2, rng.integers(0, W, (Q, B, W)), 0)
    packed = (ptr | run << 2).astype(np.int16)
    steps = rng.integers(0, 2, (B, Q))
    off = np.concatenate([np.zeros((B, 1), np.int64),
                          np.cumsum(steps, 1)], 1) + rng.integers(0, 5, (B, 1))
    q_len = rng.integers(0, Q + 1, B).astype(np.int32)
    q_len[:2] = [0, 1]
    end_j = (off[np.arange(B), q_len] + rng.integers(-2, W + 2, B)) \
        .astype(np.int64)
    _assert_walks_equal(*_walk_both(packed, off, q_len, end_j, W))


def _real_batch(rng, mode, W, B=6, Q=90):
    """Noisy pairs whose refs carry an insertion of W/4 to W/2 (deletion
    runs across half the band), ragged q_len with 0 and 1."""
    q_len = rng.integers(Q // 2, Q + 1, B).astype(np.int32)
    q_len[:2] = [0, 1]
    qs = np.full((B, Q), 4, np.int8)
    T = Q + W + 40
    rs = np.full((B, T), 4, np.int8)
    t_len = np.zeros(B, np.int32)
    for b in range(B):
        q = rng.integers(0, 4, q_len[b]).astype(np.int8)
        qs[b, :q_len[b]] = q
        r = q.copy()
        m = rng.random(len(r)) < 0.08
        r[m] = (r[m] + 1) % 4
        cut = len(r) // 2
        gap = rng.integers(0, 4, int(rng.integers(W // 4, W // 2 - 2)))
        lead = rng.integers(0, 4, 5 if mode == "infix" else 2)
        r = np.concatenate([lead, r[:cut], gap, r[cut:]])[:T].astype(np.int8)
        rs[b, :len(r)] = r
        t_len[b] = len(r)
    if mode == "global":
        off = np.stack([jba.linear_offsets(int(q), int(t), Q, W)
                        for q, t in zip(q_len, t_len)])
    else:
        off = np.stack([jba.diagonal_offsets(int(q), 5, int(t), Q, W)
                        for q, t in zip(q_len, t_len)])
    return qs, rs, off.astype(np.int64), q_len, t_len


@pytest.mark.parametrize("mode", ["infix", "global"])
@pytest.mark.parametrize("W", [16, 48])
def test_walk_matches_jax_on_alignments(mode, W):
    rng = np.random.default_rng(7 + W + (mode == "global"))
    qs, rs, off, q_len, t_len = _real_batch(rng, mode, W)
    t = torch.as_tensor
    args = k3.k3_inputs(t(qs, dtype=torch.int32), t(rs, dtype=torch.int32),
                        t(off), t(t_len, dtype=torch.int64), W, mode)
    packed, last = k3.edit_dp(*args, t(q_len), t(t_len))
    _score, end_j = k3.select_end(last, t(off), t(q_len).long(),
                                  t(t_len).long(), W, mode)
    got, want = _walk_both(packed.numpy(), off, q_len, end_j.numpy(), W)
    _assert_walks_equal(got, want)
    # the walks cross the ref insertions, and pairs of q_len 0 take no step
    assert int(got[0].sum(1).max()) >= W // 4
    assert not got[0][0].any() and not got[1][0].any()


def _edit_dp_one_scan(e0, qs, shifts, inc, rc0, j0, qlen, tlen):
    """K3 as csrc/edit_dp.cu's warp form computes it: each pair stops at its
    q_len; one column a pair (lane k at j0[:, 0] + k); the new row and the
    run starts from one (value, index) prefix min of cand - k with ties to
    the larger index.  Returns the stream and the last row."""
    B, W = e0.shape
    Q = qs.shape[1]
    ks = torch.arange(W, dtype=torch.int64)
    S = 1 << 14   # key = value * S + (S - 1 - index): min value, max index
    e = e0.to(torch.int64)
    rc = rc0.to(torch.int64)
    jb = j0[:, :1].to(torch.int64)
    tl = tlen[:, None].to(torch.int64)
    out = torch.zeros((Q, B, W), dtype=torch.int16)
    for r in range(Q):
        live = (r < qlen)[:, None]
        sv = shifts[:, r:r + 1].to(torch.int64)
        qc = qs[:, r:r + 1].to(torch.int64)
        one = sv == 1
        e_next = torch.cat([e[:, 1:], torch.full((B, 1), INF)], 1)
        e_prev = torch.cat([torch.full((B, 1), INF), e[:, :-1]], 1)
        rc_next = torch.cat([rc[:, 1:], inc[:, r:r + 1].to(torch.int64)], 1)
        rcn = torch.where(one, rc_next, rc)
        ok = ks[None] <= torch.clamp(tl - jb - sv, max=W - 1)
        dok = ok & (ks[None] >= 1 - jb - sv)
        diag = torch.where(dok, torch.where(one, e, e_prev)
                           + (rcn != qc).to(torch.int64), INF)
        up = torch.where(ok, torch.where(one, e_next, e) + 1, INF)
        cand = torch.minimum(diag, up)
        key = torch.cummin((cand - ks) * S + (S - 1 - ks), dim=1).values
        pv = torch.div(key, S, rounding_mode="floor")
        pi = S - 1 - (key - pv * S)
        er = torch.where(ok, torch.minimum(cand, pv + ks), INF)
        cell = torch.where(er == cand, torch.where(cand == diag, 0, 1),
                           2 | (ks - pi) << 2)
        out[r] = torch.where(live, cell, 0).to(torch.int16)
        e = torch.where(live, er, e)
        rc = torch.where(live, rcn, rc)
        jb = torch.where(live, jb + sv, jb)
    return out, e.to(torch.int32)


@st.composite
def _dp_inputs(draw):
    B = draw(st.integers(1, 3))
    W = draw(st.integers(1, 40))
    Q = draw(st.integers(1, 6))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed)
    inf_share = draw(st.sampled_from([0.0, 0.3, 1.0]))
    e0 = np.where(rng.random((B, W)) < inf_share, INF,
                  rng.integers(0, 12, (B, W)))
    j0 = rng.integers(-3, 6, (B, 1)) + np.arange(W)[None]
    i32 = torch.int32
    return tuple(torch.as_tensor(x, dtype=i32) for x in (
        e0, rng.integers(0, 5, (B, Q)), rng.integers(0, 2, (B, Q)),
        rng.integers(0, 5, (B, Q)), rng.integers(0, 5, (B, W)), j0,
        rng.integers(0, Q + 1, B), rng.integers(0, W + 12, B)))


@settings(max_examples=150, deadline=None)
@given(_dp_inputs())
def test_one_scan_row_matches_edit_dp_plain(args):
    """The kernel's formulation gives edit_dp_plain's stream on each pair's
    rows below its q_len, and the same last row."""
    want, want_last = k3.edit_dp_plain(*args)
    got, got_last = _edit_dp_one_scan(*args)
    qlen = args[6]
    rows = torch.arange(want.shape[0])[:, None, None] < qlen[None, :, None]
    assert torch.equal(torch.where(rows, want, 0), got)
    assert torch.equal(want_last, got_last)
