"""The port against the JAX package at a band wider than 1024, where K1l,
the counts kernel and K3 now launch on the card, and past the old limits
(the K1 family's 4096, K3's 8192), where the kernels have no limit left:
the plain versions (which the kernels are held to there) against
``jtk_tpu`` on the CPU.

Tolerances: lk atol 2e-2 (tests/test_pallas_phmm.py's), gradients rtol
1e-3 / atol 1e-4 per bp (tests/test_torch_model_tune.py's), K3 bit-exact.
"""

import numpy as np
import pytest
import torch

from jtk_tpu import parallel as jpar
from jtk_tpu.datamodel import HMMParam
from jtk_tpu.io import sim
from jtk_tpu.ops import banded_align as jba
from jtk_tpu.ops import oracle
from jtk_tpu.ops import phmm as jphmm
from jtk_tpu.ops.polish import effective_band
from jtk_tpu_torch.ops import banded_align as pba
from jtk_tpu_torch.ops import phmm as pphmm
from test_torch_edit_dp import _cigar_cost, _pairs
from test_torch_model_tune import (_batch, _full_length_batch, _jax_grad,
                                   _jparams, _port_grad)
from torch_util import port_on_cpu  # noqa: F401


def test_lk_matches_jax_at_band_1152():
    """A pileup with one read ~1 kb shorter than its template widens the
    band to 1152 (``effective_band``); the port's likelihood_pileup (K1l's
    plain version on the CPU) against the scan engine."""
    rng = np.random.default_rng(11)
    jp = jphmm.PHMMParams.from_hmmparam(HMMParam())
    pp = pphmm.params_from_numpy(np.asarray(jp.trans),
                                 np.asarray(jp.mat_emit),
                                 np.asarray(jp.ins_emit), "cpu")
    tlen = 1100
    template = sim.random_genome(rng, tlen)
    reads = [sim.noisy_read(rng, template, 0.08) for _ in range(3)]
    start = int(rng.integers(0, tlen - 100))
    reads.append(sim.noisy_read(rng, template[start:start + 100], 0.08))
    q_lens = np.array([len(r) for r in reads], np.int32)
    W = effective_band(64, q_lens, tlen)
    assert W == 1152
    Qpad = ((int(q_lens.max()) + 127) // 128) * 128
    qs = np.full((len(reads), Qpad), 4, np.int8)
    for i, r in enumerate(reads):
        qs[i, :len(r)] = r
    qs[1, 40] = 4   # an N inside a read emits with probability 0
    offs = np.stack([jba.linear_offsets(int(n), tlen, Qpad, W)
                     for n in q_lens])
    want = np.asarray(jphmm.likelihood_pileup(
        qs, template, offs, q_lens, np.int32(tlen), jp, W))
    got = pphmm.likelihood_pileup(qs, template, offs, q_lens, tlen, pp, W)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-2)
    assert got[1] < got[0] - 1000


def test_gradient_matches_jax_grad_at_band_1152():
    """PairHMMLikelihood's gradient (K1l forward; K1 tables and the plain
    counts backward) against jax.grad at W 1152, on reads of the full
    padded length, where the reference's gradient is defined."""
    rng = np.random.default_rng(7)
    template, reads = _full_length_batch(rng, n=3, L=1280)
    qs, offs, q_lens, W = _batch(template, reads, W=1152)
    assert W == 1152 and qs.shape[1] == 1280
    bp = float(q_lens.sum())
    want = _jax_grad(jpar.params_to_theta(_jparams()), template, qs, offs,
                     q_lens, W)
    got = _port_grad(template, qs, offs, q_lens, W)
    for g, w in zip(got, want):
        assert np.all(np.isfinite(w))
        np.testing.assert_allclose(g / bp, w / bp, rtol=1e-3, atol=1e-4)


def test_k3_matches_jax_at_band_1152():
    """K3's plain version (the port's alignments on the CPU) bit-exact
    against the JAX package's K3 at W 1152, global and infix."""
    rng = np.random.default_rng(13)
    qs, rs, ql, tl = _pairs(rng, B=3, Q=1400, lead=150, tail=120)
    Q, W = qs.shape[1], 1152
    for mode in ("global", "infix"):
        if mode == "global":
            offs = np.stack([jba.linear_offsets(Q, int(t), Q, W) for t in tl])
        else:
            offs = np.stack([jba.diagonal_offsets(Q, 150, int(t), Q, W)
                             for t in tl])
        assert (offs[:, -1] > offs[:, 0]).all()   # the band moves
        want = jba.align_with_cigar_batch(qs, rs, offs, ql, tl, W, mode)
        got = pba.align_with_cigar_batch(qs, rs, offs, ql, tl, W, mode)
        for key in ("score", "end_j", "start_j"):
            np.testing.assert_array_equal(got[key], want[key])
        assert got["cigar"] == want["cigar"]


def _short_read_pileup(rng, tlen, n_reads=2, qlen=200, err=0.08):
    """Reads of ~``qlen`` bases from the two ends of a ``tlen`` template,
    padded to a multiple of 64, with their linear offsets at the band
    ``effective_band`` gives such a pileup (a short read against a long
    template widens the band past the K1 family's old limit of 4096)."""
    template = sim.random_genome(rng, tlen)
    reads = [sim.noisy_read(rng, template[s:s + qlen], err)
             for s in ((0, tlen - qlen) * n_reads)[:n_reads]]
    q_lens = np.array([len(r) for r in reads], np.int32)
    W = effective_band(64, q_lens, tlen)
    Qpad = ((int(q_lens.max()) + 63) // 64) * 64
    qs = np.full((len(reads), Qpad), 4, np.int8)
    for i, r in enumerate(reads):
        qs[i, :len(r)] = r
    offs = np.stack([jba.linear_offsets(int(n), tlen, Qpad, W)
                     for n in q_lens])
    return template, qs, offs, q_lens, W


def test_k1_tables_and_lk_match_jax_at_band_4224():
    """Past the K1 family's old limit: a pileup of two ~200-base reads
    against a 4.3 kb template takes W 4224, where the kernels run their
    scratch form.  The port's tables and likelihoods (the plain versions on
    the CPU) against the scan engine, at tests/test_pallas_phmm.py's
    tolerances: tables rtol 2e-3 / atol 1e-5, cumulative log scales rtol
    1e-4 / atol 2e-2, lk atol 2e-2."""
    from jtk_tpu_torch.ops import phmm_tables as pt

    rng = np.random.default_rng(17)
    jp = jphmm.PHMMParams.from_hmmparam(HMMParam())
    pp = pphmm.params_from_numpy(np.asarray(jp.trans),
                                 np.asarray(jp.mat_emit),
                                 np.asarray(jp.ins_emit), "cpu")
    tlen = 4300
    template, qs, offs, q_lens, W = _short_read_pileup(rng, tlen)
    assert W == 4224 and W > pt.SHARED_FORM_W
    want = np.asarray(jphmm.likelihood_pileup(
        qs, template, offs, q_lens, np.int32(tlen), jp, W))
    got = pphmm.likelihood_pileup(qs, template, offs, q_lens, tlen, pp, W)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-2)
    lk, (fM, fI, fD), fcum, rcs, (bM, bI, bD), bcum = pt.tables_from_arrays(
        qs, template, offs, q_lens, tlen, pp, W)
    tpl = np.asarray(template, np.int8)
    for i in range(len(qs)):
        lk_w, (fMw, fIw, fDw), fcum_w, rcs_w = jphmm.forward_banded(
            qs[i], tpl, offs[i], np.int32(q_lens[i]), np.int32(tlen), jp, W)
        (bMw, bIw, bDw), bcum_w = jphmm.backward_banded(
            qs[i], tpl, offs[i], np.int32(q_lens[i]), np.int32(tlen), jp, W)
        assert abs(float(lk[i]) - float(lk_w)) < 2e-2
        for g, w in ((fM, fMw), (fI, fIw), (fD, fDw), (bM, bMw), (bI, bIw),
                     (bD, bDw)):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w),
                                       rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(fcum[i].numpy(), np.asarray(fcum_w),
                                   rtol=1e-4, atol=2e-2)
        np.testing.assert_allclose(bcum[i].numpy(), np.asarray(bcum_w),
                                   rtol=1e-4, atol=2e-2)
        np.testing.assert_array_equal(rcs[i].numpy(), np.asarray(rcs_w))


@pytest.mark.parametrize("mode", ["global", "infix"])
def test_k3_and_walk_match_jax_at_band_8320(mode):
    """K3 and its walk past their old limit of 8192 (int32 cells in the
    port; the reference's int16 cells are right while no left run reaches
    8192, as here): the port's plain versions bit-exact against the JAX
    package's K3 at W 8320, global and infix."""
    from jtk_tpu_torch.ops import edit_dp as k3

    rng = np.random.default_rng(23 if mode == "global" else 24)
    qs, rs, ql, tl = _pairs(rng, B=2, Q=300, lead=40, tail=30)
    Q, W = qs.shape[1], 8320
    assert k3.cell_dtype(W) == torch.int32
    if mode == "global":
        offs = np.stack([jba.linear_offsets(Q, int(t), Q, W) for t in tl])
    else:
        offs = np.stack([jba.diagonal_offsets(Q, 40, int(t), Q, W)
                         for t in tl])
    want = jba.align_with_cigar_batch(qs, rs, offs, ql, tl, W, mode)
    got = pba.align_with_cigar_batch(qs, rs, offs, ql, tl, W, mode)
    for key in ("score", "end_j", "start_j"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["cigar"] == want["cigar"]


def test_k3_walk_keeps_a_left_run_past_8192():
    """Port only: a query against a reference with an 8.3 kb insertion
    (global, W 8448) has a left run of 8300 lanes, which an int16 cell
    (ptr | run << 2) cannot hold.  The query is of A and C, the insertion
    of G and T, so no diagonal ties into the run and breaks it.  The plain
    DP writes int32 cells holding it, the plain walk
    (traceback_packed_plain) turns it into one deletion run, and the
    alignment's cost is the O(QT) oracle's edit distance."""
    from jtk_tpu_torch.ops import edit_dp as k3

    rng = np.random.default_rng(29)
    Q, ins = 150, 8300
    q = rng.integers(0, 2, Q).astype(np.int8)
    r = np.concatenate([q[:75], rng.integers(2, 4, ins).astype(np.int8),
                        q[75:]])
    T, W = len(r), 8448
    off = jba.linear_offsets(Q, T, Q, W)
    qt = torch.as_tensor(q[None], dtype=torch.int32)
    rt = torch.as_tensor(r[None], dtype=torch.int32)
    offt = torch.as_tensor(off[None], dtype=torch.int64)
    ql = torch.tensor([Q], dtype=torch.int32)
    tl = torch.tensor([T], dtype=torch.int32)
    args = k3.k3_inputs(qt, rt, offt, tl.long(), W, "global")
    packed, last = k3.edit_dp(*args, ql, tl)
    assert packed.dtype == torch.int32
    assert int((packed >> 2).max()) >= 8192
    score, end = k3.select_end(last, offt, ql.long(), tl.long(), W, "global")
    dels, ops, start = k3.traceback_packed_plain(packed, offt, ql, end, W)
    assert int(dels.max()) >= 8192
    want, _ops, _rs, _re = oracle.edit_dp(q, r, "global")
    assert int(score[0]) == want
    got = pba.align_with_cigar_batch(q[None], r[None], off[None],
                                     np.array([Q]), np.array([T]), W,
                                     "global")
    cost, i_end, j_end = _cigar_cost(q, r, got["cigar"][0],
                                     int(got["start_j"][0]))
    assert (cost, i_end, j_end) == (want, Q, T)
    assert max(n for kind, n in got["cigar"][0] if kind == "D") >= 8192
