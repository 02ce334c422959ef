"""K1 tables and the K2 modification table in the port against the JAX
package, at tests/test_pallas_phmm.py's sizes and tolerances: tables
rtol 2e-3 / atol 1e-5, cumulative log scales rtol 1e-4 / atol 2e-2,
log-likelihoods atol 2e-2, edit tables atol 5e-2 (float32 sums in another
order than the reference's)."""

import numpy as np
import pytest
import torch

from jtk_tpu.datamodel import HMMParam
from jtk_tpu.ops import phmm as jphmm
from jtk_tpu.ops.pallas_phmm import pallas_tables_batch
from jtk_tpu_torch.ops import modtable as pmod
from jtk_tpu_torch.ops import phmm as pphmm
from jtk_tpu_torch.ops import phmm_tables as pt
from test_pallas_phmm import _prep_batch
from torch_util import port_on_cpu  # noqa: F401


def _params():
    jp = jphmm.PHMMParams.from_hmmparam(HMMParam())
    pp = pphmm.params_from_numpy(np.asarray(jp.trans), np.asarray(jp.mat_emit),
                                 np.asarray(jp.ins_emit), "cpu")
    return jp, pp


def _rev_params(jp):
    t2 = np.asarray(jp.trans).copy()
    t2[0] = [0.80, 0.15, 0.05]
    t2[1] = [0.55, 0.35, 0.10]
    me2 = (np.asarray(jp.mat_emit) * 0.7 + 0.3 * 0.25).astype(np.float32)
    ie2 = (np.asarray(jp.ins_emit) * 0.5 + 0.5 * 0.25).astype(np.float32)
    return (jphmm.PHMMParams(t2, me2, ie2),
            pphmm.params_from_numpy(t2, me2, ie2, "cpu"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_tables_match_scan_and_pallas():
    rng = np.random.default_rng(3)
    jp, pp = _params()
    template, qs, offs, q_lens, W = _prep_batch(rng)
    tlen = len(template)
    Qpad = qs.shape[1]
    lk, (fM, fI, fD), fcum, rcs, (bM, bI, bD), bcum = pt.tables_from_arrays(
        qs, template, offs, q_lens, tlen, pp, W)
    pal = pallas_tables_batch(qs, template, offs, q_lens, tlen, jp, W,
                              interpret=True)
    tpl = np.asarray(template, np.int8)
    for i in range(len(qs)):
        lk_w, (fMw, fIw, fDw), fcum_w, rcs_w = jphmm.forward_banded(
            qs[i], tpl, offs[i], np.int32(q_lens[i]), np.int32(tlen), jp, W)
        (bMw, bIw, bDw), bcum_w = jphmm.backward_banded(
            qs[i], tpl, offs[i], np.int32(q_lens[i]), np.int32(tlen), jp, W)
        assert abs(float(lk[i]) - float(lk_w)) < 2e-2
        assert abs(float(lk[i]) - float(pal[0][i])) < 2e-2
        for got, want, pal_t in ((fM, fMw, pal[1][0]), (fI, fIw, pal[1][1]),
                                 (fD, fDw, pal[1][2]), (bM, bMw, pal[4][0]),
                                 (bI, bIw, pal[4][1]), (bD, bDw, pal[4][2])):
            g = _np(got)[i]
            np.testing.assert_allclose(g, _np(want), rtol=2e-3, atol=1e-5)
            np.testing.assert_allclose(g, _np(pal_t)[i, :Qpad + 1],
                                       rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(_np(fcum)[i], _np(fcum_w), rtol=1e-4,
                                   atol=2e-2)
        np.testing.assert_allclose(_np(bcum)[i], _np(bcum_w), rtol=1e-4,
                                   atol=2e-2)
        np.testing.assert_array_equal(_np(rcs)[i], _np(rcs_w))


def test_params_from_numpy_carries_the_weights():
    """The JAX package's PHMMParams, as numpy, give the same
    log-likelihoods in the port."""
    rng = np.random.default_rng(5)
    jp, pp = _params()
    template, qs, offs, q_lens, W = _prep_batch(rng, n_reads=6)
    tpl = np.broadcast_to(np.asarray(template, np.int8), (len(qs), len(template)))
    t_lens = np.full(len(qs), len(template), np.int32)
    want = np.asarray(jphmm.likelihood_pairs(qs, tpl, offs, q_lens, t_lens,
                                             jp, W))
    got = pphmm.likelihood_pairs(qs, tpl, offs, q_lens, t_lens, pp, W)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-2)
    hp = pphmm.PHMMParams.from_hmmparam(HMMParam())
    for a, b in zip(hp, pp):
        assert torch.equal(a, b)


def test_hmm_generate_matches_jax_stream():
    jp, pp = _params()
    tpl = np.random.default_rng(9).integers(0, 4, 120).astype(np.int8)
    for seed in range(20):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        a = jphmm.hmm_generate(r1, tpl, jp)
        b = pphmm.hmm_generate(r2, tpl, pp)
        np.testing.assert_array_equal(a, b)
        assert r1.random() == r2.random()


def test_modtable_strand_params_match_jax():
    from jtk_tpu.ops.modtable import (modification_table_pileup,
                                      modification_table_pileup_pallas)
    rng = np.random.default_rng(7)
    jp, pp = _params()
    jrev, prev = _rev_params(jp)
    template, qs, offs, q_lens, W = _prep_batch(rng, n_reads=6)
    tlen = len(template)
    tpl = np.asarray(template, np.int8)
    strands = np.array([True, False, True, False, False, True])
    lk_p, tab_p = pmod.modification_table_pileup_pallas(
        qs, tpl, offs, q_lens, np.int32(tlen), pp, W, tlen,
        strands=strands, params_rev=prev)
    lk_j, tab_j = modification_table_pileup_pallas(
        qs, tpl, offs, q_lens, np.int32(tlen), jp, W, tlen,
        interpret=True, strands=strands, params_rev=jrev)
    np.testing.assert_allclose(lk_p, np.asarray(lk_j), rtol=1e-4, atol=2e-2)
    tj = np.asarray(tab_j)
    mask = tj > -1e29
    np.testing.assert_array_equal(tab_p > -1e29, mask)
    np.testing.assert_allclose(tab_p[mask], tj[mask], rtol=1e-4, atol=5e-2)
    # and the scan engine, each strand group with its own params
    for par, rows in ((jp, np.nonzero(strands)[0]),
                      (jrev, np.nonzero(~strands)[0])):
        lk_s, tab_s = modification_table_pileup(
            qs[rows], tpl, offs[rows], q_lens[rows], np.int32(tlen), par, W,
            tlen)
        ts = np.asarray(tab_s)
        m = ts > -1e29
        np.testing.assert_allclose(tab_p[rows][m], ts[m], rtol=1e-4,
                                   atol=5e-2)


def test_modtable_reduced_totals_and_sparse_gains():
    rng = np.random.default_rng(12)
    _jp, pp = _params()
    template, qs, offs, q_lens, W = _prep_batch(rng, n_reads=9)
    tlen = len(template)
    tpl = np.asarray(template, np.int8)
    seg = np.array([0, 0, 0, 1, 1, 2, 2, 2, 2], np.int32)
    lk0, tab0 = pmod.modification_table_pileup_pallas(
        qs, tpl, offs, q_lens, np.int32(tlen), pp, W, tlen)
    lk1, tot = pmod.modtable_pileup_gains(
        qs, tpl, offs, q_lens, np.int32(tlen), pp, W, tlen, seg, 3)
    tot = tot.cpu().numpy()
    np.testing.assert_allclose(lk1, lk0, rtol=1e-6)
    gain = np.where(tab0 < -1e29, np.float32(-1e30), tab0 - lk0[:, None, None])
    want = np.stack([gain[seg == s].sum(0) for s in range(3)])
    np.testing.assert_allclose(tot, want, rtol=2e-4, atol=0.5)
    min_gain = 0.1
    _lk, tot_dev = pmod.modtable_pileup_gains(
        qs, tpl, offs, q_lens, np.int32(tlen), pp, W, tlen, seg, 3)
    sp = pmod.finish_gains(tot_dev, 3, 16, min_gain)
    best_g = tot.max(-1)
    best_e = tot.argmax(-1)
    for s in range(3):
        assert sp.counts[s] == int((best_g[s] > min_gain).sum())
        order = np.argsort(-best_g[s], kind="stable")[:16]
        np.testing.assert_allclose(sp.vals[s], best_g[s][order], rtol=1e-5)
        np.testing.assert_allclose(sp.dense_row(s), tot[s], rtol=1e-6)
        exact = np.isin(sp.vals[s], best_g[s][order])
        assert exact.all()
        np.testing.assert_array_equal(sp.ev[s][:3], best_e[s][sp.idx[s][:3]])


def test_topk_ties_break_to_lower_position():
    """Sparse top-k equals dense with ties: equal gains come back in
    position order and each position's edit is its first best edit."""
    tot = torch.full((2, 10, pmod.NUM_EDIT), -5.0)
    tot[0, [2, 5, 7], 3] = 4.0          # three positions tied
    tot[0, 5, 9] = 4.0                  # a tied edit within position 5
    tot[1, 0, 1] = 1.0
    tot[1, 9, 0] = 1.0
    vals, idx, ev, counts = pmod._topk_gain(tot, 0.5, 4)
    assert idx[0, :3].tolist() == [2, 5, 7]
    assert ev[0, :3].tolist() == [3, 3, 3]
    assert idx[1, :2].tolist() == [0, 9]
    assert counts.tolist() == [3, 2]
    dense = tot.max(-1).values
    for s in range(2):
        order = np.argsort(-dense[s].numpy(), kind="stable")[:4]
        assert idx[s].tolist() == order.tolist()
        assert vals[s].tolist() == dense[s][order].tolist()
