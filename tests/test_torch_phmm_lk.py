"""K1l (forward log-likelihood without tables) in the port against the JAX
package: the plain version against ``pallas_likelihood_pileup`` in
interpret mode and against the scan engine's ``likelihood_pileup``, at
tests/test_pallas_phmm.py's sizes, with lk within rtol 1e-4 / atol 2e-2
(float32 sums in another order than the reference's)."""

import numpy as np
import pytest

from jtk_tpu.datamodel import HMMParam
from jtk_tpu.io import sim
from jtk_tpu.ops import phmm as jphmm
from jtk_tpu.ops.banded_align import linear_offsets
from jtk_tpu.ops.pallas_phmm import pallas_likelihood_pileup
from jtk_tpu.ops.polish import effective_band
from jtk_tpu_torch.ops import phmm as pphmm
from jtk_tpu_torch.ops import phmm_lk as k1l
from jtk_tpu_torch.ops import phmm_tables as pt
from torch_util import port_on_cpu  # noqa: F401

RTOL, ATOL = 1e-4, 2e-2


def _params():
    jp = jphmm.PHMMParams.from_hmmparam(HMMParam())
    pp = pphmm.params_from_numpy(np.asarray(jp.trans),
                                 np.asarray(jp.mat_emit),
                                 np.asarray(jp.ins_emit), "cpu")
    return jp, pp


def _pileup(rng, n_reads, tlen, err, W=64, short=0):
    template = sim.random_genome(rng, tlen)
    reads = [sim.noisy_read(rng, template, err) for _ in range(n_reads)]
    # ``short`` reads end early, so the band must widen to reach t_len
    reads = [r[:len(r) - short] if i % 2 == 0 else r
             for i, r in enumerate(reads)]
    q_lens = np.array([len(r) for r in reads], np.int32)
    W = effective_band(W, q_lens, tlen)
    Qpad = ((int(q_lens.max()) + 7) // 8) * 8
    qs = np.full((n_reads, Qpad), 4, np.int8)
    for i, r in enumerate(reads):
        qs[i, :len(r)] = r
    offs = np.stack([linear_offsets(int(n), tlen, Qpad, W) for n in q_lens])
    return template, reads, qs, offs, q_lens, W


@pytest.mark.parametrize("seed,tlen,err,short", [
    (0, 150, 0.08, 0),     # tests/test_pallas_phmm.py's case
    (3, 150, 0.08, 0),     # _prep_batch's template length
    (5, 200, 0.05, 40),    # reads shorter than the template: W widens
])
def test_lk_matches_pallas_and_scan(seed, tlen, err, short):
    rng = np.random.default_rng(seed)
    jp, pp = _params()
    template, reads, qs, offs, q_lens, W = _pileup(rng, 10, tlen, err,
                                                   short=short)
    if short:
        assert W > 64
    pal = pallas_likelihood_pileup(reads, template, jp, W=64, interpret=True)
    scan = np.asarray(jphmm.likelihood_pileup(
        qs, template, offs, q_lens, np.int32(tlen), jp, W))
    got = pphmm.likelihood_pileup(qs, template, offs, q_lens, tlen, pp, W)
    np.testing.assert_allclose(got, scan, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pal, rtol=RTOL, atol=ATOL)


def test_lk_pairs_per_pair_templates_match_scan():
    """likelihood_pairs with a template per pair (the gain calibration's
    layout) against the scan engine's likelihood_pairs_dense."""
    rng = np.random.default_rng(11)
    jp, pp = _params()
    B, T, Q, W = 12, 128, 160, 64
    qs = np.full((B, Q), 4, np.int8)
    rs = np.full((B, T), 4, np.int8)
    q_lens = np.zeros(B, np.int32)
    t_lens = np.zeros(B, np.int32)
    offs = np.zeros((B, Q + 1), np.int32)
    for b in range(B):
        t = sim.random_genome(rng, int(rng.integers(90, T)))
        r = sim.noisy_read(rng, t, 0.06)[:Q]
        rs[b, :len(t)], qs[b, :len(r)] = t, r
        q_lens[b], t_lens[b] = len(r), len(t)
        offs[b] = linear_offsets(len(r), len(t), Q, W)
    want = np.asarray(jphmm.likelihood_pairs_dense(qs, rs, offs, q_lens,
                                                   t_lens, jp, W))
    got = pphmm.likelihood_pairs(qs, rs, offs, q_lens, t_lens, pp, W,
                                 max_batch=5)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_lk_with_n_in_read_matches_scan():
    """An N (code 4) inside a read emits with probability 0 in the
    reference; the port's likelihood_pairs keeps that (the tables engine
    scores it as A and gave another lk)."""
    rng = np.random.default_rng(2)
    jp, pp = _params()
    template, _reads, qs, offs, q_lens, W = _pileup(rng, 4, 120, 0.05)
    qs[1, 30] = 4
    want = np.asarray(jphmm.likelihood_pileup(
        qs, template, offs, q_lens, np.int32(120), jp, W))
    got = pphmm.likelihood_pileup(qs, template, offs, q_lens, 120, pp, W)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got[1] < got[0] - 1000


def test_lk_plain_equals_tables_lk():
    """K1l and the forward tables give the same lk on ACGT inputs."""
    rng = np.random.default_rng(4)
    _jp, pp = _params()
    template, _reads, qs, offs, q_lens, W = _pileup(rng, 6, 150, 0.08)
    args = k1l.lk_inputs(qs, template, offs, q_lens, 150, W)
    lk = k1l.phmm_lk(*args, *k1l.tables8(pp, "cpu"))
    prep = pt.prep_tables_inputs(qs, template, offs, q_lens, 150, pp, W)
    lk_f = pt.tables_batch(prep, W, backward=False)[0]
    np.testing.assert_allclose(lk.numpy(), lk_f.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_likelihood_pairs_launches_no_table_kernel():
    """On the CPU the wrapper runs the plain version: no launch counted
    anywhere, and the tables' counters stay put."""
    rng = np.random.default_rng(6)
    _jp, pp = _params()
    template, _reads, qs, offs, q_lens, W = _pileup(rng, 3, 100, 0.05)
    counts = (k1l.LAUNCHES.count, pt.FWD_LAUNCHES.count,
              pt.BWD_LAUNCHES.count)
    pphmm.likelihood_pileup(qs, template, offs, q_lens, 100, pp, W)
    assert (k1l.LAUNCHES.count, pt.FWD_LAUNCHES.count,
            pt.BWD_LAUNCHES.count) == counts
