"""The port against the JAX package at a band wider than 1024, where K1l,
the counts kernel and K3 now launch on the card: the plain versions
(which the kernels are held to there) against ``jtk_tpu`` on the CPU.

Tolerances: lk atol 2e-2 (tests/test_pallas_phmm.py's), gradients rtol
1e-3 / atol 1e-4 per bp (tests/test_torch_model_tune.py's), K3 bit-exact.
"""

import numpy as np

from jtk_tpu import parallel as jpar
from jtk_tpu.datamodel import HMMParam
from jtk_tpu.io import sim
from jtk_tpu.ops import banded_align as jba
from jtk_tpu.ops import phmm as jphmm
from jtk_tpu.ops.polish import effective_band
from jtk_tpu_torch.ops import banded_align as pba
from jtk_tpu_torch.ops import phmm as pphmm
from test_torch_edit_dp import _pairs
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
