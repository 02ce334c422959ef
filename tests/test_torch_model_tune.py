"""Model tuning in the port against the JAX package: the gradient of
PairHMMLikelihood (plain counts on the CPU), the train step and
``_fit_strand``.

Tolerances: gradients within rtol 1e-3 / atol 1e-4 after division by the
batch's base pairs (float32 sums in another order: closed-form expected
counts against reverse-mode autodiff through the scan); theta after ten
steps atol 1e-4.

The reference's autodiff gradient is NaN for every read shorter than the
padded query length: its frozen rows past q_len are all-zero rows scaled by
EPS, and the VJP of ``where(live, row / sc, prev)`` meets 0/0 there.  Its
train step then zeroes the non-finite entries, so on such batches it takes
no step and ``_fit_strand`` only renormalises the rows.  The port computes
the gradient of lk itself.  So the parity tests use reads of the full
padded length, where the reference's gradient is defined, and the test on
tests/test_model_tune.py's data asks the port's fit to be at least as good.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtk_tpu import parallel as jpar
from jtk_tpu.datamodel import HMMParam
from jtk_tpu.io import sim
from jtk_tpu.ops import phmm as jphmm
from jtk_tpu.ops.banded_align import linear_offsets
from jtk_tpu.ops.polish import effective_band
from jtk_tpu.stages import model_tune as jtune
from jtk_tpu_torch import parallel as ppar
from jtk_tpu_torch.ops import phmm as pphmm
from jtk_tpu_torch.ops import phmm_grad as pg
from jtk_tpu_torch.ops import phmm_lk as k1l
from jtk_tpu_torch.stages import model_tune as ptune
from torch_util import port_on_cpu  # noqa: F401

KEYS = ("trans", "mat_emit", "ins_emit")


def _jparams():
    return jphmm.PHMMParams.from_hmmparam(HMMParam())


def _full_length_batch(rng, n=12, L=192):
    """Reads of exactly the padded length L (substitutions, plus indel reads
    trimmed or topped up from the template), so no row is frozen."""
    template = sim.random_genome(rng, L)
    reads = []
    for i in range(n):
        if i % 3 == 2:
            r = sim.noisy_read(rng, template, 0.06)
            r = np.concatenate([r, template[len(r):]])[:L]
        else:
            r = template.copy()
            m = rng.random(L) < 0.06
            r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
        reads.append(r.astype(np.int8))
    return template, reads


def _batch(template, reads, Qmult=64, W=64):
    L = len(template)
    q_lens = np.array([len(r) for r in reads], np.int32)
    W = effective_band(W, q_lens, L)
    Qpad = ((int(q_lens.max()) + Qmult - 1) // Qmult) * Qmult
    qs = np.full((len(reads), Qpad), 4, np.int8)
    for i, r in enumerate(reads):
        qs[i, :len(r)] = r
    offs = np.stack([linear_offsets(int(n), L, Qpad, W) for n in q_lens])
    return qs, offs, q_lens, W


def _jax_grad(theta, template, qs, offs, q_lens, W):
    def f(t):
        return jpar._batch_neg_lk(t, jnp.asarray(qs),
                                  jnp.asarray(template, jnp.int8),
                                  jnp.asarray(offs), jnp.asarray(q_lens),
                                  np.int32(len(template)), W)[0]
    g = jax.grad(f)(theta)
    return [np.asarray(g[k]) for k in KEYS]


def _port_grad(template, qs, offs, q_lens, W, plain_forward=False):
    theta = ppar.params_to_theta(_jparams())
    th = {k: v.clone().requires_grad_(True) for k, v in theta.items()}
    params = ppar.theta_to_params(th)
    batch = pg.PairBatch(qs, np.asarray(template, np.int8), offs, q_lens,
                         len(template), W)
    if plain_forward:
        lk = k1l.phmm_lk_plain(*batch.lk_args, *k1l.tables8(params, "cpu"))
    else:
        lk = pg.pair_likelihood(params, batch)
    (-lk.sum()).backward()
    return [th[k].grad.numpy() for k in KEYS]


def test_theta_carries_over():
    jp = _jparams()
    jt = jpar.params_to_theta(jp)
    pt = ppar.params_to_theta(jp)
    for k in KEYS:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(jt[k]),
                                   rtol=1e-6, atol=1e-6)
    back = ppar.theta_to_params(pt)
    want = jpar.theta_to_params(jt)
    for a, b in zip(back, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_gradient_matches_jax_grad(seed):
    rng = np.random.default_rng(seed)
    template, reads = _full_length_batch(rng)
    qs, offs, q_lens, W = _batch(template, reads)
    bp = float(q_lens.sum())
    want = _jax_grad(jpar.params_to_theta(_jparams()), template, qs, offs,
                     q_lens, W)
    got = _port_grad(template, qs, offs, q_lens, W)
    for g, w in zip(got, want):
        assert np.all(np.isfinite(w))
        np.testing.assert_allclose(g / bp, w / bp, rtol=1e-3, atol=1e-4)


def test_gradient_matches_autograd_through_plain_forward():
    """On tests/test_model_tune.py's data (reads shorter than the padded
    length): the counts path against torch.autograd through the plain K1l
    forward, and the reference's autodiff gradient is NaN there."""
    rng = np.random.default_rng(0)
    template = sim.random_genome(rng, 200)
    reads = [sim.noisy_read(rng, template, 0.08) for _ in range(16)]
    qs, offs, q_lens, W = _batch(template, reads)
    bp = float(q_lens.sum())
    got = _port_grad(template, qs, offs, q_lens, W)
    want = _port_grad(template, qs, offs, q_lens, W, plain_forward=True)
    for g, w in zip(got, want):
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g / bp, w / bp, rtol=1e-3, atol=1e-4)
    ref = _jax_grad(jpar.params_to_theta(_jparams()), template, qs, offs,
                    q_lens, W)
    assert all(np.isnan(r).all() for r in ref)


def test_expected_counts_account_for_every_base():
    """Each query base is emitted by exactly one M or I state, and each
    template base is consumed by exactly one M or D state."""
    rng = np.random.default_rng(5)
    template = sim.random_genome(rng, 150)
    reads = [sim.noisy_read(rng, template, 0.08) for _ in range(6)]
    qs, offs, q_lens, W = _batch(template, reads)
    batch = pg.PairBatch(qs, template, offs, q_lens, len(template), W)
    params = pphmm.PHMMParams.default("cpu")
    c = pg.phmm_counts(*pg.counts_args(pg.counts_prep(params, batch), W))
    assert c.shape == (len(reads), pg.N_COUNTS)
    np.testing.assert_allclose(c[:, 9:].sum(1).numpy(), q_lens, rtol=1e-4)
    # every M and D state consumes one template base
    m_states = c[:, 9:25].sum(1)
    d_states = c[:, [2, 5, 8]].sum(1)
    np.testing.assert_allclose((m_states + d_states).numpy(),
                               np.full(len(reads), len(template)),
                               rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_counts_finite_for_a_read_that_starts_late(seed):
    """A read that starts 22 bases into its template: at row 0 a cell's
    weight exp(fcum + bcum - lk) passes float32's range where F * B is
    tiny.  Split between the two tables it stays finite, and the read's
    M + I emissions still sum to its length."""
    rng = np.random.default_rng(seed)
    template = sim.random_genome(rng, 300)
    reads = [sim.noisy_read(rng, template, 0.05)[:316] for _ in range(6)]
    reads[0] = reads[0][22:]
    qs, offs, q_lens, W = _batch(template, reads)
    batch = pg.PairBatch(qs, template, offs, q_lens, len(template), W)
    params = pphmm.PHMMParams.default("cpu")
    c = pg.phmm_counts_plain(*pg.counts_args(pg.counts_prep(params, batch),
                                             W))
    assert torch.isfinite(c).all()
    np.testing.assert_allclose(c[:, 9:].sum(1).numpy(), q_lens, rtol=1e-4)


def test_ten_train_steps_match_jax():
    rng = np.random.default_rng(2)
    template, reads = _full_length_batch(rng, n=10)
    qs, offs, q_lens, W = _batch(template, reads)
    # two weight-0 stubs, as _fit_strand pads the batch
    qs = np.concatenate([qs, qs[:2]])
    offs = np.concatenate([offs, offs[:2]])
    q_lens = np.concatenate([q_lens, q_lens[:2]])
    wts = np.array([1.0] * 10 + [0.0] * 2, np.float32)
    jstep = jpar.make_train_step(jpar.make_mesh(1), W)
    jt = jpar.params_to_theta(_jparams())
    tpl = np.asarray(template, np.int8)
    jlosses = []
    for _ in range(10):
        jt, loss = jstep(jt, qs, tpl, offs, q_lens, np.int32(len(tpl)), wts)
        jlosses.append(float(loss))
    step = ppar.make_train_step(W)
    batch = pg.PairBatch(qs, tpl, offs, q_lens, len(tpl), W)
    pt = ppar.params_to_theta(_jparams())
    plosses = []
    for _ in range(10):
        pt, loss = step(pt, batch, torch.as_tensor(wts))
        plosses.append(float(loss))
    for k in KEYS:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(jt[k]),
                                   atol=1e-4)
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-5)
    assert plosses[-1] < plosses[0]


def test_train_steps_chunk_equals_single_steps():
    rng = np.random.default_rng(3)
    template, reads = _full_length_batch(rng, n=8, L=128)
    qs, offs, q_lens, W = _batch(template, reads)
    batch = pg.PairBatch(qs, template, offs, q_lens, len(template), W)
    wts = torch.ones(len(reads))
    theta = ppar.params_to_theta(_jparams())
    many_theta, losses = ppar.make_train_steps(W, n_inner=3)(theta, batch,
                                                             wts)
    step = ppar.make_train_step(W)
    single = []
    for _ in range(3):
        theta, loss = step(theta, batch, wts)
        single.append(float(loss))
    np.testing.assert_array_equal(losses.numpy(), np.array(single,
                                                           np.float32))
    for k in KEYS:
        assert torch.equal(many_theta[k], theta[k])


def _lk_sum(reads, template, params):
    qs, offs, q_lens, W = _batch(template, reads)
    lks = jphmm.likelihood_pileup(qs, template, offs, q_lens,
                                  np.int32(len(template)), params, W)
    return float(np.sum(np.asarray(lks)))


def _to_jax(p):
    return jphmm.PHMMParams(*(np.asarray(x.detach().numpy()) for x in p))


def _port_init():
    return pphmm.PHMMParams.from_hmmparam(HMMParam(), "cpu")


def test_fit_strand_full_length_matches_jax():
    rng = np.random.default_rng(7)
    template, reads = _full_length_batch(rng, n=12)
    init = _jparams()
    lk0 = _lk_sum(reads, template, init)
    jfit = jtune._fit_strand(reads, template, init, W=64, steps=20)
    pfit = ptune._fit_strand(reads, template, _port_init(), W=64, steps=20)
    lk_j = _lk_sum(reads, template, jfit)
    lk_p = _lk_sum(reads, template, _to_jax(pfit))
    assert lk_p > lk0
    assert abs(lk_p - lk_j) <= 0.005 * abs(lk_j), (lk0, lk_j, lk_p)


def test_fit_strand_improves_and_stays_stochastic():
    """tests/test_model_tune.py's data: the lk rises, rows stay stochastic,
    and the fit is at least as good as the reference's (which takes no
    step here, see the module docstring) up to 0.5 %."""
    rng = np.random.default_rng(0)
    template = sim.random_genome(rng, 200)
    reads = [sim.noisy_read(rng, template, 0.08) for _ in range(16)]
    init = _jparams()
    lk0 = _lk_sum(reads, template, init)
    fitted = ptune._fit_strand(reads, template, _port_init(), W=64, steps=40)
    for x in fitted:
        assert torch.isfinite(x).all()
    lk1 = _lk_sum(reads, template, _to_jax(fitted))
    assert lk1 > lk0, (lk0, lk1)
    lk_j = _lk_sum(reads, template,
                   jtune._fit_strand(reads, template, init, W=64, steps=40))
    assert lk1 >= lk_j - 0.005 * abs(lk_j), (lk_j, lk1)
    hp = ptune._params_to_hmmparam(fitted)
    assert abs(hp.mat_mat + hp.mat_ins + hp.mat_del - 1) < 1e-3
    assert abs(sum(hp.mat_emit[:4]) - 1) < 1e-3
    assert abs(sum(hp.ins_emit[16:]) - 1) < 1e-3


def test_fit_strand_too_few_reads_keeps_init():
    rng = np.random.default_rng(8)
    template = sim.random_genome(rng, 100)
    init = _port_init()
    assert ptune._fit_strand([], template, init, W=64) is init
    junk = [sim.random_genome(rng, 100) for _ in range(3)]
    assert ptune._fit_strand(junk, template, init, W=64) is init
