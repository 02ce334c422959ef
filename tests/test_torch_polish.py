"""Polishing in the port against the JAX package on tests/test_polish.py's
inputs: the same polished templates."""

import numpy as np
import pytest

from jtk_tpu.datamodel import HMMParam
from jtk_tpu.io import sim
from jtk_tpu.ops import phmm as jphmm
from jtk_tpu.ops import polish as jpol
from jtk_tpu_torch.ops import phmm as pphmm
from jtk_tpu_torch.ops import polish as ppol
from test_polish import _mutate
from torch_util import port_on_cpu  # noqa: F401


def _params():
    return (jphmm.PHMMParams.from_hmmparam(HMMParam()),
            pphmm.PHMMParams.from_hmmparam(HMMParam()))


def test_polish_until_converge_matches_jax():
    rng = np.random.default_rng(0)
    true = rng.integers(0, 4, size=150).astype(np.int8)
    draft = _mutate(rng, true, 0.02)
    reads = [_mutate(rng, true, 0.05) for _ in range(12)]
    jp, pp = _params()
    want, want_lks = jpol.polish_until_converge(draft, reads, jp, W=64)
    got, got_lks = ppol.polish_until_converge(draft, reads, pp, W=64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got_lks, want_lks, rtol=1e-4, atol=2e-2)


def test_polish_many_matches_jax():
    rng = np.random.default_rng(8)
    jp, pp = _params()
    tpls, pileups = [], []
    for _ in range(3):
        true = sim.random_genome(rng, 180)
        tpls.append(sim.noisy_read(rng, true, 0.03))
        pileups.append([sim.noisy_read(rng, true, 0.06) for _ in range(12)])
    want, want_lks = jpol.polish_many(tpls, pileups, jp, W=64, max_rounds=8)
    got, got_lks = ppol.polish_many(tpls, pileups, pp, W=64, max_rounds=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for g, w in zip(got_lks, want_lks):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=2e-2)
    # and the single-template path agrees with the batched one
    for t, p, m in zip(tpls, pileups, got):
        single, _ = ppol.polish_until_converge(t, p, pp, W=64, max_rounds=8)
        np.testing.assert_array_equal(single, m)


@pytest.mark.parametrize("far", [0, 5])
def test_polish_until_converge_drops_a_far_read(far):
    """A read whose deficit is past 8W (at W 16: 121 bases) is dropped
    from every round, wherever it sits in the pileup: its lk is -1e30 and
    the template is the JAX package's and polish_many's."""
    rng = np.random.default_rng(9)
    jp, pp = _params()
    true = sim.random_genome(rng, 180)
    draft = sim.noisy_read(rng, true, 0.03)
    reads = [sim.noisy_read(rng, true, 0.06) for _ in range(8)]
    reads.insert(far, true[60:100].copy())
    want, want_lks = jpol.polish_until_converge(draft, reads, jp, W=16,
                                                max_rounds=4)
    got, got_lks = ppol.polish_until_converge(draft, reads, pp, W=16,
                                              max_rounds=4)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, draft)
    assert got_lks[far] == want_lks[far] == -1e30
    assert (np.delete(got_lks, far) > -1e29).all()
    np.testing.assert_allclose(got_lks, want_lks, rtol=1e-4, atol=2e-2)
    (many,), (many_lks,) = ppol.polish_many([draft], [reads], pp, W=16,
                                            max_rounds=4)
    np.testing.assert_array_equal(got, many)
    np.testing.assert_array_equal(got_lks, many_lks)


def test_band_buckets_and_edits_are_the_jax_package_s():
    q = np.concatenate([np.full(606, 2000), np.full(4, 1900), [1700]])
    t = np.full(611, 2000)
    for W in (64, 128):
        a, da = ppol.band_buckets(q, t, W)
        b, db = jpol.band_buckets(q, t, W)
        assert [(w, list(i)) for w, i in a] == [(w, list(i)) for w, i in b]
        assert list(da) == list(db)
    tpl = np.arange(20, dtype=np.int8) % 4
    edits = [(3, 2, 1.0), (7, 5, 1.0), (12, 9, 1.0), (16, 12, 1.0)]
    np.testing.assert_array_equal(ppol.apply_edits(tpl, edits),
                                  jpol.apply_edits(tpl, edits))
    assert ppol.pad_bucket(2500) == jpol.pad_bucket(2500)
