"""The variant features' host work (``stages/local_clustering.
_variant_features_device`` and its helpers) held to ``jtk_tpu`` on the CPU,
bit for bit: the band offsets' native block (``native/band_offsets.cc``)
and its twin against the scalar ``linear_offsets``, the run lengths, the
p-value grid against the scalar binomial tails, and the candidate columns
with their scores."""

import numpy as np
import pytest

from jtk_tpu.ops import banded_align as jba
from jtk_tpu.stages import likelihood_gains as jlg
from jtk_tpu.stages import local_clustering as jlc
from jtk_tpu.stages import util as jutil
from jtk_tpu_torch import native_ext, trace
from jtk_tpu_torch.ops import banded_align as pba
from jtk_tpu_torch.ops.modtable import NUM_EDIT
from jtk_tpu_torch.stages import likelihood_gains as plg
from jtk_tpu_torch.stages import local_clustering as plc
from jtk_tpu_torch.stages import util as putil
from torch_util import port_on_cpu  # noqa: F401

NULLS = {"sub": [0.01, 0.02, 0.04], "del": [0.03, 0.00005, 0.2],
         "ins": [0.0100000004, 0.05, 0.5]}
EXPECTED = {"sub": [1.0, 1.2, 1.5], "del": [0.8, 0.9, 2.0],
            "ins": [0.7, 1.1, 1.3]}


@pytest.fixture
def traced():
    trace.reset()
    trace.enable()
    yield
    trace.disable()
    trace.reset()


def _counters():
    return trace.snapshot()["counters"]


def _band_blocks(seed=5, n_blocks=20, per_block=10):
    """(q_lens, t_lens, Q, W) blocks of ~200 pairs in all, every pair's band
    wide enough, with the edge cases in the first block: q_len = Q,
    t_len - q_len = W - 2, q_len far above t_len, q_len = 1, q_len 0."""
    rng = np.random.default_rng(seed)
    blocks = [(np.array([300, 17, 300, 1, 1, 0, 250], np.int32),
               np.array([300, 17 + 62, 3, 1, 60, 10, 312], np.int32),
               300, 64)]
    for _ in range(n_blocks - 1):
        W = int(rng.choice([8, 64, 128, 255, 256, 768]))
        Q = int(rng.integers(1, 3000))
        q = rng.integers(1, Q + 1, per_block)
        t = np.maximum(q + rng.integers(-Q, W - 1, per_block), 0)
        q[0] = Q
        blocks.append((q.astype(np.int32), t.astype(np.int32), Q, W))
    return blocks


def _scalar_rows(mod, q_lens, t_lens, Q, W):
    return np.stack([mod.linear_offsets(int(q), int(t), Q, W)
                     for q, t in zip(q_lens, t_lens)])


def test_native_block_equals_the_scalar_rows(traced):
    """One native call a block gives, row by row, the port's and
    ``jtk_tpu``'s ``linear_offsets`` (int32, every element)."""
    blocks = _band_blocks()
    assert sum(len(q) for q, _t, _Q, _W in blocks) >= 190
    for q_lens, t_lens, Q, W in blocks:
        got = pba.linear_offsets_block(q_lens, t_lens, Q, W)
        want = _scalar_rows(pba, q_lens, t_lens, Q, W)
        assert got.dtype == np.int32 and got.shape == (len(q_lens), Q + 1)
        assert np.array_equal(got, want)
        assert np.array_equal(got, _scalar_rows(jba, q_lens, t_lens, Q, W))
    n = sum(len(q) for q, _t, _Q, _W in blocks)
    assert _counters().get("band_offsets.native_rows") == n
    assert "band_offsets.twin_rows" not in _counters()


def test_twin_block_equals_the_native_block(traced, monkeypatch):
    """Without the native library the block is ``linear_offsets`` row by
    row, the same int32 block, counted as the twin's rows."""
    blocks = _band_blocks(seed=9, n_blocks=6)
    native = [pba.linear_offsets_block(*b) for b in blocks]
    monkeypatch.setattr(native_ext, "load", lambda name: None)
    twin = [pba.linear_offsets_block(*b) for b in blocks]
    for a, b in zip(native, twin):
        assert a.dtype == b.dtype == np.int32
        assert np.array_equal(a, b)
    n = sum(len(b[0]) for b in blocks)
    assert _counters()["band_offsets.native_rows"] == n
    assert _counters()["band_offsets.twin_rows"] == n


def test_a_band_too_narrow_raises_the_same_error(monkeypatch):
    """The native block and its twin raise the scalar's AssertionError at
    the first pair whose band is too narrow, and the native block before
    writing a row."""
    q_lens = np.array([100, 90, 50, 40], np.int32)
    t_lens = np.array([100, 90 + 62, 50 + 70, 40 + 80], np.int32)
    with pytest.raises(AssertionError) as scalar:
        pba.linear_offsets(50, 120, 128, 64)
    with pytest.raises(AssertionError) as native:
        pba.linear_offsets_block(q_lens, t_lens, 128, 64)
    monkeypatch.setattr(native_ext, "load", lambda name: None)
    with pytest.raises(AssertionError) as twin:
        pba.linear_offsets_block(q_lens, t_lens, 128, 64)
    assert str(native.value) == str(twin.value) == str(scalar.value)


@pytest.mark.parametrize("n", [0, 1, 2, 7, 300, 5000])
def test_run_lengths_equal_jtk_tpu(n):
    """Random bases (with N, code 4), runs of one or two codes, long
    runs."""
    rng = np.random.default_rng(n)
    cases = [rng.integers(0, 5, n).astype(np.int8),
             rng.integers(0, 2, n).astype(np.int8),
             np.repeat(rng.integers(0, 5, n), rng.integers(1, 40, n))[:n]
             .astype(np.int8),
             np.full(n, 4, np.int8)]
    for seq in cases:
        got = putil.homopolymer_length(seq)
        want = jutil.homopolymer_length(seq)
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)


def _gains():
    arr = lambda d: {k: np.array(v) for k, v in d.items()}  # noqa: E731
    return (plg.Gains(arr(EXPECTED), arr(NULLS)),
            jlg.Gains(arr(EXPECTED), arr(NULLS)))


@pytest.mark.parametrize("R", [1, 17, 120, 240])
def test_pvalue_grid_equals_the_scalar_tails(R, traced):
    """Each row is ``_binom_tail`` at its floored null probability and each
    element ``jtk_tpu``'s scalar p-value; one grid a read count (the
    probabilities 0.01 and 0.0100000004 share the first one's tail)."""
    gains, jgains = _gains()
    grid = gains.pvalue_grid(R)
    assert grid.dtype == np.float64
    assert grid.shape == (len(plg.DIFF_TYPES) * plg.MAX_HOMOP, R + 1)
    for di, dt in enumerate(plg.DIFF_TYPES):
        for L in (1, 2, 3):
            row = grid[di * plg.MAX_HOMOP + L - 1]
            p = max(NULLS[dt][L - 1], 1e-4)
            if dt == "ins" and L == 1:
                p = NULLS["sub"][0]
            assert np.array_equal(row, plg._binom_tail(p, R))
            want = [jgains.pvalue(dt, c, R, homop_len=L)
                    for c in range(R + 1)]
            assert np.array_equal(row, np.array(want))
    assert gains.pvalue_grid(R) is grid
    assert _counters()["gains.pvalue_grids"] == 1


def _template(rng, t_len):
    """Bases in runs of 1-4, so every homopolymer filter acts."""
    runs = rng.integers(1, 5, t_len)
    bases = rng.integers(0, 4, t_len)
    bases[1:] = (bases[:-1] + 1 + rng.integers(0, 3, t_len - 1)) % 4
    return np.repeat(bases, runs)[:t_len].astype(np.int8)


def _stats(rng, t_len, Trows, R, both, exp_mat):
    """Float64 variant stats as the device reduction gives them: noise
    counts everywhere past the template too, and ~40 planted columns with
    the counts of a variant; their gains above or below the compression
    test, and their strand tables balanced or one-sided."""
    counts = rng.binomial(R, 0.02, (Trows, NUM_EDIT)).astype(np.float64)
    rows = rng.integers(0, t_len + 2, 40)
    cols = rng.integers(0, NUM_EDIT, 40)
    counts[rows, cols] = rng.integers(R // 4, R + 3, 40)
    counts[0, 0] = -1.0
    factor = rng.choice([0.5, 0.9, 1.5, 3.0], (Trows, NUM_EDIT))
    tot_gain = counts * exp_mat * factor
    n = counts + rng.integers(0, 3, counts.shape)
    fwd = rng.choice([0.5, 0.97], counts.shape) if both else 1.0
    n_fwd = rng.binomial(np.maximum(n, 0).astype(np.int64), fwd)
    n_rev = np.maximum(n, 0) - n_fwd
    obs = np.zeros((Trows, NUM_EDIT, 2, 2))
    for s, m in ((0, n_rev), (1, n_fwd)):
        pos = rng.binomial(m.astype(np.int64), 0.6)
        obs[..., s, 1], obs[..., s, 0] = pos, m - pos
    return counts, tot_gain, obs


@pytest.mark.parametrize("both", [True, False])
@pytest.mark.parametrize("R", [5, 120, 240])
def test_candidates_equal_jtk_tpu(R, both):
    """``_variant_candidates`` gives ``jtk_tpu``'s columns and scores, with
    a ``jtk_tpu`` Gains of the same arrays, on both strands and on one;
    ``variant_exp_mat`` its matrix and run lengths."""
    rng = np.random.default_rng(1000 * R + both)
    gains, jgains = _gains()
    found = 0
    for t_len, Trows in ((300, 385), (1990, 2049)):
        template = _template(rng, t_len)
        exp_mat, hp, hp_idx = plc.variant_exp_mat(template, gains, Trows)
        jexp = jlc.variant_exp_mat(template, jgains, Trows)
        assert exp_mat.dtype == jexp[0].dtype == np.float32
        for a, b in zip((exp_mat, hp, hp_idx), jexp):
            assert np.array_equal(a, b)
        counts, tot_gain, obs = _stats(rng, t_len, Trows, R, both, exp_mat)
        args = (template, R, counts, tot_gain, obs, both)
        rest = (12.0, 2, exp_mat, hp, hp_idx)
        cand, scores = plc._variant_candidates(*args, gains, *rest)
        jcand, jscores = jlc._variant_candidates(*args, jgains, *rest)
        assert np.array_equal(cand, jcand)
        assert scores.dtype == jscores.dtype
        assert np.array_equal(scores, jscores)
        found += len(cand)
    assert found > 0


def test_filter_variants_equals_jtk_tpu():
    """The host path (float32 profiles, the recursive clustering's) picks
    ``jtk_tpu``'s columns: its float32 gains meet the p-value grid."""
    rng = np.random.default_rng(77)
    gains, jgains = _gains()
    t_len, Trows, R = 260, 261, 40
    template = _template(rng, t_len)
    prof = rng.normal(0, 0.3, (R, Trows, NUM_EDIT)).astype(np.float32)
    hap = rng.random(R) < 0.5
    for j, e in zip(rng.integers(10, t_len - 10, 12),
                    rng.integers(0, NUM_EDIT, 12)):
        prof[hap, j, e] = rng.uniform(2.0, 6.0, hap.sum())
    strands = rng.random(R) < 0.5
    prof = prof.reshape(R, -1)
    got = plc.filter_variants(template, prof, strands, gains, 10.0, 2)
    want = jlc.filter_variants(template, prof, strands, jgains, 10.0, 2)
    assert len(want) > 0
    assert np.array_equal(got, want)
