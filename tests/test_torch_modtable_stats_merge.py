"""The variant stats' one copy to the host (``stages/local_clustering.
_variant_features_device``) on the CPU: the features sum their band
buckets' float64 stats on the primary and copy them to the host once, bit
for bit the host's float64 sum of every slice's float32 block, at every
shard count; the copy is counted in ``modtable.stats_host_bytes``, which
the benchmark's reader ``modtable.stats_host_mb_per_chunk`` reads over
``clustering.chunks``.  The engine's own float64 sum of its slices is
held to numpy's in ``test_torch_parallel.test_modtable_engines_bit_
identical``."""

import functools

import numpy as np
import pytest

from jtk_tpu_torch import runtime, trace
from jtk_tpu_torch.io import sim
from jtk_tpu_torch.ops import modtable as pmod
from jtk_tpu_torch.ops import phmm as pphmm
from jtk_tpu_torch.ops.polish import band_buckets
from jtk_tpu_torch.stages import local_clustering as lc
from jtk_tpu_torch.stages.likelihood_gains import Gains
from test_torch_parallel import SHARDS, _record_stats_blocks
from test_torch_trace import load_reader
from torch_util import port_on_cpu  # noqa: F401

BAND = 128
TPAD = 256


def _gains():
    return Gains(expected_h={d: np.array([1.0, 1.2, 1.5])
                             for d in ("sub", "ins", "del")},
                 null_prob_h={d: np.array([0.01, 0.02, 0.04])
                              for d in ("sub", "ins", "del")})


def _per_chunk(seed=21, L=220):
    """Two chunks of a diploid pileup: 12 reads of either haplotype over
    the whole template, and 6 that stop 90 bases short of its end (so
    the pairs fall into two band buckets)."""
    rng = np.random.default_rng(seed)
    out = {}
    for cid in (3, 7):
        hap1 = sim.random_genome(rng, L).astype(np.int8)
        hap2 = hap1.copy()
        for p in rng.choice(np.arange(20, L - 20), 4, replace=False):
            hap2[p] = (hap2[p] + 1) % 4
        reads, strands = [], []
        for i in range(18):
            hap = hap1 if i % 2 else hap2
            if i >= 12:
                hap = hap[:L - 90]
            reads.append(sim.noisy_read(rng, hap, 0.05).astype(np.int8))
            strands.append(bool(i % 3))
        out[cid] = (reads, strands, hap1)
    return out


def _features(per_chunk):
    pf = pphmm.PHMMParams.default("cpu")
    pr = pphmm.params_from_numpy(*(x.numpy() * 0.9 + 0.1 / x.shape[1]
                                   for x in pf), "cpu")
    return lc._variant_features_device(
        per_chunk, pf, pr, BAND, TPAD, _gains(), 12.0,
        {cid: 2 for cid in per_chunk})


def _buckets(per_chunk):
    q = [len(r) for reads, _s, _t in per_chunk.values() for r in reads]
    t = [len(tpl) for reads, _s, tpl in per_chunk.values() for _r in reads]
    return band_buckets(np.array(q), np.array(t), BAND)[0]


def _bits(x):
    return np.ascontiguousarray(x, np.float64).view(np.int64)


@pytest.mark.parametrize("n_dev", [1] + SHARDS)
def test_features_use_the_stats_the_host_would_sum(n_dev, monkeypatch):
    """Two band buckets of two and one slices (MAXB cut to 16): the stats
    each chunk's candidates read are the host's float64 sum of every
    slice's block (bucket after bucket, slice after slice), and stats
    summed so on the host give the same columns and features."""
    monkeypatch.setattr(pmod, "MAXB", 16)
    per_chunk = _per_chunk()
    assert [len(idx) for _w, idx in _buckets(per_chunk)] == [24, 12]
    blocks = _record_stats_blocks(monkeypatch)
    read = []
    orig = lc._variant_candidates

    def recorded(template, n_reads, counts, tot_gain, obs, *rest):
        read.append((counts, tot_gain, obs))
        return orig(template, n_reads, counts, tot_gain, obs, *rest)
    monkeypatch.setattr(lc, "_variant_candidates", recorded)
    with runtime.use_devices(["cpu"] * n_dev):
        got = _features(per_chunk)
        assert len(blocks) == 3 and len(read) == 2
        want = functools.reduce(
            np.add, (b.astype(np.float64) for b in blocks))
        assert want.shape == (2, TPAD + 1, pmod.NUM_EDIT, 6)
        for st, (counts, tot_gain, obs) in zip(want, read):
            assert counts.dtype == np.float64
            assert np.array_equal(_bits(counts), _bits(st[..., 0]))
            assert np.array_equal(_bits(tot_gain), _bits(st[..., 1]))
            assert np.array_equal(_bits(obs), _bits(st[..., 2:6].reshape(
                obs.shape)))
        host_rows = iter(want)

        def host_summed(template, n_reads, _c, _g, obs, *rest):
            st = next(host_rows)
            return orig(template, n_reads, st[..., 0], st[..., 1],
                        st[..., 2:6].reshape(obs.shape), *rest)
        monkeypatch.setattr(lc, "_variant_candidates", host_summed)
        host = _features(per_chunk)
    assert sorted(got) == sorted(host) == [3, 7]
    assert any(len(got[cid][0]) for cid in got)
    for cid in got:
        cols, X = got[cid]
        assert np.array_equal(cols, host[cid][0])
        if X is None:
            assert host[cid][1] is None
        else:
            assert X.dtype == np.float32
            assert np.array_equal(X, host[cid][1])


def test_the_counter_counts_one_copy_a_call_and_its_reader_reads_it():
    """While tracing, a features call of two buckets adds one float64
    (chunks, Tpad + 1, 14, 6) block; the reader gives the bytes in MB a
    chunk over ``clustering.chunks``, and None without the counter; with
    tracing off nothing is counted."""
    reader = load_reader("modtable.stats_host_mb_per_chunk")
    block = 2 * (TPAD + 1) * pmod.NUM_EDIT * 6 * 8
    per_chunk = _per_chunk()
    trace.reset()
    trace.enable()
    try:
        _features(per_chunk)
        assert trace.snapshot()["counters"]["modtable.stats_host_bytes"] \
            == block
        trace.count("clustering.chunks", 2)
        assert reader.read(None) == block / 1e6 / 2
        trace.reset()
        trace.count("clustering.chunks", 2)
        assert reader.read(None) is None
    finally:
        trace.disable()
        trace.reset()
    _features(per_chunk)
    assert "modtable.stats_host_bytes" not in trace.snapshot()["counters"]


def test_the_features_count_their_offsets_rows_and_pvalue_grids():
    """A traced features call builds every pair's band offsets in one
    block a band bucket, the native rows and the twin's together one a
    pair, and at most one p-value grid a distinct read count."""
    per_chunk = _per_chunk()
    n_pairs = sum(len(reads) for reads, _s, _t in per_chunk.values())
    trace.reset()
    trace.enable()
    try:
        _features(per_chunk)
        counters = trace.snapshot()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert counters.get("band_offsets.native_rows", 0) \
        + counters.get("band_offsets.twin_rows", 0) == n_pairs
    n_reads = {len(reads) for reads, _s, _t in per_chunk.values()}
    assert 1 <= counters["gains.pvalue_grids"] <= len(n_reads)
