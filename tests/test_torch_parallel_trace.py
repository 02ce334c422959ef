"""The device set's spans and counters (``parallel.merge``,
``parallel.merge_bytes``, ``parallel.launches.<i>``) on the CPU: on
["cpu"] * 4 both modtable engines give the bits of ["cpu"], traced or
not; the launches by entry sum to the launches made; merge bytes are 0 on
one entry and counted by entry on four; a merge lies inside the spans
that held it before; tracing off records nothing of them; and a device
span inside a shard's work synchronizes that shard's device alone."""

import copy

import numpy as np
import pytest
import torch

from jtk_tpu_torch import parallel as ppar
from jtk_tpu_torch import runtime, trace
from jtk_tpu_torch.io import sim
from jtk_tpu_torch.ops import cuda_build
from jtk_tpu_torch.ops import modtable as pmod
from jtk_tpu_torch.ops import phmm as pphmm
from jtk_tpu_torch.ops.banded_align import linear_offsets
from test_torch_trace import cluster, encoded_dataset, inside, profiled
from torch_util import port_on_cpu  # noqa: F401

N_PAIRS = 70   # five slices of at most 16 pairs: entry 0 takes two of four


def _inputs(seed=8, n=N_PAIRS, L=150, W=128):
    rng = np.random.default_rng(seed)
    template = sim.random_genome(rng, L).astype(np.int8)
    reads = [sim.noisy_read(rng, template, 0.08) for _ in range(n)]
    q_lens = np.array([len(r) for r in reads], np.int32)
    Qpad = ((int(q_lens.max()) + 63) // 64) * 64
    qs = np.full((n, Qpad), 4, np.int8)
    for i, r in enumerate(reads):
        qs[i, :len(r)] = r
    offs = np.stack([linear_offsets(int(q), L, Qpad, W) for q in q_lens])
    strands = rng.random(n) < 0.5
    seg = rng.integers(0, 3, n).astype(np.int32)
    return template, qs, offs, q_lens, W, strands, seg


def _engines(n_dev):
    """Both engines (tables, per-segment totals, variant stats and the
    columns' gather) on ["cpu"] * n_dev: their outputs as numpy."""
    template, qs, offs, q_lens, W, strands, seg = _inputs()
    L = len(template)
    pf = pphmm.PHMMParams.default("cpu")
    pr = pphmm.params_from_numpy(*(x.numpy() * 0.9 + 0.1 / x.shape[1]
                                   for x in pf), "cpu")
    args = (qs, template, offs, q_lens, np.int32(L), pf, W, L)
    kw = dict(strands=strands, params_rev=pr)
    exp_mat = np.full((3, L + 1, pmod.NUM_EDIT), 0.5, np.float32)
    with runtime.use_devices(["cpu"] * n_dev):
        lk, tab = pmod.modification_table_pileup_pallas(*args, **kw)
        lk2, tot = pmod.modtable_pileup_gains(*args, seg, 3, **kw)
        tot = tot.cpu().numpy()
        lks, stats, gather = pmod.modtable_pileup_stats_pallas(
            qs, template, offs, q_lens, np.int32(L), pf, W, L, strands, pr,
            seg, 3, exp_mat)
        raw, comp = gather(np.array([0, 5, 77, 14 * 40 + 3], np.int64))
    return dict(lk=lk, tab=tab, lk2=lk2, tot=tot, lks=lks,
                stats=stats.numpy(), raw=raw, comp=comp)


def _launch_standing_in_for_k2(orig):
    """The plain assembly, counted as K2's one launch a slice."""
    def assembly(q, offsets, *rest):
        out = orig(q, offsets, *rest)
        pmod.ASSEMBLY_LAUNCHES.add(tuple(q.shape))
        return out
    return assembly


def _snapshot_counters(prefix):
    return {k: v for k, v in trace.snapshot()["counters"].items()
            if k.startswith(prefix)}


@pytest.fixture(scope="module")
def engine_runs():
    """The engines at one and four entries, tracing off and on, with the
    plain assembly standing in for K2's launch: (outputs, the launch
    counter's count, the parallel.* counters) by (n_dev, traced)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(pmod, "MAXB", 16)
    mp.setattr(pmod, "modification_table_from_tables",
               _launch_standing_in_for_k2(
                   pmod.modification_table_from_tables))
    torch.set_num_threads(2)
    out = {}
    try:
        for n_dev in (1, 4):
            for traced in (False, True):
                trace.reset()
                if traced:
                    trace.enable()
                try:
                    res = _engines(n_dev)
                finally:
                    trace.disable()
                out[n_dev, traced] = (
                    res, pmod.ASSEMBLY_LAUNCHES.count,
                    dict(pmod.ASSEMBLY_LAUNCHES.entries),
                    _snapshot_counters("parallel."), trace.snapshot()["spans"])
    finally:
        trace.reset()
        mp.undo()
    return out


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("traced", [False, True], ids=["off", "on"])
def test_four_entries_give_the_bits_of_one(engine_runs, traced):
    want = engine_runs[1, False][0]
    assert want["tab"].shape == (N_PAIRS, 151, pmod.NUM_EDIT)
    _equal(engine_runs[4, traced][0], want)
    _equal(engine_runs[1, traced][0], want)


def test_launches_by_entry_sum_to_the_launches_made(engine_runs):
    """Five slices a call, three calls: K2's stand-in launches 15 times
    on either set; on four entries entry 0 takes slices 0 and 4."""
    for n_dev in (1, 4):
        _res, n, entries, counters, _spans = engine_runs[n_dev, True]
        assert n == 15
        by_entry = {int(k.rsplit(".", 1)[1]): v for k, v in counters.items()
                    if k.startswith("parallel.launches.")}
        assert by_entry == entries
        assert sum(by_entry.values()) == n
    assert engine_runs[4, True][2] == {0: 6, 1: 3, 2: 3, 3: 3}
    assert engine_runs[1, True][2] == {0: 15}


def test_launches_by_entry_count_only_while_tracing():
    launches = cuda_build.Launches("test_by_entry")
    try:
        trace.reset()
        for i in (0, 2, 2, 3):
            with ppar.on_entry(i, "cpu"):
                launches.add((1,))
        launches.add((1,))
        assert launches.count == 5
        assert not _snapshot_counters("parallel.")
        trace.enable()
        try:
            for i in (0, 2, 2, 3):
                with ppar.on_entry(i, "cpu"):
                    launches.add((1,))
            launches.add((1,))
        finally:
            trace.disable()
        assert _snapshot_counters("parallel.launches.") == {
            "parallel.launches.0": 2, "parallel.launches.2": 2,
            "parallel.launches.3": 1}
        assert launches.entries == {0: 4, 2: 4, 3: 2}
    finally:
        launches.reset()
        trace.reset()


def test_merge_bytes_count_by_entry(engine_runs):
    assert engine_runs[1, True][3]["parallel.merge_bytes"] == 0
    four = engine_runs[4, True][3]["parallel.merge_bytes"]
    assert four > 0
    assert "parallel.merge" in engine_runs[4, True][4]
    assert "parallel.merge" in engine_runs[1, True][4]


@pytest.mark.parametrize("n_dev", [1, 4])
def test_merge_bytes_of_gather_and_kmer_hist(n_dev):
    """Exact counts: the gather takes shards 1..n-1 whole, the k-mer
    histogram one (n_bins,) int64 histogram from each of them."""
    rows = torch.arange(10 * 3, dtype=torch.float32).reshape(10, 3)
    trace.reset()
    trace.enable()
    try:
        with runtime.use_devices(["cpu"] * n_dev):
            shards, = ppar.shard_leading(None, rows)
            assert torch.equal(ppar.gather(shards, "cpu"), rows)
            gathered = trace.snapshot()["counters"].get(
                "parallel.merge_bytes", 0)
            hist = ppar.make_sharded_kmer_hist(64)(np.arange(500) * 7)
        total = trace.snapshot()["counters"].get("parallel.merge_bytes", 0)
    finally:
        trace.disable()
        trace.reset()
    assert torch.equal(hist, torch.bincount(
        torch.as_tensor(np.arange(500) * 7 % 64), minlength=64))
    assert gathered == 4 * 3 * sum(len(s) for s in shards[1:])
    assert total - gathered == 64 * 8 * (n_dev - 1)


def test_tracing_off_records_nothing_of_the_set(engine_runs):
    for n_dev in (1, 4):
        _res, n_off, entries_off, counters, spans = engine_runs[n_dev, False]
        assert counters == {} and spans == {}
        _res, n_on, entries_on, _c, _s = engine_runs[n_dev, True]
        assert (n_off, entries_off) == (n_on, entries_on)


@pytest.fixture(scope="module")
def four_entry_ranges():
    """A tiny ``local_clustering`` and a tiny encode on ["cpu"] * 4 under
    the profiler: the host ranges of the program's spans."""
    from jtk_tpu_torch.stages.encode import encode
    torch.set_num_threads(2)
    with runtime.use_device("cpu"):
        base = encoded_dataset()
        with runtime.use_devices(["cpu"] * 4):
            trace.reset()
            _, phase = profiled(lambda: cluster(copy.deepcopy(base)))
            trace.reset()
            ds = copy.deepcopy(base)
            ds.encoded_reads = []
            _, enc = profiled(lambda: encode(ds, margin=100))
    trace.reset()
    return phase + enc


@pytest.mark.parametrize("parent", ["modtable.assembly",
                                    "clustering.features.gather",
                                    "mapper.k3"])
def test_merge_lies_inside_its_parent_spans(four_entry_ranges, parent):
    """Merges nest in the spans that held them before: each merge lies in
    one of them, and each of them holds some merge."""
    ranges = four_entry_ranges
    merges = [r for r in ranges if r[0] == ppar.MERGE]
    assert merges
    assert inside(ranges, ppar.MERGE, parent)
    held = {(a, b) for p in ("modtable.assembly",
                             "clustering.features.gather", "mapper.k3",
                             "polish")
            for a, b in inside(ranges, ppar.MERGE, p)}
    assert held == {(a, b) for _n, a, b in merges}


class _Recorder:
    def __init__(self):
        self.synced = []

    def __call__(self, dev=None):
        self.synced.append(torch.device(dev))


@pytest.mark.parametrize("n_dev", [1, 4])
def test_a_device_span_in_a_shard_waits_for_its_device(monkeypatch, n_dev):
    """With a stand-in synchronize and a set of n_dev cards: a device
    span inside ``on_entry(i, card i)`` synchronizes that card alone, and
    outside any shard every device of the set; a host span none."""
    cards = [torch.device("cuda", i) for i in range(n_dev)]
    rec = _Recorder()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", rec)
    monkeypatch.setattr(runtime, "devices", lambda: list(cards))
    trace.reset()
    trace.enable()
    try:
        with trace.span("test.outside", device=True):
            pass
        assert rec.synced == cards
        for i in range(n_dev):
            rec.synced.clear()
            with ppar.on_entry(i, cards[i]):
                with trace.span("test.shard", device=True):
                    pass
                with trace.span("test.host"):
                    pass
            assert rec.synced == [cards[i]]
        rec.synced.clear()
        with trace.span("test.outside", device=True):
            pass
        assert rec.synced == cards
    finally:
        trace.disable()
        trace.reset()
