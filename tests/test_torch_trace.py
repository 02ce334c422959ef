"""The port's spans and counters (``jtk_tpu_torch.trace``) on the CPU: off
costs nothing and records nothing; on, under ``torch.profiler``, each span
is a range of the profiler's host timeline that agrees with the registry;
tracing changes no result and no launch; children fit in their parents;
the unit counters count the work of a call; and the benchmark's readers
of the program's spans read them."""

import copy
import functools
import importlib.util
import inspect
import os

import numpy as np
import pytest
import torch

from jtk_tpu_torch import seq as seqmod
from jtk_tpu_torch import trace
from jtk_tpu_torch.datamodel import Chunk
from jtk_tpu_torch.io import sim
from torch_util import port_on_cpu  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READERS = {
    "modtable.assembly_ms_per_chunk": "phase",
    "modtable.k1_ms_per_chunk": "phase",
    "polish.host_ms_per_chunk": "phase",
    "clustering.features_host_ms_per_chunk": "phase",
    "clustering.gather_ms_per_chunk": "phase",
    "clustering.refresh_ms_per_chunk": "phase",
    "clustering.pileups_ms_per_chunk": "phase",
    "mapper.extend_host_ms_per_read": "encode",
    "mapper.k3_ms_per_read": "encode",
    "encode.nodes_ms_per_read": "encode",
    "modtable.stats_host_mb_per_chunk": "phase",
}
SELECTION = {0, 1, 2}
CHILDREN = {
    "polish": ("polish.prep", "polish.edits", "modtable.k1",
               "modtable.assembly"),
    "clustering.features": ("clustering.features.prep",
                            "clustering.features.candidates",
                            "clustering.features.stats_copy",
                            "clustering.features.gather",
                            "clustering.features.pick", "modtable.k1",
                            "modtable.assembly"),
    "mapper.extend": ("mapper.windows", "mapper.k3", "mapper.decode"),
}


def launch_counts():
    """The always-on counters since the last reset: the kernels' launches
    and the modification table's calls by slices."""
    return {k: v for k, v in trace.snapshot()["counters"].items()
            if k.startswith(("launches.", "modtable.calls_by_"))}


def profiled(fn):
    """fn() under ``torch.profiler`` on the CPU: (its result, the host
    ranges [(name, start_ns, end_ns)] of the program's spans)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    names = set(trace.names())
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() in names]
    return out, ranges


def inside(ranges, child, parent):
    """The child's ranges that lie within one of the parent's."""
    outer = [(a, b) for n, a, b in ranges if n == parent]
    return [(a, b) for n, a, b in ranges if n == child
            and any(p <= a and b <= q for p, q in outer)]


def encoded_dataset():
    """25 reads of a 2.4 kb diploid region encoded against four 250 bp
    chunks of haplotype 1."""
    from jtk_tpu_torch.stages.encode import encode
    rng = np.random.default_rng(3)
    hap1 = sim.random_genome(rng, 2400)
    hap2 = hap1.copy()
    for p in rng.choice(np.arange(50, 2350), 40, replace=False):
        hap2[p] = (hap2[p] + 1 + rng.integers(0, 3)) % 4
    reads = sim.simulate_reads(rng, [hap1, hap2], coverage=8,
                               mean_len=1500, error=0.05)
    ds = sim.reads_to_dataset(reads)
    ds.selected_chunks = [Chunk(i, seqmod.decode(hap1[s:s + 250]).decode())
                          for i, s in enumerate(range(200, 2000, 450))]
    encode(ds, margin=100)
    return ds


def cluster(ds):
    """A tiny ``local_clustering`` of ``SELECTION`` (a short chain, and
    the gain calibration on 2 x 4 reads a cell instead of 40 x 32)."""
    import jtk_tpu_torch.stages.local_clustering as lc
    from jtk_tpu_torch.stages.likelihood_gains import estimate_gains
    mp = pytest.MonkeyPatch()
    mp.setattr(lc, "estimate_gains",
               functools.partial(estimate_gains, n_templates=2, n_reads=4))
    try:
        lc.local_clustering(ds, seed=5, flips_per_read=100, restarts=2,
                            selection=set(SELECTION))
    finally:
        mp.undo()
    return ds


@pytest.fixture(scope="module")
def runs():
    """Each tiny call with tracing off, then on: ``local_clustering``
    under the profiler, ``encode`` with :func:`trace.enable`."""
    from jtk_tpu_torch.runtime import use_device
    from jtk_tpu_torch.stages.encode import encode
    torch.set_num_threads(2)
    with use_device("cpu"):
        base = encoded_dataset()
        out = {}
        trace.reset()
        off = cluster(copy.deepcopy(base))
        out["phase_off"] = (off.dumps(), launch_counts())
        trace.reset()
        on, ranges = profiled(lambda: cluster(copy.deepcopy(base)))
        out["phase_on"] = (on.dumps(), launch_counts())
        out["phase_snap"], out["phase_ranges"] = trace.snapshot(), ranges
        for key, enable in (("encode_off", False), ("encode_on", True)):
            ds = copy.deepcopy(base)
            ds.encoded_reads = []
            trace.reset()
            if enable:
                trace.enable()
            try:
                encode(ds, margin=100)
            finally:
                trace.disable()
            out[key] = (ds.dumps(), launch_counts())
        out["encode_snap"] = trace.snapshot()
        out["n_reads"] = len(base.raw_reads)
        trace.reset()
        _, out["encode_ranges"] = profiled(
            lambda: encode(copy.deepcopy(base), margin=100))
        trace.reset()
        return out


def test_off_is_off(monkeypatch):
    """Off, no span or count reaches a profiler range (record_function or
    the op-scope range the spans use) or a synchronize, and the registry
    stays empty."""
    from jtk_tpu_torch.stages.encode import encode

    def boom(*_a, **_k):
        raise AssertionError("called while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(trace, "_RANGE", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    trace.reset()
    assert not trace.active()

    @trace.span("test.decorated", device=True)
    def f(x):
        return x + 1

    with trace.span("test.block", device=True):
        trace.count("test.units", 3)
    assert f(1) == 2
    assert trace.span("test.block") is trace.span("test.block")
    ds = encoded_dataset()
    ds.encoded_reads = []
    encode(ds, margin=100)
    snap = trace.snapshot()
    assert snap["spans"] == {}
    assert not [k for k in snap["counters"]
                if not k.startswith(("launches.", "modtable.calls_by_"))]
    assert trace.names() == []


def test_spans_lie_on_the_profilers_host_timeline():
    """Under the profiler, a tiny polish_many and encode put their spans
    on the kineto host timeline, nested in their parents, and each span's
    registry seconds agree with its ranges within 1 ms + 5 %."""
    from jtk_tpu_torch.ops.phmm import PHMMParams
    from jtk_tpu_torch.ops.polish import polish_many
    from jtk_tpu_torch.stages.encode import encode
    rng = np.random.default_rng(11)
    tpl = sim.random_genome(rng, 200)
    pile = [sim.noisy_read(rng, tpl, 0.05) for _ in range(6)]
    draft = np.concatenate([tpl[:90], tpl[91:]])
    ds = encoded_dataset()
    ds.encoded_reads = []
    trace.reset()

    def calls():
        polish_many([draft], [pile], PHMMParams.default(), W=128)
        encode(ds, margin=100)

    _, ranges = profiled(calls)
    spans = trace.snapshot()["spans"]
    for child, parent in (("polish.prep", "polish"),
                          ("modtable.k1", "polish"),
                          ("modtable.assembly", "polish"),
                          ("mapper.k3", "mapper.extend")):
        got = [r for r in ranges if r[0] == child]
        assert got, child
        assert len(inside(ranges, child, parent)) == len(got), child
    assert any(r[0] == "encode.nodes" for r in ranges)
    for name, (calls_n, sec) in spans.items():
        mine = [(a, b) for n, a, b in ranges if n == name]
        assert len(mine) == calls_n, name
        kin = sum(b - a for a, b in mine) / 1e9
        assert abs(kin - sec) <= 1e-3 + 0.05 * kin, (name, kin, sec)


def test_tracing_changes_no_result_and_no_launch(runs):
    assert runs["phase_on"] == runs["phase_off"]
    assert runs["encode_on"] == runs["encode_off"]


@pytest.mark.parametrize("parent", sorted(CHILDREN))
def test_children_fit_in_their_parent(runs, parent):
    ranges = runs["encode_ranges"] if parent.startswith("mapper") \
        else runs["phase_ranges"]
    whole = sum(b - a for n, a, b in ranges if n == parent)
    assert whole > 0
    parts = [iv for c in CHILDREN[parent]
             for iv in inside(ranges, c, parent)]
    assert parts
    assert sum(b - a for a, b in parts) <= whole


def test_unit_counters_count_the_calls_work(runs):
    assert runs["phase_snap"]["counters"]["clustering.chunks"] == \
        len(SELECTION)
    assert runs["encode_snap"]["counters"]["encode.reads"] == \
        runs["n_reads"]
    assert runs["phase_snap"]["counters"]["modtable.slices"] >= 1
    assert runs["phase_snap"]["counters"]["modtable.pairs"] >= 1


def load_reader(name):
    path = os.path.join(ROOT, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    import sys
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.join(ROOT, "benchmark"))
    return mod


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_the_programs_spans(runs, name, monkeypatch):
    """Each reader of the program's spans and counters gives a positive
    number from a registry that a tiny traced call filled, and None from
    an empty one; it declares no spans or launches of the benchmark's
    own."""
    reader = load_reader(name)
    assert not hasattr(reader, "SPANS") and not hasattr(reader, "LAUNCHES")
    trace.reset()
    assert reader.read(None) is None
    snap = runs[f"{READERS[name]}_snap"]
    monkeypatch.setattr(trace, "snapshot", lambda: snap)
    v = reader.read(None)
    assert v is not None and v > 0


def test_export_rows(tmp_path):
    trace.reset()
    trace.enable()
    try:
        with trace.span("test.outer"):
            with trace.span("test.outer"):
                trace.count("test.units", 2)
        trace.count("test.units")
    finally:
        trace.disable()
    path = tmp_path / "spans.tsv"
    trace.write(str(path))
    rows = [line.split("\t") for line in path.read_text().splitlines()]
    spans = [r for r in rows if r[0] == "span"]
    assert [r[:3] for r in spans] == [["span", "test.outer", "1"]]
    assert float(spans[0][3]) >= 0
    assert ["counter", "test.units", "3"] in rows
    trace.reset()


def test_traced_functions_keep_their_names_and_signatures():
    """The benchmark replaces these by module attribute: each keeps its
    module, name and signature under its span."""
    from jtk_tpu_torch import mapper
    from jtk_tpu_torch.ops import modtable, polish
    from jtk_tpu_torch.stages import local_clustering as lc
    for mod, name, first in (
            (polish, "polish_many", "templates"),
            (lc, "_variant_features_device", "per_chunk"),
            (lc, "cluster_chunks_mcmc", "features"),
            (mapper, "extend_candidates", "cands"),
            (modtable, "finish_gains", "tot_dev")):
        fn = getattr(mod, name)
        assert fn.__name__ == name and fn.__module__ == mod.__name__
        assert next(iter(inspect.signature(fn).parameters)) == first
    for meth in ("__init__", "candidates_batch"):
        fn = mapper.ChunkIndex.__dict__[meth]
        assert fn.__name__ == meth
        assert list(inspect.signature(fn).parameters)[:2][0] == "self"
