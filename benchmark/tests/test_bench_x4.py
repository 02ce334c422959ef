"""The four-card phase cell on a set of four CPU entries: a tiny twin of
``diploid1m_ont60.phase.x4`` is ``correct`` with the check numbers of the
same tiny run on one entry, and its traced line carries the device set's
three metrics.  Driven on the CPU (the tiny phase runs take minutes)."""

import contextlib
import io
import json
import os
import shutil
import types

import pytest

import benchutil

X4 = "diploid1m_ont60.phase.x4"
TINY_X4 = "tiny.phase.x4"
NEW = ("parallel.merge_ms_per_chunk", "parallel.merge_mb_per_chunk",
       "parallel.secondary_launch_pct")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny checkout with ``tiny.phase.x4``: the x4 cell's workload
    file and entry on the tiny configuration, in every list the x4 cell
    is in."""
    tmp = str(tmp_path_factory.mktemp("bench"))
    root = benchutil.tiny_root(tmp, extra_cells=[{
        "name": TINY_X4, "config": "tiny_x4", "traffic": "phase",
        "chips": 4, "why": "a test"}])
    wl = os.path.join(root, "benchmark", "workloads")
    shutil.copy(os.path.join(wl, "tiny.phase.json"),
                os.path.join(wl, f"{TINY_X4}.json"))
    conf = os.path.join(root, "benchmark", "configs")
    shutil.copy(os.path.join(conf, "tiny.json"),
                os.path.join(conf, "tiny_x4.json"))
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_x4", "source": "a test",
                             "file": "benchmark/configs/tiny_x4.json",
                             "reduced": [], "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if X4 in m.get("workloads", []):
            m["workloads"].append(TINY_X4)
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


def drive(root, cell, devs, trace=0, seed=2**31 + 91):
    import run
    args = types.SimpleNamespace(workload=cell, seed=seed, seconds=0.1,
                                 trace=trace, root=root)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.run(args, devs=devs)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None), \
        err.getvalue()


def test_the_x4_cell_is_cell_one_on_four_cards():
    with open(os.path.join(benchutil.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, = [w for w in bench["workloads"] if w["name"] == X4]
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("diploid1m_ont60_x4", "phase", 4)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    confs = {c["name"]: c for c in bench["configs"]}
    x4c, one = confs["diploid1m_ont60_x4"], confs["diploid1m_ont60"]
    assert x4c["source"] != one["source"]
    assert x4c["reduced"] == one["reduced"]
    with open(os.path.join(benchutil.ROOT, x4c["file"])) as f:
        x4conf = json.load(f)
    with open(os.path.join(benchutil.ROOT, one["file"])) as f:
        oneconf = json.load(f)
    # the region, reads, HMM and cuts are cell 1's; the layout is its own
    text = ("name", "deployment", "source", "assumed", "devices")
    assert {k: v for k, v in x4conf.items() if k not in text} == \
        {k: v for k, v in oneconf.items() if k not in text}
    assert x4conf["devices"] == 4
    lists = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]
             if X4 in m.get("workloads", [])}
    assert lists == {"chunks_clustered_per_s", "device.idle_pct.phase",
                     "modtable.k1_ms_per_chunk",
                     "modtable.assembly_ms_per_chunk",
                     "kernel.k1_launches_per_chunk",
                     "polish.host_ms_per_chunk",
                     "clustering.features_host_ms_per_chunk", *NEW}
    with open(os.path.join(benchutil.HERE, "workloads", f"{X4}.json")) as f:
        x4 = json.load(f)
    with open(os.path.join(benchutil.HERE, "workloads",
                           "diploid1m_ont60.phase.json")) as f:
        assert x4 == json.load(f)


def test_four_entries_are_correct_with_the_checks_of_one(root):
    rc, one, err = drive(root, "tiny.phase", ["cpu"])
    assert rc == 0, err[-3000:]
    rc, four, err = drive(root, TINY_X4, ["cpu"] * 4)
    assert rc == 0, err[-3000:]
    assert four["correct"] and one["correct"], four["checks"]
    assert four["checks"] == one["checks"]
    assert four["device"]["count"] == 4
    assert set(four["metrics"]) == {"chunks_clustered_per_s", "setup_s"}


def test_the_traced_x4_line_carries_the_device_sets_metrics(root,
                                                             monkeypatch):
    """The plain assembly stands in for K2's one launch a slice, so that
    the CPU run has launches by entry to count.  The tiny calls fit one
    slice each, so every slice runs for entry 0: the bytes and the share
    read 0 here (tests/test_torch_parallel_trace.py holds both above 0 on
    calls of several slices)."""
    from jtk_tpu_torch.ops import modtable

    orig = modtable.modification_table_from_tables

    def assembly(q, offsets, *rest):
        out = orig(q, offsets, *rest)
        modtable.ASSEMBLY_LAUNCHES.add(tuple(q.shape))
        return out

    monkeypatch.setattr(modtable, "modification_table_from_tables",
                        assembly)
    rc, res, err = drive(root, TINY_X4, ["cpu"] * 4, trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"], res["checks"]
    got = {name: res["metrics"][name]["value"] for name in NEW}
    assert got["parallel.merge_ms_per_chunk"] > 0
    assert got["parallel.merge_mb_per_chunk"] >= 0
    assert 0 <= got["parallel.secondary_launch_pct"] < 100
