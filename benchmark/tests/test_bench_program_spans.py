"""The per-layer metrics read from the program's own spans and counters
(``program_trace.py``, ``jtk_tpu_torch.trace``) come on a traced run's
line, each positive, with no wrapper of the benchmark's behind them; an
untraced run's line carries the end-to-end metrics alone.  Driven on the
CPU at a tiny size (the tiny phase runs take minutes)."""

import json
import os

import pytest

import benchutil

RATES = {"tiny.encode": "reads_encoded_per_s",
         "tiny.phase": "chunks_clustered_per_s"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return benchutil.tiny_root(str(tmp_path_factory.mktemp("bench")))


def program_metrics(root, cell):
    """The cell's per-layer metrics whose readers use ``program_trace``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    out = []
    for m in bench["per_layer"]:
        if cell not in m.get("workloads", [cell]):
            continue
        with open(os.path.join(root, "benchmark", "metrics",
                               f"{m['name']}.py")) as f:
            if "program_trace" in f.read():
                out.append(m["name"])
    return out


@pytest.mark.parametrize("cell", sorted(RATES))
def test_program_span_metrics_are_on_the_traced_line(root, cell):
    names = program_metrics(root, cell)
    assert len(names) == (3 if cell == "tiny.encode" else 7)
    rc, res, err = benchutil.drive(root, cell, trace=1)
    assert rc == 0, err[-3000:]
    for name in names:
        assert res["metrics"][name]["value"] > 0, name
    rc, res, err = benchutil.drive(root, cell, trace=0)
    assert rc == 0, err[-3000:]
    assert set(res["metrics"]) == {RATES[cell], "setup_s"}
