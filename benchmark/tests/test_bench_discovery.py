"""A cell, a configuration and a per-layer metric are added by files
alone: the harness finds each by its name."""

import json
import os

import benchutil
import run


def test_cells_of_the_benchmark_resolve():
    bench = run.load_json(os.path.join(benchutil.ROOT, "BENCHMARK.json"))
    for w in bench["workloads"]:
        cell = run.Cell(w["name"])
        assert os.path.exists(cell.job_path)
        assert cell.workload["rate_metric"] in {
            m["name"] for m in cell.end_to_end}
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert cell.per_layer
        for path in cell.metric_paths.values():
            assert os.path.exists(path)


def test_a_cell_and_a_metric_added_as_files_run(tmp_path):
    root = benchutil.tiny_root(str(tmp_path))
    # a new per-layer metric: its reader and its BENCHMARK.json entry
    with open(os.path.join(root, "benchmark", "metrics",
                           "mapper.total_ms_per_read.py"), "w") as f:
        f.write('SPANS = {"mapper.all": '
                '"jtk_tpu_torch.stages.encode:encode"}\n\n\n'
                'def read(ctx):\n'
                '    s = ctx.span_s("mapper.all")\n'
                '    return None if s is None else 1e3 * s / ctx.units\n')
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "mapper.total_ms_per_read", "unit": "ms/read",
        "better": "lower", "source": "program_span", "layer": "mapper",
        "moves": "reads_encoded_per_s", "workloads": ["tiny.encode"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    rc, res, err = benchutil.drive(root, "tiny.encode", trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"], err[-3000:]
    assert res["metrics"]["mapper.total_ms_per_read"]["value"] > 0
    assert "mapper.vote_ms_per_read" in res["metrics"]
    assert res["device"]["window_s"] > 0
    rc, res, err = benchutil.drive(root, "tiny.encode", trace=0)
    assert rc == 0 and res["correct"], err[-3000:]
    assert set(res["metrics"]) == {"reads_encoded_per_s", "setup_s"}
    assert list(res)[-1] == "checks"


def test_an_unknown_cell_exits_without_a_result(tmp_path):
    root = benchutil.tiny_root(str(tmp_path))
    import pytest
    with pytest.raises(KeyError):
        run.Cell("no.such.cell", root)
