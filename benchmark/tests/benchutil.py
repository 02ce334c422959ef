"""A small copy of the benchmark for tests on the CPU: the harness's files
with two cells of a tiny diploid region, and a driver of one run."""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import types

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

TINY = {"genome": {"kind": "diploid", "length": 20000, "het": 0.004,
                   "chunks": 8},
        "reads": {"coverage": 20, "mean_len": 15000, "error": 0.05,
                  "min_len": 500},
        "phase_chunks_per_call": 4, "encode_reads_per_call": 12}


def tiny_root(tmp, extra_cells=()):
    """A checkout-like directory: ``BENCHMARK.json`` with the cells
    ``tiny.phase`` and ``tiny.encode`` (and ``extra_cells``, entries of
    its workloads) and a copy of this directory."""
    shutil.copytree(HERE, os.path.join(tmp, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(HERE, "configs", "diploid1m_ont60.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY, name="tiny")
    with open(os.path.join(tmp, "benchmark", "configs", "tiny.json"),
              "w") as f:
        json.dump(cfg, f)
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    for kind in ("phase", "encode"):
        with open(os.path.join(HERE, "workloads",
                               f"diploid1m_ont60.{kind}.json")) as f:
            wl = json.load(f)
        if kind == "encode":
            wl.update(warmup_reads=6, sample_per_job=6)
        with open(os.path.join(tmp, "benchmark", "workloads",
                               f"tiny.{kind}.json"), "w") as f:
            json.dump(wl, f)
        name = f"tiny.{kind}"
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": kind, "chips": 1,
                                   "why": "a test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if f"diploid1m_ont60.{kind}" in m.get("workloads", []):
                m["workloads"].append(name)
    bench["workloads"].extend(extra_cells)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp


def drive(root, cell, seed=2**31 + 77, seconds=0.1, trace=0):
    """One run of ``cell`` on the CPU: (exit code, result or None, stderr
    text)."""
    import run
    args = types.SimpleNamespace(workload=cell, seed=seed, seconds=seconds,
                                 trace=trace, root=root)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.run(args, devs=["cpu"])
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result, err.getvalue()
