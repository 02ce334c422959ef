"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its job and its per-layer metrics are found
by name: ``BENCHMARK.json`` at the checkout's root lists them, and each
lives in a file of its own under this directory (``workloads/<cell>.json``,
the configuration's ``file``, ``jobs/<kind>.py``,
``metrics/<metric>.py``).  Set-up (simulating the region and its reads
from the seed, building the job inputs, loading the kernels, one warm-up
job) is timed as ``setup_s``; then whole jobs run back to back until
``--seconds`` have passed, each timed from its start to a synchronize at
its end, and the cell's rate is all their work over the sum of their
times.  With ``--trace 1`` the spans and launch records that the cell's
per-layer metrics name are installed and one job of the window runs under
``torch.profiler``; the line then carries the per-layer metrics.  After
the window the outputs are held against the plain reference, and
``correct`` says whether every number compared kept within its limit.

The last line of standard output is the result, as JSON; the numbers
compared, each beside its limit, are also the last lines of standard
error.  Exits 2 without a result where the card, the cell or the program
is missing, and 3 where a forbidden module is loaded.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "jtk_tpu")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell as ``BENCHMARK.json`` and its own files describe it."""

    def __init__(self, name: str, root: str = ROOT):
        bench_dir = os.path.join(root, "benchmark")
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        entry = [w for w in self.bench["workloads"] if w["name"] == name]
        if not entry:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entry[0]
        self.chips = int(self.entry["chips"])
        self.workload = load_json(os.path.join(bench_dir, "workloads",
                                               f"{name}.json"))
        conf = [c for c in self.bench["configs"]
                if c["name"] == self.entry["config"]][0]
        self.config = load_json(os.path.join(root, conf["file"]))
        self.job_path = os.path.join(bench_dir, "jobs",
                                     f"{self.workload['job']}.py")
        self.end_to_end = [m for m in self.bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in self.bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.metric_paths = {m["name"]: os.path.join(
            bench_dir, "metrics", f"{m['name']}.py") for m in self.per_layer}


def forbidden_loaded() -> list[str]:
    """Top-level names of loaded modules that the port must not load,
    compared whole (``jtk_tpu_torch`` is not ``jtk_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().replace("\n", "; ") or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def spread(values):
    """(median, first and third quartile) as Python's statistics gives
    them."""
    if len(values) < 2:
        v = values[0] if values else float("nan")
        return v, v, v
    q = statistics.quantiles(values, n=4)
    return statistics.median(values), q[0], q[2]


def launch_counts():
    from jtk_tpu_torch.ops import cluster, edit_dp, phmm_grad, phmm_lk
    from jtk_tpu_torch.ops import phmm_tables
    return {c.name: c.count for c in (
        edit_dp.LAUNCHES, edit_dp.TB_LAUNCHES, phmm_tables.FWD_LAUNCHES,
        phmm_tables.BWD_LAUNCHES, phmm_lk.LAUNCHES, phmm_grad.LAUNCHES,
        cluster.CHAIN_LAUNCHES)}


class Context:
    """What a per-layer metric's reader reads: spans (seconds by name) and
    launches by kernel over the window, its work units, and of the
    profiled job the kernels' seconds by name, the launches' least
    seconds by family (:mod:`roofline`), busy and window seconds."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def span_s(self, name: str) -> float | None:
        v = self.spans.get(name)
        return sum(v) if v else None

    def kernel_s(self, *substrings) -> float:
        return sum(s for n, s in self.kernels.items()
                   if any(x in n for x in substrings))


def traced_metrics(cell, readers, tracer, profiled, launches, units):
    """The per-layer metrics of a traced run, the device's busy and window
    seconds in the profiled job, and the breakdown: the device operations
    that took most time and the idle time by the host's span."""
    from tracing import busy_and_gaps, device_intervals, kernel_seconds
    prof, n_prof, dt_prof = profiled
    dev, host = device_intervals(prof, set(tracer.spans) | {"job"})
    jobs = [h for h in host if h[2] == "job"]
    t0, t1 = (jobs[0][0], jobs[0][1]) if jobs else (
        min(a for a, _b, _n in dev), max(b for _a, b, _n in dev))
    busy, gaps = busy_and_gaps(dev, host, t0, t1)
    kern = kernel_seconds(dev)
    window_s = (t1 - t0) / 1e9
    ctx = Context(spans=dict(tracer.spans), launches=launches, kernels=kern,
                  least=dict(tracer.least), units=units, busy_s=busy,
                  window_s=window_s)
    metrics = {}
    for m in cell.per_layer:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    print(f"# traced job: {n_prof} units in {dt_prof:.3f} s, device busy "
          f"{busy:.3f} s of {window_s:.3f} s")
    top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return (metrics, {"busy_s": busy, "window_s": window_s},
            {"device_ops": top(kern), "idle_gaps": top(gaps)})


def open_cell(args, devs=None):
    """The cell, its cards (``devs`` replaces the look for cards: the
    tests drive a run on the CPU so) and its per-layer readers; None, with
    the reason on standard error, where a card or the program is
    missing."""
    cell = Cell(args.workload, args.root)
    import torch
    if devs is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"cell {cell.name} needs {cell.chips} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return None
        devs = [f"cuda:{i}" for i in range(cell.chips)]
    sys.path.insert(0, ROOT)
    try:
        import jtk_tpu_torch.runtime  # noqa: F401
    except ImportError as e:
        print(f"the program is missing: {e}", file=sys.stderr)
        return None
    cell.devs = devs
    cell.on_card = devs[0].startswith("cuda")
    cell.cards = range(cell.chips) if cell.on_card else range(0)
    cell.sync = torch.cuda.synchronize if cell.on_card else (lambda: None)
    cell.readers = {n: load_module(p, f"bench_metric_{i}")
                    for i, (n, p) in enumerate(cell.metric_paths.items())}
    return cell


def set_up(cell, seed: int, log):
    """The cell's job, built and warmed up from ``seed``."""
    import torch
    job_mod = load_module(cell.job_path, f"bench_job_{cell.workload['job']}")
    for i in cell.cards:
        torch.empty(0, device=f"cuda:{i}")      # the card's context
        torch.cuda.reset_peak_memory_stats(i)
    job = job_mod.Job(cell.config, cell.workload, seed, log)
    cell.sync()
    # the collection that set-up's objects are due, here rather than in
    # the window's first job
    gc.collect()
    return job


class Window:
    """Whole jobs back to back until ``seconds`` have passed, from job
    ``first``: each job's seconds (its start to a synchronize at its end)
    and units, the launches over the window, and with a ``tracer`` the
    first job under ``torch.profiler``; ``profile_all`` profiles every
    job instead and keeps each one's device-busy seconds."""

    def __init__(self, cell, job, seconds: float, tracer=None, first=0,
                 profile_all: bool = False):
        import torch
        before = launch_counts()
        self.times, self.units, self.busy = [], [], []
        self.profiled = None
        t_win = time.perf_counter()
        i = first
        while time.perf_counter() - t_win < seconds:
            job.before(i)
            prof = None
            if profile_all or (tracer is not None and i == first):
                acts = [torch.profiler.ProfilerActivity.CPU]
                if cell.on_card:
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.__enter__()
                if tracer is not None:
                    tracer.recording = True
            t0 = time.perf_counter()
            if prof is not None:
                with torch.profiler.record_function("job"):
                    n = job.run(i)
                    cell.sync()
            else:
                n = job.run(i)
                cell.sync()
            dt = time.perf_counter() - t0
            if prof is not None:
                if tracer is not None:
                    tracer.recording = False
                prof.__exit__(None, None, None)
                if profile_all:
                    self.busy.append(job_busy_s(prof))
                else:
                    self.profiled = (prof, n, dt)
            self.times.append(dt)
            self.units.append(n)
            job.after(i)
            i += 1
        self.next = i
        self.seconds = time.perf_counter() - t_win
        self.launches = {k: v - before[k]
                         for k, v in launch_counts().items()}

    def rate(self) -> float:
        return sum(self.units) / sum(self.times)

    def record_lines(self):
        med, q1, q3 = spread(self.times)
        print(f"# jobs {len(self.times)} in {self.seconds:.3f} s; job "
              f"seconds median {med:.4f} quartiles {q1:.4f} {q3:.4f} min "
              f"{min(self.times):.4f} max {max(self.times):.4f}; units "
              f"{self.units}")
        print(f"# job seconds {json.dumps(self.times)}")
        if self.busy:
            print(f"# job device-busy seconds {json.dumps(self.busy)}")
        print(f"# launches over the window {json.dumps(self.launches)}")


def job_busy_s(prof) -> float:
    """Seconds in which the device ran something during the profiled
    job."""
    from tracing import busy_and_gaps, device_intervals
    dev, host = device_intervals(prof, {"job"})
    jobs = [h for h in host if h[2] == "job"]
    if not jobs:
        return 0.0
    return busy_and_gaps(dev, host, jobs[0][0], jobs[0][1])[0]


def peak_bytes(cell) -> int:
    import torch
    return max((torch.cuda.max_memory_allocated(i) for i in cell.cards),
               default=0)


def print_checks(checks):
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()


def run(args, devs=None) -> int:
    """One run of the cell: set-up, the window, the check."""
    t_start = time.perf_counter()
    cell = open_cell(args, devs)
    if cell is None:
        return 2
    import torch

    from jtk_tpu_torch.runtime import use_devices
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    tracer = None
    with use_devices(cell.devs):
        job = set_up(cell, args.seed, log)
        setup_s = time.perf_counter() - t_start
        if args.trace:
            from tracing import Tracer
            tracer = Tracer()
            for r in cell.readers.values():
                for name, spec in getattr(r, "SPANS", {}).items():
                    tracer.span(name, spec)
                for spec, least in getattr(r, "LAUNCHES", {}).items():
                    tracer.launches(spec, least)
        win = Window(cell, job, args.seconds, tracer)
        peak = peak_bytes(cell)
        if tracer is not None:
            tracer.close()
        job.release()
    found = forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    checks = job.check()
    correct = all(v <= lim for _n, v, lim in checks)

    win.record_lines()
    print(f"# peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    print(f"# card {card_line()}; set-up {setup_s:.3f} s")
    device = {"platform": "gpu" if cell.on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if cell.on_card
              else "cpu",
              "count": len(cell.devs), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(sum(win.units)),
              "failed": 0}
    metrics = {}
    if not args.trace:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] == cell.workload["rate_metric"]:
                metrics[m["name"]] = {"value": win.rate(),
                                      "unit": m["unit"]}
    else:
        metrics, extra, result["breakdown"] = traced_metrics(
            cell, cell.readers, tracer, win.profiled, win.launches,
            sum(win.units))
        device.update(extra)
    result["metrics"] = metrics
    result["device"] = device
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    print_checks(checks)
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    args.root = ROOT
    try:
        return run(args)
    except (KeyError, FileNotFoundError) as e:
        print(f"cannot run {args.workload}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
