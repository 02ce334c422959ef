"""Readings that set and test a cell's limits, at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seed <n> --seconds <s> \
        [--faults <name>,...] [--busy 1]

One set-up, then a window of sound jobs and its check (the lower
readings), then the control: the reference, in the types below the
program's, put in the program's place on the same outputs (the features
from a bfloat16 forward, the CIGARs from int8 cells, the chains' scores
from a bfloat16 objective).  Then, for each fault named (``faults.py``),
a window with that fault planted in the timed path and its check.  Each
scenario's numbers go through the same test as a run's, and are printed
with its ``correct``; the last line is JSON, whose ``correct`` is the
control's, with every scenario under ``scenarios``.

``--busy 1`` instead profiles every job of one window and prints each
job's seconds beside the device's busy seconds in it.

The benchmark's own runs (``run.py``) never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import faults
import run


def scenario(name, checks, out):
    correct = all(v <= lim for _n, v, lim in checks)
    print(f"# {name}: correct {correct} "
          f"{json.dumps({n: v for n, v, _l in checks})}", flush=True)
    run.print_checks([(f"{name}.{n}", v, lim) for n, v, lim in checks])
    out[name] = {"correct": correct,
                 "checks": {n: {"value": v, "limit": lim}
                            for n, v, lim in checks}}
    return correct


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--busy", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    args.root = run.ROOT
    return readings(args)


def readings(args, devs=None) -> int:
    cell = run.open_cell(args, devs)
    if cell is None:
        return 2
    from jtk_tpu_torch.runtime import use_devices
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    kind = cell.workload["job"]
    out = {}
    with use_devices(cell.devs):
        job = run.set_up(cell, args.seed, log)
        win = run.Window(cell, job, args.seconds,
                         profile_all=bool(args.busy))
        win.record_lines()
        print(f"# card {run.card_line()}", flush=True)
        scenario("sound", job.check(), out)
        if args.busy:
            print(json.dumps({"correct": out["sound"]["correct"],
                              "rate": win.rate(), "times": win.times,
                              "busy": win.busy}), flush=True)
            job.release()
            return 0
        control = scenario("control", job.check(control=True), out)
        first = win.next
        for name in filter(None, args.faults.split(",")):
            job.uninstall()
            with faults.planted(kind, name):
                job.install()
                job.reset()
                fw = run.Window(cell, job, args.seconds, first=first)
                job.uninstall()
            job.install()
            first = fw.next
            print(f"# fault {name}: jobs {len(fw.times)} units {fw.units}",
                  flush=True)
            scenario(f"fault.{name}", job.check(), out)
        job.release()
    found = run.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps({"correct": control, "scenarios": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
