"""``correct`` comes out false where it should: the control (the
reference in the types below the program's, in its place) reads above
every limit it is held to, and each fault of the timed path that a cell
can have (``faults.py``) turns ``correct`` false.  Driven on the CPU at a
tiny size (the tiny phase runs take minutes: the port's plain
versions)."""

import contextlib
import io
import json
import types

import pytest

import benchutil
import control
import faults


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return benchutil.tiny_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell", ["tiny.encode", "tiny.phase"])
def test_sound_runs_are_correct_and_the_control_is_not(root, cell):
    args = types.SimpleNamespace(workload=cell, seed=2**31 + 78,
                                 seconds=0.1, faults="", busy=0, root=root)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = control.readings(args, devs=["cpu"])
    assert rc == 0, err.getvalue()[-3000:]
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    sc = res["scenarios"]
    assert sc["sound"]["correct"], sc["sound"]
    assert not res["correct"] and not sc["control"]["correct"]
    for name, c in sc["control"]["checks"].items():
        assert c["value"] > c["limit"], (name, c)


FAULTS = [(f"tiny.{kind}", name) for kind, names in faults.FAULTS.items()
          for name in names]


@pytest.mark.parametrize("cell, fault", FAULTS,
                         ids=[f"{c}-{f}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(root, cell, fault):
    with faults.planted(cell.split(".")[1], fault):
        rc, res, err = benchutil.drive(root, cell)
    assert rc == 0, err[-3000:]
    assert not res["correct"], res["checks"]
