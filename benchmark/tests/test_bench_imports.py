"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: module names compared whole by
their top-level name (``jtk_tpu_torch`` is not ``jtk_tpu``)."""

import ast
import os
import subprocess
import sys

import benchutil

FORBIDDEN = {"jax", "jaxlib", "flax", "jtk_tpu"}
PROGRAM = "jtk_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    base = os.path.join(benchutil.HERE, sub)
    for d, _dirs, files in os.walk(base):
        if "tests" in d.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for sub in ("reference",):
        for path in _sources(sub):
            assert PROGRAM not in set(_imports(path)), path
    for name in ("sim.py", "roofline.py", "truth.py"):
        assert PROGRAM not in set(_imports(
            os.path.join(benchutil.HERE, name))), name


def test_top_level_names_compare_whole():
    code = (
        "import sys, types; sys.path.insert(0, %r); import run\n"
        "import jtk_tpu_torch.stages.local_clustering, "
        "jtk_tpu_torch.stages.encode\n"
        "assert run.forbidden_loaded() == [], run.forbidden_loaded()\n"
        "sys.modules['jtk_tpu_torchx'] = types.ModuleType('x')\n"
        "assert run.forbidden_loaded() == []\n"
        "sys.modules['jtk_tpu.ops'] = types.ModuleType('y')\n"
        "assert run.forbidden_loaded() == ['jtk_tpu']\n" % benchutil.HERE)
    env = dict(os.environ, PYTHONPATH=benchutil.ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=benchutil.ROOT, timeout=300)
