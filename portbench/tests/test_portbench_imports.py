"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name (``analyzer_tpu_torch`` begins with
``analyzer_tpu`` and is the program), and the plain references import
nothing of the program."""

import ast
import json
import os
import subprocess
import sys

import pytest

from _tiny import ROOT, SECONDS, TINY, spec_for
from portbench import run

PKG = os.path.join(ROOT, "portbench")
#: Files of the yardstick that may not import the program.
INDEPENDENT = ("plain.py", "gen.py", "dbfixture.py", "roofline.py", "trace.py",
               "host.py")


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _top_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, PKG))
def test_no_source_imports_jax(path):
    assert not set(_top_imports(path)) & set(run.FORBIDDEN)


@pytest.mark.parametrize("name", INDEPENDENT)
def test_references_import_nothing_of_the_program(name):
    assert "analyzer_tpu_torch" not in set(_top_imports(os.path.join(PKG, name)))


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("analyzer_tpu_torch_probe", sys)
    try:
        assert "analyzer_tpu_torch_probe" not in run.forbidden_modules()
    finally:
        del sys.modules["analyzer_tpu_torch_probe"]


@pytest.mark.parametrize("workload", sorted(TINY))
def test_a_run_loads_no_jax(workload):
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from portbench import run\n"
        "sys.path.insert(0, %r)\n"
        "from _tiny import spec_for\n"
        "out = run.run_cell(%r, 3, %r, True, device='cpu', overrides=%r, t_start=0.0,"
        " spec=spec_for(%r))\n"
        "mods = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'correct': out['correct'], 'mods': mods}))\n"
    ) % (ROOT, os.path.dirname(os.path.abspath(__file__)), workload, SECONDS,
         TINY[workload], workload)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert "analyzer_tpu_torch" in got["mods"]
    assert not set(got["mods"]) & set(run.FORBIDDEN)
