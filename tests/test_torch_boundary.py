"""The port's boundary: ``analyzer_tpu_torch`` and ``chip_smoke.py`` stand
alone — no ``jax`` (nor ``optax`` or ``flax``, which need it), nothing of
``analyzer_tpu`` — and entry points never drop quietly from the card to
the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from analyzer_tpu_torch.core.state import PlayerState
from analyzer_tpu_torch.device import resolve_device

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_REPO, "analyzer_tpu_torch")


def _port_files():
    out = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(_PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


_FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "analyzer_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in _FORBIDDEN


def test_import_leaves_jax_and_reference_out():
    """Importing every module of the port loads neither jax nor any
    analyzer_tpu module (template: tests/test_lint_clean.py)."""
    probe = (
        "import importlib, pkgutil, sys\n"
        "import analyzer_tpu_torch\n"
        "for m in pkgutil.walk_packages(analyzer_tpu_torch.__path__, "
        "'analyzer_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{_FORBIDDEN!r})\n"
        "assert not leaked, leaked\n"
        "for name in ('sched.runner', 'cli', '__main__', 'io.checkpoint',\n"
        "             'io.csv_codec', 'experiments.scatter_floor',\n"
        "             'kernels.row_scatter', 'rater', 'logging_utils',\n"
        "             'sched.tier', 'serve', 'serve.view', 'serve.engine',\n"
        "             'serve.oracle', 'serve.server', 'obs', 'obs.registry',\n"
        "             'obs.tracer', 'obs.httpd', 'fixtures', 'io.dbgen',\n"
        "             'service', 'service.store', 'service.broker',\n"
        "             'service.sql_store', 'service._native_sql',\n"
        "             'service.encode', 'service.columnar',\n"
        "             'service.worker', 'service.pipeline',\n"
        "             'experiments.service_bench', 'bench', 'ops.oracle',\n"
        "             'io.ingest', 'io._native_csv', 'models', 'models.elo',\n"
        "             'models.features', 'models.training', 'models.logistic',\n"
        "             'models.mlp', 'models.calibration', 'obs.quality',\n"
        "             'migrate', 'migrate.assign', 'migrate.engine',\n"
        "             'migrate.lineage', 'migrate.progress', 'loadgen',\n"
        "             'loadgen.driver', 'loadgen.matchmaker',\n"
        "             'loadgen.outcomes', 'loadgen.shaper',\n"
        "             'utils.ownership'):\n"
        "    assert 'analyzer_tpu_torch.' + name in sys.modules, name\n"
        # importing builds nothing, starts no thread and parses no argv
        "import threading\n"
        "from analyzer_tpu_torch.kernels import fused_window, row_scatter\n"
        "from analyzer_tpu_torch.sched import _native\n"
        "from analyzer_tpu_torch.service import _native_sql\n"
        "from analyzer_tpu_torch.io import _native_csv\n"
        "assert fused_window._lib is None and row_scatter._lib is None\n"
        "assert _native._lib is None and _native_sql._lib is None\n"
        "assert _native_csv._lib is None\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", probe],
        capture_output=True, text=True, timeout=120, cwd=_REPO,
    )
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, _REPO)
)
def test_no_jax_or_reference_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        PlayerState.create(4)  # device=None means the card
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_without_card_fails_without_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; chip_smoke.py would run")
    proc = subprocess.run(
        [sys.executable, os.path.join(_REPO, "chip_smoke.py")],
        capture_output=True, text=True, timeout=120, cwd=_REPO,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
