"""graftlint over the port: the port's lint surface (there is no port ``cli lint``).

The linter (``analyzer_tpu.lint``) reads source and imports no jax, so the
test imports it from the JAX package, as only tests may. Its path-scoped
rules key on the literal prefix ``analyzer_tpu/`` and its ABI family pairs
a ctypes loader with the one ``.cc`` it names, next to the module. So the
test copies ``analyzer_tpu_torch/`` into a temporary tree named
``analyzer_tpu/``, with each loader's native sources beside it, and lints
that copy in project mode: every rule family sees the port where it sees
the JAX package's modules.

GL030 (a metric literal outside the pre-declared schema) reads its
catalogs from ``analyzer_tpu.obs.registry``: JAX's schema, which does not
declare the port's own ``sql.native_*`` counters. The port's literals are
judged here against the port's schema (``analyzer_tpu_torch/obs/
registry.py``), swapped in for the run, and the names stay as they are.

The ABI family checks each loader against its own library's source: the
``.cc`` loaders through the linter's own pairing, the two ``.cu`` loaders
(which the pairing does not discover) through ``abi.loader_declarations``
and ``abi.parse_extern_c`` below.
"""

from __future__ import annotations

import ast
import os
import shutil

import pytest

import analyzer_tpu.obs.registry as jax_registry
import analyzer_tpu_torch.obs.registry as port_registry
from analyzer_tpu.lint import abi
from analyzer_tpu.lint.runner import lint_paths

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT = os.path.join(_REPO, "analyzer_tpu_torch")

#: The schema catalogs GL030 resolves literal names against.
_CATALOGS = ("SPAN_CATALOG", "STANDARD_COUNTERS", "STANDARD_GAUGES",
             "STANDARD_HISTOGRAMS")

#: Every ctypes loader of the port -> the native source of its library.
LOADERS = {
    "sched/_native.py": "sched/csrc/packer.cc",
    "service/_native_sql.py": "service/csrc/fastsql.cc",
    "io/_native_csv.py": "io/csrc/fastcsv.cc",
    "serve/_native_json.py": "serve/csrc/fastjson.cc",
    "kernels/fused_window_host.py": "kernels/csrc/fused_window_host.cc",
    "kernels/fused_window.py": "kernels/csrc/fused_window.cu",
    "kernels/row_scatter.py": "kernels/csrc/row_scatter.cu",
}


def _relabelled_copy(root: str) -> str:
    dst = os.path.join(root, "analyzer_tpu")
    shutil.copytree(_PORT, dst, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    for loader, source in LOADERS.items():
        shutil.copy(os.path.join(dst, source),
                    os.path.join(dst, os.path.dirname(loader)))
    return dst


@pytest.fixture(scope="module")
def linted(tmp_path_factory):
    """(copy root, findings, errors) of one project-mode run."""
    dst = _relabelled_copy(str(tmp_path_factory.mktemp("lint")))
    saved = {n: getattr(jax_registry, n) for n in _CATALOGS}
    try:
        for n in _CATALOGS:
            setattr(jax_registry, n, getattr(port_registry, n))
        findings, errors = lint_paths([dst], project=True)
    finally:
        for n, v in saved.items():
            setattr(jax_registry, n, v)
    return dst, findings, errors


def test_port_is_lint_clean_in_project_mode(linted):
    dst, findings, errors = linted
    assert errors == []
    assert findings == [], "\n" + "\n".join(
        f.render().replace(os.path.dirname(dst) + os.sep, "") for f in findings)


def test_gl030_judges_the_port_against_its_own_schema():
    """Why the catalogs are swapped: the port's native-scanner counters are
    declared in the port's schema and absent from JAX's."""
    for name in ("sql.native_scans_total", "sql.native_fallbacks_total"):
        assert name in port_registry.STANDARD_COUNTERS
        assert name not in jax_registry.STANDARD_COUNTERS


def _compatible(py_t, c_t) -> bool:
    """The linter's type rule, with ``c_void_p`` standing for any pointer:
    the kernel wrappers pass ``tensor.data_ptr()`` integers, which ctypes
    takes only as ``c_void_p``."""
    if py_t.kind == "void" and py_t.depth == 1 and c_t.depth >= 1:
        return True
    return py_t == c_t


@pytest.mark.parametrize("loader", sorted(LOADERS))
def test_each_loader_matches_its_own_library(linted, loader):
    dst, _findings, _errors = linted
    py_path = os.path.join(dst, loader)
    source = os.path.join(os.path.dirname(py_path),
                          os.path.basename(LOADERS[loader]))
    with open(py_path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=py_path)
    if source.endswith(".cc"):
        # The linter's own pairing finds this library, and its GL010-GL013
        # pass over it is clean.
        assert abi.discover_cc_source(py_path, tree) == source
        assert abi.cross_check(py_path, tree) == []
        return
    assert abi.discover_cc_source(py_path, tree) is None
    decls = abi.loader_declarations(tree)
    sigs = abi.parse_extern_c(source)
    assert sigs, f"{LOADERS[loader]} exports no extern \"C\" function"
    assert sorted(decls) == sorted(sigs)
    for sym, sig in sigs.items():
        d = decls[sym]
        assert d["argtypes"] is not None and d["restype"] is not None, sym
        assert len(d["argtypes"]) == len(sig["args"]), sym
        for i, (py_t, c_t) in enumerate(zip(d["argtypes"], sig["args"])):
            assert _compatible(py_t, c_t), f"{sym} arg {i}: {py_t!r} vs {c_t!r}"
        assert d["restype"] == sig["ret"], sym


def test_thread_roles_are_runtime_no_ops():
    from analyzer_tpu_torch.sched.tier import TierManager
    from analyzer_tpu_torch.service.pipeline import _Writer

    assert TierManager.plan_rows.__thread_role__ == "producer"
    assert TierManager.apply.__thread_role__ == "consumer"
    assert _Writer.run.__thread_role__ == "consumer"
    assert TierManager.plan_rows.__name__ == "plan_rows"
