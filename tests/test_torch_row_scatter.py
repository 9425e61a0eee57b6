"""The port's row scatter against the JAX package's scatter-floor kernel.

``experiments/scatter_floor.py::pallas_kernel`` (the Pallas TPU kernel,
run here in interpret mode on the CPU, with the grid spec of its
``make_pallas``) and the harness's ``make_xla`` scan against the port's
``kernels.row_scatter`` wrapper on CPU tensors (its plain version,
``index_copy_``) and the port experiment's step loop. A scatter is a copy,
so every comparison is exact. The wrapper's input checks are tested too;
the kernel itself needs the card (tests/test_torch_cuda.py).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from analyzer_tpu_torch.experiments import scatter_floor as port_sf
from analyzer_tpu_torch.kernels import row_scatter as rs

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P_SMALL = 1000


@pytest.fixture
def jax_sf(monkeypatch):
    """``experiments/scatter_floor.py`` (not a package), imported by path,
    with a small table; its module generator is replaced per test."""
    spec = importlib.util.spec_from_file_location(
        "scatter_floor_jax", os.path.join(_REPO, "experiments", "scatter_floor.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "P", P_SMALL)
    return mod


def _pallas_scatter(mod, width):
    """The Pallas kernel as ``make_pallas`` builds it, in interpret mode."""
    return pl.pallas_call(
        mod.pallas_kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            in_specs=[
                pl.BlockSpec(memory_space=pl.ANY),  # rows
                pl.BlockSpec(memory_space=pl.ANY),  # table
            ],
            out_specs=pl.BlockSpec(memory_space=pl.ANY),
            scratch_shapes=[pltpu.SemaphoreType.DMA((mod.NSEM,))],
        ),
        out_shape=jax.ShapeDtypeStruct((mod.P, width), jnp.float32),
        input_output_aliases={2: 0},
        interpret=True,
    )


@pytest.mark.parametrize("n_rows", [64, 257])
@pytest.mark.parametrize("width", [16, 128])
def test_pallas_kernel_equals_row_scatter(jax_sf, monkeypatch, n_rows, width):
    monkeypatch.setattr(jax_sf, "R", n_rows)
    rng = np.random.default_rng(n_rows + width)
    idx = rng.choice(P_SMALL, size=n_rows, replace=False).astype(np.int32)
    rows = rng.random((n_rows, width)).astype(np.float32)
    table = rng.random((P_SMALL, width)).astype(np.float32)
    want = np.asarray(_pallas_scatter(jax_sf, width)(
        jnp.asarray(idx), jnp.asarray(rows), jnp.asarray(table)))
    got = rs.row_scatter(torch.from_numpy(table.copy()), torch.from_numpy(idx),
                         torch.from_numpy(rows), check=True)
    assert np.array_equal(got.numpy(), want)
    expect = table.copy()
    expect[idx] = rows
    assert np.array_equal(want, expect)


@pytest.mark.parametrize("width", [16, 128])
def test_xla_scan_equals_port_step_loop(jax_sf, monkeypatch, width):
    """JAX ``make_xla`` over S steps whose index sets repeat every 8 steps
    against the port experiment's loop, on inputs drawn in the same order
    from the same seed."""
    n_rows, steps = 48, 19
    monkeypatch.setattr(jax_sf, "R", n_rows)
    monkeypatch.setattr(jax_sf, "rng", np.random.default_rng(5))
    j_idx, j_rows = jax_sf.make_xs(steps, width)
    idx, rows = port_sf.make_xs(steps, width, np.random.default_rng(5),
                                n_players=P_SMALL, n_rows=n_rows)
    assert np.array_equal(np.asarray(j_idx), idx)
    assert np.array_equal(np.asarray(j_rows), rows)
    table = np.random.default_rng(6).random((P_SMALL, width)).astype(np.float32)
    want = np.asarray(jax_sf.make_xla()(jnp.asarray(table), j_idx, j_rows))
    for step, idx_dtype in ((port_sf.scatter_cuda, torch.int32),
                            (port_sf.scatter_torch, torch.int64)):
        got = port_sf.run_steps(
            step, torch.from_numpy(table.copy()),
            torch.from_numpy(idx).to(idx_dtype), torch.from_numpy(rows),
        )
        assert np.array_equal(got.numpy(), want)


def test_make_xs_repeats_every_eight_steps():
    idx, rows = port_sf.make_xs(20, 16, np.random.default_rng(0), n_players=100,
                                n_rows=30)
    assert idx.shape == (20, 30) and rows.shape == (20, 30, 16)
    assert idx.dtype == np.int32 and rows.dtype == np.float32
    assert np.array_equal(idx[3], idx[11]) and np.array_equal(rows[4], rows[12])
    assert all(np.unique(step).size == 30 for step in idx)


def test_time_variant_runs_on_cpu():
    per_step = port_sf.time_variant("cuda16", "cpu", np.random.default_rng(0),
                                    n_players=200, n_rows=16, repeats=1)
    assert per_step > 0


def _args(p=50, r=8, w=16):
    rng = np.random.default_rng(1)
    return (torch.zeros((p, w)),
            torch.from_numpy(rng.choice(p, r, replace=False).astype(np.int32)),
            torch.from_numpy(rng.random((r, w)).astype(np.float32)))


def test_cpu_runs_the_plain_version_uncounted():
    table, idx, rows = _args()
    before = rs.launches
    out = rs.row_scatter(table, idx, rows)
    assert out is table and rs.launches == before
    assert torch.equal(table[idx.long()], rows)


@pytest.mark.parametrize("case", [
    "table_dtype", "table_rank", "width", "idx_dtype", "idx_rank",
    "rows_shape", "rows_dtype", "contiguity",
])
def test_wrapper_refuses_bad_inputs(case):
    table, idx, rows = _args()
    if case == "table_dtype":
        table = table.double()
    elif case == "table_rank":
        table = table.reshape(-1)
    elif case == "width":
        table, idx, rows = _args(w=6)
    elif case == "idx_dtype":
        idx = idx.long()
    elif case == "idx_rank":
        idx = idx.reshape(2, -1)
    elif case == "rows_shape":
        rows = rows[:-1]
    elif case == "rows_dtype":
        rows = rows.half()
    elif case == "contiguity":
        rows = torch.zeros((16, 8)).t()
    with pytest.raises(ValueError):
        rs.row_scatter(table, idx, rows)


def test_wrapper_refuses_other_devices():
    table, idx, rows = _args()
    with pytest.raises(ValueError, match="meta"):
        rs.row_scatter(table.to("meta"), idx.to("meta"), rows.to("meta"))
    with pytest.raises(ValueError, match="is on"):
        rs.row_scatter(table, idx.to("meta"), rows)


def test_check_catches_range_and_duplicates():
    table, idx, rows = _args()
    for bad, match in ((50, "lie in"), (-1, "lie in")):
        j = idx.clone()
        j[3] = bad
        with pytest.raises(ValueError, match=match):
            rs.row_scatter(table, j, rows, check=True)
    j = idx.clone()
    j[5] = j[2]
    with pytest.raises(ValueError, match="distinct"):
        rs.row_scatter(table, j, rows, check=True)
    rs.row_scatter(table, idx, rows, check=True)  # a good call passes
    assert rs.row_scatter(table, idx[:0], rows[:0]) is table  # nothing to write
