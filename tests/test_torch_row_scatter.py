"""The port's row scatter against the JAX package's scatter-floor kernel.

``experiments/scatter_floor.py::pallas_kernel`` (the Pallas TPU kernel,
run here in interpret mode on the CPU, with the grid spec of its
``make_pallas``) and the harness's ``make_xla`` scan against the port's
``kernels.row_scatter`` wrappers on CPU tensors (their plain version,
``index_copy_`` per step) — one step (``row_scatter``) and a run of steps
in order (``row_scatter_steps``, with index sets that repeat across
steps) — and the port experiment's runs. A scatter is a copy, so every
comparison is exact. The wrappers' input checks are tested too; the kernel
itself needs the card (tests/test_torch_cuda.py).
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
    for run, idx_dtype in (
        (port_sf.run_cuda, torch.int32),
        (port_sf.run_torch, torch.int64),
        (lambda t, i, r: port_sf.run_steps(port_sf.scatter_cuda, t, i, r), torch.int32),
    ):
        got = run(torch.from_numpy(table.copy()),
                  torch.from_numpy(idx).to(idx_dtype), torch.from_numpy(rows))
        assert np.array_equal(got.numpy(), want)


def _overlapping_steps(rng, steps, n_rows, width, p=P_SMALL):
    """``steps`` steps over 3 index sets used in turn, each set sharing a
    third of its rows with the one before, so the order of the steps
    decides the result."""
    perm = rng.permutation(p)
    shift = n_rows - n_rows // 3
    sets = [perm[i * shift: i * shift + n_rows] for i in range(3)]
    idx = np.stack([sets[s % 3] for s in range(steps)]).astype(np.int32)
    rows = rng.random((steps, n_rows, width)).astype(np.float32)
    return idx, rows


@pytest.mark.parametrize("width", [16, 128])
def test_row_scatter_steps_equals_xla_scan_and_pallas_steps(jax_sf, monkeypatch, width):
    """The port's multi-step entry point against the harness's ``make_xla``
    scan over the same steps, and against the Pallas kernel applied step
    by step (interpret mode), exactly."""
    n_rows, steps = 60, 7
    monkeypatch.setattr(jax_sf, "R", n_rows)
    rng = np.random.default_rng(width + 1)
    idx, rows = _overlapping_steps(rng, steps, n_rows, width)
    table = rng.random((P_SMALL, width)).astype(np.float32)
    got = rs.row_scatter_steps(torch.from_numpy(table.copy()), torch.from_numpy(idx),
                               torch.from_numpy(rows), check=True)
    want = np.asarray(jax_sf.make_xla()(jnp.asarray(table), jnp.asarray(idx),
                                        jnp.asarray(rows)))
    assert np.array_equal(got.numpy(), want)
    pallas = _pallas_scatter(jax_sf, width)
    t = jnp.asarray(table)
    for s in range(steps):
        t = pallas(jnp.asarray(idx[s]), jnp.asarray(rows[s]), t)
    assert np.array_equal(got.numpy(), np.asarray(t))
    expect = table.copy()
    for s in range(steps):
        expect[idx[s]] = rows[s]
    assert np.array_equal(got.numpy(), expect)


def test_row_scatter_is_the_one_step_case():
    rng = np.random.default_rng(9)
    idx, rows = _overlapping_steps(rng, 1, 40, 16)
    table = rng.random((P_SMALL, 16)).astype(np.float32)
    one = rs.row_scatter(torch.from_numpy(table.copy()), torch.from_numpy(idx[0]),
                         torch.from_numpy(rows[0]))
    steps = rs.row_scatter_steps(torch.from_numpy(table.copy()), torch.from_numpy(idx),
                                 torch.from_numpy(rows))
    assert torch.equal(one, steps)


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
    out = rs.row_scatter_steps(table, idx[None], rows[None] + 1)
    assert out is table and rs.launches == before
    assert torch.equal(table[idx.long()], rows + 1)


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


def _steps_args(s=3, p=50, r=8, w=16):
    rng = np.random.default_rng(2)
    idx = np.stack([rng.choice(p, r, replace=False) for _ in range(s)]).astype(np.int32)
    return (torch.zeros((p, w)), torch.from_numpy(idx),
            torch.from_numpy(rng.random((s, r, w)).astype(np.float32)))


@pytest.mark.parametrize("case", [
    "idx_rank", "idx_dtype", "rows_steps", "rows_rank", "rows_width",
    "rows_dtype", "width", "contiguity", "device",
])
def test_steps_wrapper_refuses_bad_inputs(case):
    table, idx, rows = _steps_args()
    match = None
    if case == "idx_rank":
        idx = idx[0]
    elif case == "idx_dtype":
        idx = idx.long()
    elif case == "rows_steps":
        rows = rows[:2]
    elif case == "rows_rank":
        rows = rows[0]
    elif case == "rows_width":
        rows = rows[..., :8]
    elif case == "rows_dtype":
        rows = rows.double()
    elif case == "width":
        table, idx, rows = _steps_args(w=6)
    elif case == "contiguity":
        rows = rows.transpose(0, 1).contiguous().transpose(0, 1)
        match = "contiguous"
    elif case == "device":
        idx = idx.to("meta")
        match = "is on"
    with pytest.raises(ValueError, match=match):
        rs.row_scatter_steps(table, idx, rows)


def test_steps_check_wants_distinct_rows_within_a_step_only():
    table, idx, rows = _steps_args()
    idx[2] = idx[0]  # steps may repeat rows ...
    rs.row_scatter_steps(table, idx, rows, check=True)
    bad = idx.clone()
    bad[1, 3] = bad[1, 5]  # ... a step may not
    with pytest.raises(ValueError, match="distinct within a step"):
        rs.row_scatter_steps(table, bad, rows, check=True)
    bad = idx.clone()
    bad[2, 0] = 50
    with pytest.raises(ValueError, match="lie in"):
        rs.row_scatter_steps(table, bad, rows, check=True)
    empty = rs.row_scatter_steps(table, idx[:0], rows[:0])
    assert empty is table


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


# -- mode="drop" (the sharded re-rate's padded compacted scatter) ------------


def _drop_args(s=3, p=50, r=8, w=16, seed=4):
    """Steps whose last three entries are padding past the table (``p``, as
    the mesh pads with one past the shard, and beyond)."""
    table, idx, rows = _steps_args(s, p, r, w)
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.random((p, w)).astype(np.float32))
    idx[:, -3:] = torch.tensor([p, p, p + 7], dtype=torch.int32)
    return table, idx, rows


def test_drop_mode_plain_version_equals_xla_drop_scatter():
    """The plain drop version against the JAX package's scatter with
    ``mode="drop"`` (``tbl.at[dst].set(rows, mode="drop")``, the sharded
    step's), step by step, bit for bit."""
    table, idx, rows = _drop_args()
    want = jnp.asarray(table.numpy())
    for s in range(idx.shape[0]):
        want = want.at[jnp.asarray(idx[s].numpy())].set(
            jnp.asarray(rows[s].numpy()), mode="drop")
    got = rs.row_scatter_steps(table.clone(), idx, rows, mode="drop")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = rs.row_scatter(table.clone(), idx[0], rows[0], mode="drop")
    plain = rs.row_scatter_plain(table.clone(), idx[0], rows[0], mode="drop")
    assert torch.equal(one, plain)
    kept = idx[0][:-3].long()
    assert torch.equal(one[kept], rows[0][:-3])
    untouched = torch.ones(table.shape[0], dtype=torch.bool)
    untouched[kept] = False
    assert torch.equal(one[untouched], table[untouched])
    # A negative index is outside [0, P) too, and skipped (XLA's scatter
    # would wrap it first; the mesh never pads with one).
    neg = idx[0].clone()
    neg[-1] = -1
    assert torch.equal(rs.row_scatter(table.clone(), neg, rows[0], mode="drop"), one)


def test_drop_mode_check_wants_kept_entries_distinct_only():
    table, idx, rows = _drop_args()
    before = rs.launches
    rs.row_scatter_steps(table.clone(), idx, rows, check=True, mode="drop")
    assert rs.launches == before  # the plain version, uncounted
    bad = idx.clone()
    bad[1, 0] = bad[1, 2]  # two kept entries share a row
    with pytest.raises(ValueError, match="distinct within a step"):
        rs.row_scatter_steps(table, bad, rows, check=True, mode="drop")
    with pytest.raises(ValueError, match="lie in"):  # the default refuses them
        rs.row_scatter_steps(table, idx, rows, check=True)
    with pytest.raises(ValueError, match="mode must be one of"):
        rs.row_scatter(table, idx[0], rows[0], mode="clip")


def test_drop_mode_all_padding_writes_nothing():
    table, idx, rows = _drop_args()
    idx[:] = table.shape[0]
    got = rs.row_scatter_steps(table.clone(), idx, rows, check=True, mode="drop")
    assert torch.equal(got, table)
