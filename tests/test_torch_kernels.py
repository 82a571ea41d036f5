"""Plain versions of the port's kernels against gcge_tpu's Pallas kernels.

The same numpy inputs go to both packages.  The Pallas kernels run in
interpret mode, as gcge_tpu's own tests run them on the CPU; the port's
wrappers run their plain PyTorch versions because the tensors lie on the CPU.
The CUDA kernels themselves are checked on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcge_tpu.ops.osgemm_pallas import os_expand_pallas, os_gram_pallas
from gcge_tpu.ops.spmm_pallas import (dia_spmm_pallas_t,
                                      dia_spmm_pallas_t_df64, split_df32)
from gcge_tpu_torch.ops import onehot, osgemm, spmm
from gcge_tpu_torch.ops.operators import DiaOperator

torch.set_num_threads(2)


def stencil_27(nx: int):
    """3-D 27-point Laplacian on an nx^3 grid (COO)."""
    n = nx ** 3
    idx = np.arange(n)
    i, j, k = idx // (nx * nx), (idx // nx) % nx, idx % nx
    rows, cols, vals = [], [], []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                ii, jj, kk = i + di, j + dj, k + dk
                ok = ((ii >= 0) & (ii < nx) & (jj >= 0) & (jj < nx)
                      & (kk >= 0) & (kk < nx))
                rows.append(idx[ok])
                cols.append((ii * nx * nx + jj * nx + kk)[ok])
                vals.append(np.full(ok.sum(), 26.0 if di == dj == dk == 0
                                    else -1.0))
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n


@pytest.fixture(scope="module")
def dia12():
    rows, cols, vals, n = stencil_27(12)
    # non-constant values so that every diagonal entry matters
    vals = vals * np.random.default_rng(3).uniform(0.5, 1.5, len(vals))
    return DiaOperator.from_coo(rows, cols, vals, (n, n), device="cpu")


def _dia_scale(op, x_nm):
    """max of |A| |x| — the size each output's rounding is measured against."""
    absop = DiaOperator(op.values.abs(), op.offsets, op.n_cols)
    return float(absop.matvec(torch.as_tensor(np.abs(x_nm))).max())


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("m", [3, 10])
def test_dia_f64_plain_matches_df64_pallas(dia12, m, transposed):
    """Port's f64 DIA (plain) vs the df64 Pallas kernel: within 1e-13 of
    max |A||x| (df64 planes carry ~2^-48 relative error)."""
    n = dia12.shape[0]
    x = np.random.default_rng(m).standard_normal((n, m))
    hi, lo = split_df32(jnp.asarray(dia12.values.numpy()))
    ref = np.asarray(dia_spmm_pallas_t_df64(hi, lo, dia12.offsets,
                                            jnp.asarray(x.T),
                                            interpret=True)).T
    xt = torch.as_tensor(x.T.copy() if transposed else x)
    got = (dia12.matvec_t(xt).T if transposed else dia12.matvec(xt)).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-13 * _dia_scale(dia12, x)


@pytest.mark.parametrize("transposed", [False, True])
def test_dia_f32_plain_matches_pallas(dia12, transposed):
    """Port's f32 DIA (plain) vs the f32 Pallas kernel: within 1e-5 of
    max |A||x| (f32 sums of 27 terms)."""
    n = dia12.shape[0]
    x = np.random.default_rng(7).standard_normal((n, 10)).astype(np.float32)
    v32 = dia12.values.float()
    ref = np.asarray(dia_spmm_pallas_t(jnp.asarray(v32.numpy()),
                                       dia12.offsets, jnp.asarray(x.T),
                                       interpret=True)).T
    op32 = DiaOperator(v32, dia12.offsets, dia12.n_cols)
    xt = torch.as_tensor(x.T.copy() if transposed else x)
    got = (op32.matvec_t(xt).T if transposed else op32.matvec(xt)).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-5 * _dia_scale(dia12, x)


def test_dia_strided_views_match_contiguous(dia12):
    """A column slice of a wider basis and a transposed view give the same
    product as contiguous copies (the kernels take 2-D strides)."""
    n = dia12.shape[0]
    basis = torch.as_tensor(np.random.default_rng(1).standard_normal((n, 9)))
    view = basis[:, 2:7]
    assert torch.equal(dia12.matvec(view), dia12.matvec(view.contiguous()))
    assert torch.equal(dia12.matvec_t(view.T), dia12.matvec(view).T)


def test_dia_wrapper_rejects_what_the_kernel_does_not_take(dia12):
    n = dia12.shape[0]
    x = torch.zeros((n, 2), dtype=torch.float64)
    # a halo window needs n + hl + hr rows of x
    with pytest.raises(ValueError, match="halo"):
        spmm.dia_spmm(dia12.values, dia12.offsets_t, x, halo=(1, 0))
    with pytest.raises(ValueError, match="negative halo"):
        spmm.dia_spmm(dia12.values, dia12.offsets_t, x, halo=(-1, 1))
    with pytest.raises(ValueError, match="does not match"):
        spmm.dia_spmm(dia12.values, dia12.offsets_t, x, transposed=True)
    with pytest.raises(ValueError, match="does not match"):
        spmm.dia_spmm(dia12.values, dia12.offsets_t, x[:-1])


def _gram_scale(a, b):
    return (np.linalg.norm(a, axis=0)[:, None]
            * np.linalg.norm(b, axis=0)[None, :]) + 1e-300


def _expand_scale(a, c):
    return np.abs(a).max(1)[:, None] * np.abs(c).max(0)[None, :] \
        * a.shape[1] + 1e-300


@pytest.mark.parametrize("shape", [(1500, 120, 10), (1030, 100, 100),
                                   (999, 9, 3)])
def test_tall_gram_plain_matches_os_gram_pallas(shape):
    """Plain tall Gram vs the sliced Pallas Gram: within 1e-13 of
    ||a_i|| ||b_j|| per entry."""
    n, p, q = shape
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, p)) * np.exp(rng.uniform(-6, 6, (1, p)))
    b = rng.standard_normal((n, q))
    ref = np.asarray(os_gram_pallas(jnp.asarray(a), jnp.asarray(b),
                                    interpret=True))
    got = osgemm.tall_gram(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert np.max(np.abs(got - ref) / _gram_scale(a, b)) < 1e-13


@pytest.mark.parametrize("shape", [(1500, 120, 100), (1030, 120, 10),
                                   (999, 9, 3)])
def test_tall_expand_plain_matches_os_expand_pallas(shape):
    """Plain tall expand vs the sliced Pallas expand: within 1e-13 of
    k max|a_i.| max|c_.j| per entry."""
    n, k, q = shape
    rng = np.random.default_rng(n + k)
    a = rng.standard_normal((n, k)) * np.exp(rng.uniform(-6, 6, (n, 1)))
    c = rng.standard_normal((k, q)) * np.exp(rng.uniform(-6, 6, (1, q)))
    ref = np.asarray(os_expand_pallas(jnp.asarray(a), jnp.asarray(c),
                                      interpret=True))
    got = osgemm.tall_expand(torch.as_tensor(a), torch.as_tensor(c)).numpy()
    assert np.max(np.abs(got - ref) / _expand_scale(a, c)) < 1e-13


def test_tall_gemm_zero_and_tiny_columns():
    """Zero columns and 1e-30-scaled columns (test_osgemm.py's case):
    within 1e-13 of the largest entry."""
    rng = np.random.default_rng(42)
    n = 700
    a = rng.standard_normal((n, 6))
    a[:, 2] = 0.0
    a[:, 4] *= 1e-30
    b = rng.standard_normal((n, 4))
    b[:, 1] = 0.0
    ref = np.asarray(os_gram_pallas(jnp.asarray(a), jnp.asarray(b),
                                    interpret=True))
    got = osgemm.tall_gram(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert np.max(np.abs(got - ref)) < 1e-13 * np.abs(ref).max()
    assert np.all(got[2] == 0.0) and np.all(got[:, 1] == 0.0)
    c = rng.standard_normal((6, 5))
    c[:, 3] = 0.0
    ref2 = np.asarray(os_expand_pallas(jnp.asarray(a), jnp.asarray(c),
                                       interpret=True))
    got2 = osgemm.tall_expand(torch.as_tensor(a), torch.as_tensor(c)).numpy()
    assert np.max(np.abs(got2 - ref2)) < 1e-13 * np.abs(ref2).max()
    assert np.all(got2[:, 3] == 0.0)


def test_tall_gemm_wide_blocks():
    """Wide shapes (test_osgemm.py's case): the square p = q = 400 Gram and
    the (480 x 400) recombination, within 1e-13 (scaled as above)."""
    rng = np.random.default_rng(43)
    n = 900
    a = rng.standard_normal((n, 400))
    b = rng.standard_normal((n, 400))
    ref = np.asarray(os_gram_pallas(jnp.asarray(a), jnp.asarray(b),
                                    interpret=True))
    got = osgemm.tall_gram(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert np.max(np.abs(got - ref) / _gram_scale(a, b)) < 1e-13
    a2 = rng.standard_normal((n, 480))
    c2 = rng.standard_normal((480, 400))
    ref2 = np.asarray(os_expand_pallas(jnp.asarray(a2), jnp.asarray(c2),
                                       interpret=True))
    got2 = osgemm.tall_expand(torch.as_tensor(a2),
                              torch.as_tensor(c2)).numpy()
    assert np.max(np.abs(got2 - ref2) / _expand_scale(a2, c2)) < 1e-13


def test_tall_gemm_wrappers_check_shapes():
    a = torch.zeros((5, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="do not contract"):
        osgemm.tall_gram(a, torch.zeros((4, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="do not contract"):
        osgemm.tall_expand(a, torch.zeros((2, 2), dtype=torch.float64))


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch(dia12):
    """On CPU tensors the wrappers run the plain versions; the launch
    counters move only where a CUDA kernel launches."""
    before = {**spmm.LAUNCHES, **osgemm.LAUNCHES}
    n = dia12.shape[0]
    x = torch.ones((n, 2), dtype=torch.float64)
    dia12.matvec(x)
    dia12.matvec_t(x.T)
    osgemm.tall_gram(x, x)
    osgemm.tall_expand(x, torch.eye(2, dtype=torch.float64))
    assert {**spmm.LAUNCHES, **osgemm.LAUNCHES} == before


# ---- launch plans of kernels 3 and 4 (csrc/tall_gemm.cu) -------------------

_PLAN_SHAPES = [(1, 1, 1), (5, 3, 2), (255, 10, 10), (256, 120, 10),
                (1000, 10, 100), (157_464, 120, 10), (157_464, 110, 10),
                (157_464, 10, 10), (157_464, 100, 100), (250_047, 120, 120),
                (900, 400, 400), (900, 480, 400), (1000, 129, 7)]


@pytest.mark.parametrize("n,p,q", _PLAN_SHAPES)
@pytest.mark.parametrize("sms", [132, 1])
def test_gram_plan_covers_each_row_once_and_fits(n, p, q, sms):
    """The chunks cover rows 0..n-1 once, in at most GRAM_MAX_CHUNKS
    blocks a tile; the ring (or the k-split sum) fits the shared memory;
    the pitches keep a half warp's fragment loads on distinct banks."""
    plan = osgemm.gram_plan(n, p, q, sms)
    starts = [c * plan.rows for c in range(plan.chunks)]
    assert starts[0] == 0 and starts[-1] < n <= plan.chunks * plan.rows
    assert 1 <= plan.chunks <= min(osgemm.GRAM_MAX_CHUNKS, max(sms, 1) * 2)
    assert plan.tiles == -(-p // 128) * -(-q // 128)
    assert plan.smem <= osgemm.SMEM_BLOCK
    assert plan.bk % 8 == 0 and plan.bk >= 8
    wk = 8 // plan.wm
    ring = osgemm.STAGES * plan.bk * 8 * (plan.pitch_a + plan.pitch_b)
    assert plan.smem >= max(ring, (wk - 1) * plan.wm * plan.nt * 1024)
    mt, nt = -(-min(p, 128) // 16), -(-min(q, 128) // 8)
    assert plan.wm >= mt and plan.nt >= nt and plan.nt in (2, 4, 8, 16)
    for pitch, width in ((plan.pitch_a, 16 * mt), (plan.pitch_b, 8 * nt)):
        assert pitch >= width and pitch % 16 == 4


@pytest.mark.parametrize("n,k,q", _PLAN_SHAPES)
def test_expand_plan_covers_each_row_once_and_fits(n, k, q):
    """The persistent blocks' row tiles cover rows 0..n-1 once; C's q-tiles
    and k-chunks cover C; C (fragment order) and the ring fit the shared
    memory; the instance holds every n-tile of a q-tile."""
    plan = osgemm.expand_plan(n, k, q, 132)
    tile = osgemm.EXPAND_ROWS       # block b walks tiles b, b + grid, ...
    rows = sorted(r for b in range(plan.grid)
                  for r in range(b * tile, n, plan.grid * tile))
    assert rows == list(range(0, n, tile))
    assert plan.grid <= 132
    assert plan.q_tile % 8 == 0 and plan.q_tile <= osgemm.EXPAND_Q_TILE
    assert plan.k_chunk % 8 == 0 and plan.k_chunk >= 8
    assert plan.smem <= osgemm.SMEM_BLOCK
    c_bytes = -(-min(k, plan.k_chunk) // 8) * (plan.q_tile // 8) * 512
    assert plan.smem == c_bytes + osgemm.EXPAND_RING
    assert plan.nt == plan.q_tile // 8 <= 16
    # k q 8 bytes that fit keep C resident in one launch
    if k * q * 8 <= 96 * 1024 and q <= osgemm.EXPAND_Q_TILE:
        assert plan.q_tile >= q and plan.k_chunk >= k


def _views():
    base = torch.zeros((64, 121), dtype=torch.float64)
    return {
        "contiguous even width": (torch.zeros((64, 120),
                                              dtype=torch.float64), 2),
        "columns 0..109 of width 120": (torch.zeros(
            (64, 120), dtype=torch.float64)[:, :110], 2),
        "columns 2.. of width 120": (torch.zeros(
            (64, 120), dtype=torch.float64)[:, 2:], 2),
        "odd column offset": (torch.zeros((64, 120),
                                          dtype=torch.float64)[:, 1:], 1),
        "odd row stride": (base[:, :10], 1),
        "transposed": (torch.zeros((10, 64), dtype=torch.float64).T, 1),
        "one column of odd stride": (base[:, 4:5], 1),
        "one row": (base[:1, :4], 2),
    }


@pytest.mark.parametrize("name", list(_views()))
def test_copy_vec_takes_16_bytes_only_on_aligned_rows(name):
    """16-byte copies only for operands whose rows start on 16 bytes (base
    and row stride) with contiguous columns; every other view takes the
    8-byte variant of the same kernel, never the plain version."""
    t, vec = _views()[name]
    assert osgemm.copy_vec(t) == vec
    aligned = t.data_ptr() % 16 == 0
    assert osgemm.copy_vec(t, _views()["odd row stride"][0]) == 1
    if vec == 2:
        assert aligned


def test_dmma_tile_check_plain_on_cpu():
    rng = np.random.default_rng(5)
    a, c = rng.standard_normal((16, 8)), rng.standard_normal((8, 8))
    got = osgemm.dmma_tile_check(torch.as_tensor(a), torch.as_tensor(c))
    np.testing.assert_array_equal(got.numpy(), a @ c)
    with pytest.raises(ValueError, match="16, 8"):
        osgemm.dmma_tile_check(torch.as_tensor(c), torch.as_tensor(c))


# ---- launch plans of kernels 5 and 2 (csrc/csr_spmm.cu, csrc/dia_spmm.cu) --


def _rowptr(degrees):
    return np.concatenate([[0], np.cumsum(degrees)]).astype(np.int32)


def _row_cases():
    rng = np.random.default_rng(11)
    mesh = rng.integers(6, 27, 2001)             # Delaunay-like, odd n
    mesh[::97] = 0                               # empty rows
    long = rng.integers(0, 12, 3000)
    long[[7, 1500, 2999]] = [5000, 2049, 20_000]  # rows past the budget
    return {
        "n=0": np.zeros(0, np.int64),
        "n=1": np.array([5]),
        "n=1 empty": np.array([0]),
        "n=1 long": np.array([9000]),
        "all empty, odd n": np.zeros(1001, np.int64),
        "mesh-like, odd n": mesh,
        "long rows": long,
        "rows of exactly the budget": np.full(9, onehot.CSR_BUDGET),
    }


@pytest.mark.parametrize("case", list(_row_cases()))
@pytest.mark.parametrize("budget,max_rows", [(onehot.CSR_BUDGET,
                                               onehot.CSR_MAX_ROWS),
                                              (64, 8), (1024, 300)])
def test_csr_tiles_cover_each_row_once_and_fit(case, budget, max_rows):
    """Kernel 5's row tiles: rows 0..n-1 each in exactly one tile, in order;
    a tile's entries, widened to 16-byte boundaries, fit the budget unless
    the tile is one row that does not (it streams in chunks); no tile
    exceeds max_rows; a tile stops only where the next row would break
    one of the two limits."""
    rowptr = _rowptr(_row_cases()[case])
    n = len(rowptr) - 1
    tiles = onehot.csr_tiles(rowptr, budget, max_rows)
    assert tiles.dtype == np.int32 and tiles[0] == 0 and tiles[-1] == n
    assert np.all(np.diff(tiles) >= 1)
    rp = rowptr.astype(np.int64)
    for r0, r1 in zip(tiles[:-1], tiles[1:]):
        staged = -(-rp[r1] // 4) * 4 - rp[r0] // 4 * 4
        assert r1 - r0 <= max_rows
        assert staged <= budget or r1 - r0 == 1
        if r1 < n:                 # greedy: the next row did not fit
            grown = -(-rp[r1 + 1] // 4) * 4 - rp[r0] // 4 * 4
            assert r1 - r0 == max_rows or grown > budget
    # every row longer than the budget has a tile of its own
    for r in np.flatnonzero(np.diff(rp) > budget):
        assert r in tiles and r + 1 in tiles


def test_csr_tiles_reject_budgets_the_kernel_cannot_take():
    rowptr = _rowptr([3, 4])
    for budget in (0, 6, -4):
        with pytest.raises(ValueError, match="budget"):
            onehot.csr_tiles(rowptr, budget)
    with pytest.raises(ValueError, match="max_rows"):
        onehot.csr_tiles(rowptr, 8, 0)


def test_csr_operator_plans_only_on_a_card():
    """The row tiles live on the card of the operator; a CPU operator runs
    the plain version and has none."""
    op = onehot.CsrOperator.from_coo([0, 1, 1], [1, 0, 1], [1.0, 2.0, 3.0],
                                     (2, 2), device="cpu")
    assert op.plan is None


@pytest.mark.parametrize("m,x_strides,y_strides,ptr,want", [
    # the CG's operand: (m, n) in shape, (n, m) in memory
    (10, (10, 1), (10, 1), 0, (2, 10, True)),
    # a contiguous (m, n) operand: columns n apart, y likewise
    (10, (1, 5000), (1, 5000), 0, (1, 5, False)),
    # (n, m) row-major at m = 40: 16-byte groups, column tiles of 20
    (40, (40, 1), (40, 1), 0, (4, 20, False)),
    (16, (16, 1), (16, 1), 0, (4, 16, True)),
    (1, (1, 1), (1, 1), 0, (1, 1, True)),
    # a start off 16 bytes: no flat copy, 8-byte groups still
    (10, (10, 1), (10, 1), 8, (2, 10, False)),
    # a column slice of a wider basis: rows 13 floats apart
    (10, (13, 1), (10, 1), 0, (2, 10, False)),
])
def test_dia_plan_by_layout(m, x_strides, y_strides, ptr, want):
    """Kernel 2's plan: the vector width follows y's stores, a column tile
    holds at most DIA_ITEMS groups, the window is one flat range only where
    x's rows are adjacent and x starts on 16 bytes."""
    plan = spmm.dia_plan(m, *x_strides, ptr, *y_strides, ptr)
    assert (plan.vec, plan.col_tile, plan.flat) == want
    assert plan.col_tile % plan.vec == 0 and m % plan.vec == 0
    assert plan.col_tile <= spmm.DIA_ITEMS * plan.vec


@pytest.mark.parametrize("m", [1, 2, 3, 10, 16, 40, 100, 1000])
def test_dia_plan_column_tiles_cover_m(m):
    plan = spmm.dia_plan(m, m, 1, 0, m, 1, 0)
    tiles = [min(plan.col_tile, m - c0) for c0 in range(0, m, plan.col_tile)]
    assert sum(tiles) == m and all(t % plan.vec == 0 for t in tiles)


@pytest.mark.parametrize("operands,want", [
    (((10, 1, 0),), 2), (((12, 1, 16),), 4), (((12, 1, 8),), 2),
    (((11, 1, 0),), 1), (((1, 7, 0),), 1), (((10, 1, 0), (10, 1, 4)), 1),
])
def test_vec_width(operands, want):
    m = 12 if operands[0][0] == 12 else 10
    assert spmm.vec_width(m, *operands) == want


# ---- launch plans of kernels 1 and 6 (f64): the same rules by element size --


# (m, column offset of an (n, 120) basis view): even offsets start rows on 16
# bytes in both types, odd ones on 8 (f64) or 4 (f32) bytes only
_VIEWS = [(1, 110), (1, 41), (10, 110), (10, 41), (16, 104), (16, 41),
          (100, 0), (100, 19)]


@pytest.mark.parametrize("m,off", _VIEWS)
@pytest.mark.parametrize("item", [4, 8])
def test_vec_width_by_element_size(m, off, item):
    """A thread moves at most 16 bytes: f64 groups of 2 where the view's
    rows start on 16 bytes and m is even, else 1; f32 groups of 4 or 2 by
    the same rule; the fresh contiguous product never narrows them."""
    x = (120, 1, off * item)
    y = (m, 1, 0)
    want = {8: 2 if m % 2 == 0 and off % 2 == 0 else 1,
            4: 4 if m % 4 == 0 and off % 4 == 0 else
            2 if m % 2 == 0 and off % 2 == 0 else 1}[item]
    assert spmm.vec_width(m, x, y, item=item) == want
    if item == 4:                # the default is the f32 rule, unchanged
        assert spmm.vec_width(m, x, y) == want


@pytest.mark.parametrize("m,off", _VIEWS)
def test_dia_plan_f64_at_the_solve_operands(m, off):
    """Kernel 1's plan on a column view of V: 16-byte row copies where the
    offset is even (every row segment on 16 bytes), 8-byte copies where it
    is odd; vec follows the contiguous product; f32's plan at the same view
    keeps the f32 rule (never flat: the rows are not adjacent)."""
    args = (m, 120, 1, off * 8 % 16, m, 1, 0)
    plan = spmm.dia_plan(*args, item=8)
    vec = 2 if m % 2 == 0 else 1
    assert (plan.vec, plan.col_tile) == (vec, min(m, spmm.DIA_ITEMS * vec))
    assert plan.rows16 == (off % 2 == 0)
    assert not plan.flat and not plan.row_fast
    plan32 = spmm.dia_plan(m, 120, 1, off * 4 % 16, m, 1, 0)
    vec32 = spmm.vec_width(m, (m, 1, 0))
    assert (plan32.vec, plan32.col_tile, plan32.flat, plan32.rows16) == \
        (vec32, min(m, spmm.DIA_ITEMS * vec32), False, False)


@pytest.mark.parametrize("item", [4, 8])
@pytest.mark.parametrize("m", [1, 10, 16, 100])
def test_dia_plan_transposed_layouts(item, m):
    """A contiguous (m, n) operand and its product: rows adjacent, so one
    element a group; kernel 1's items along one row's columns (row_fast)
    where there is more than one column, kernel 2's column groups fastest
    always; at m = 1 the f32 window is one flat range of x, and f64
    rows one double apart take 8-byte copies."""
    n = 1000
    plan = spmm.dia_plan(m, 1, n, 0, 1, n, 0, item=item)
    assert plan.vec == 1 and plan.col_tile == min(m, spmm.DIA_ITEMS)
    assert plan.row_fast == (m > 1 and item == 8)
    assert not plan.rows16 and plan.flat == (m == 1 and item == 4)


@pytest.mark.parametrize("case", list(_row_cases()))
def test_csr_plan_serves_both_dtypes(case):
    """One plan for kernels 5 and 6: the tiles csr_tiles gives at
    CSR_BUDGET, whose entries fit 48 KB of shared memory at 8 bytes (f32)
    and at 12 bytes (f64) each, and whose 16-byte copies start on 4 entries
    (16 bytes of colidx, 16 or 32 of values)."""
    rowptr = _rowptr(_row_cases()[case])
    plan = onehot.csr_plan(torch.as_tensor(rowptr))
    np.testing.assert_array_equal(plan.tiles.numpy(),
                                  onehot.csr_tiles(rowptr, onehot.CSR_BUDGET))
    assert plan.budget == onehot.CSR_BUDGET and plan.budget % 4 == 0
    for item in (4, 8):
        assert plan.budget * (4 + item) <= 48 * 1024
