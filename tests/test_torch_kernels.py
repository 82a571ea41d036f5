"""Plain versions of the port's kernels against gcge_tpu's Pallas kernels.

The same numpy inputs go to both packages.  The Pallas kernels run in
interpret mode, as gcge_tpu's own tests run them on the CPU; the port's
wrappers run their plain PyTorch versions because the tensors lie on the CPU.
The CUDA kernels themselves are checked on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import os
import re

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
@pytest.mark.parametrize("m", [3, 10, 40])
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


# (transposed, m): m = 40 is the nev=200 solve's CG operand, the wide path's
@pytest.mark.parametrize("transposed,m", [(False, 10), (True, 10),
                                          (False, 40), (True, 40)],
                         ids=["False", "True", "False-m40", "True-m40"])
def test_dia_f32_plain_matches_pallas(dia12, transposed, m):
    """Port's f32 DIA (plain) vs the f32 Pallas kernel: within 1e-5 of
    max |A||x| (f32 sums of 27 terms)."""
    n = dia12.shape[0]
    x = np.random.default_rng(7).standard_normal((n, m)).astype(np.float32)
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


# ---- the wide path of kernels 3 and 4 ---------------------------------------

# the wide classes of the production widths (nev=200: m=480, block 40;
# nev=400: m=960, block 80) at their n and at the card tests' small n, and
# ragged shapes
_WIDE_SHAPES = [(85_184, 960, 800), (85_184, 800, 800), (85_184, 960, 80),
                (85_184, 880, 80), (157_464, 480, 400), (157_464, 400, 400),
                (157_464, 480, 40), (157_464, 440, 40), (4_099, 960, 800),
                (4_099, 880, 80), (4_099, 800, 800), (4_099, 480, 400),
                (5, 129, 3), (1, 300, 7), (1000, 7, 200), (3001, 130, 129)]
# the classes of a nev=50 solve (m=120, block 10, 100 Ritz vectors):
# Gram (p x q) and expand (n x k)(k x q)
_NEV50_GRAMS = [(120, 10), (110, 10), (10, 10), (100, 100)]
_NEV50_EXPANDS = [(120, 100), (120, 10), (110, 10), (10, 10)]


def _wide_expand_blocks(plan, n, q):
    """(rows, columns) of Y each block of the wide expand writes, by the
    kernel's block index (q-tiles fastest)."""
    q_tiles = -(-q // plan.q_tile)
    for blk in range(plan.blocks):
        r0, q0 = (blk // q_tiles) * plan.band, (blk % q_tiles) * plan.q_tile
        yield range(r0, min(n, r0 + plan.band)), range(q0, min(q,
                                                               q0 + plan.q_tile))


@pytest.mark.parametrize("n,k,q", _WIDE_SHAPES)
def test_wide_expand_plan_covers_y_once_in_one_launch(n, k, q):
    """The blocks of the one launch cover every (row, column) of Y exactly
    once, over all of k (no k-chunk); bands of whole m-tiles at most one
    tile high, q-tiles of whole n-tiles at most one tile wide."""
    plan = osgemm.wide_expand_plan(n, k, q, 132)
    wide = osgemm.WIDE
    assert plan.band % 16 == 0 and wide.bm // 2 <= plan.band <= wide.bm
    assert plan.q_tile % 8 == 0 and plan.q_tile <= wide.bn
    assert plan.blocks == -(-n // plan.band) * -(-q // plan.q_tile)
    hits = np.zeros((n, q), dtype=np.int64)
    for rows, cols in _wide_expand_blocks(plan, n, q):
        assert len(rows) and len(cols)
        hits[rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (hits == 1).all()
    assert not hasattr(plan, "k_chunk")


@pytest.mark.parametrize("n,p,q", _WIDE_SHAPES)
@pytest.mark.parametrize("sms", [132, 1])
def test_wide_gram_plan_covers_c_once_a_chunk(n, p, q, sms):
    """Every chunk's tiles cover every entry of C exactly once, the chunks
    cover rows 0..n-1 once, and the blocks are chunks x tiles."""
    plan = osgemm.wide_gram_plan(n, p, q, sms)
    bm, bn = osgemm.WIDE.bm, osgemm.WIDE.bn
    assert plan.tiles == -(-p // bm) * -(-q // bn)
    assert 1 <= plan.chunks <= osgemm.GRAM_MAX_CHUNKS
    assert (plan.chunks - 1) * plan.rows < n <= plan.chunks * plan.rows
    if plan.chunks > 1:
        assert plan.rows >= osgemm.WIDE_MIN_ROWS
    hits = np.zeros((plan.chunks, p, q), dtype=np.int64)
    q_tiles = -(-q // bn)
    for blk in range(plan.chunks * plan.tiles):      # tiles fastest
        chunk, t = divmod(blk, plan.tiles)
        p0, q0 = (t // q_tiles) * bm, (t % q_tiles) * bn
        hits[chunk, p0:p0 + bm, q0:q0 + bn] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("plan_of,smem", [
    (osgemm.wide_gram_plan, osgemm.WIDE.smem_gram),
    (osgemm.wide_expand_plan, osgemm.WIDE.smem_expand)])
@pytest.mark.parametrize("n,p,q", _WIDE_SHAPES[:8])
def test_wide_ring_fits_shared_memory(plan_of, smem, n, p, q):
    """The wide ring (STAGES k-slices of the operands, rows padded to the
    bank-conflict-free pitches) of WIDE.per_sm blocks fits an SM, and one
    block's fits a block's dynamic shared memory; WIDE is the shape that
    csrc/tall_gemm.cu launches."""
    wide = osgemm.WIDE
    plan = plan_of(n, p, q, 132)
    assert plan.smem == smem <= osgemm.SMEM_BLOCK
    assert wide.per_sm * (smem + 1024) <= osgemm.SM_SMEM
    pitch_a, pitch_m, pitch_n = wide.pitches
    assert pitch_a % 16 == 8 and pitch_m % 8 == 2 and pitch_n % 8 == 2
    assert wide.smem_gram == 8 * wide.stages * wide.k * (pitch_m + pitch_n)
    assert wide.smem_expand == 8 * wide.stages * (wide.bm * pitch_a
                                                  + wide.k * pitch_n)
    src = open(os.path.join(os.path.dirname(osgemm.__file__), "csrc",
                            "tall_gemm.cu")).read()
    shape = re.search(r"using WideShape = Wide<([\d, ]+)>;", src).group(1)
    assert tuple(int(v) for v in shape.split(",")) == (
        wide.wm, wide.wn, wide.mt, wide.nt, wide.k, wide.stages, wide.per_sm)


@pytest.mark.parametrize("nev,n", [(200, 157_464), (400, 85_184)])
def test_wide_classes_take_the_wide_path(nev, n):
    """The classes of a production-width solve with one side above 128 and
    the other at least 64 take the wide path, the rest the narrow one; the expand
    (n x m)(m x 2 nev) is one launch."""
    bs, size_x = nev // 5, 2 * nev
    m = size_x + 2 * bs
    for p, q in [(m, bs), (m - bs, bs), (size_x, size_x), (m, size_x),
                 (bs, bs)]:
        want = "wide" if max(p, q) > 128 and min(p, q) >= 64 else "narrow"
        assert osgemm.tall_path(p, q) == want
    assert osgemm.tall_path(size_x, size_x) == "wide"
    plan = osgemm.wide_expand_plan(n, m, size_x, 132)
    assert plan.blocks == -(-n // plan.band) * -(-size_x // plan.q_tile)
    assert osgemm.tall_path(bs, bs) == "narrow"


@pytest.mark.parametrize("p,q", _NEV50_GRAMS + _NEV50_EXPANDS)
def test_nev50_classes_keep_the_narrow_path(p, q):
    """The nev=50 classes stay on the narrow path's resident designs, with the plans
    they had: C resident in one launch, one output tile a Gram block."""
    assert osgemm.tall_path(p, q) == "narrow"
    plan = osgemm.expand_plan(157_464, p, q, 132)
    assert plan.q_tile >= q and plan.k_chunk >= p
    assert osgemm.gram_plan(157_464, p, q, 132).tiles == 1


@pytest.mark.parametrize("path", [None, "narrow", "wide"])
def test_tall_gemm_path_argument_on_cpu(path):
    """On CPU tensors every path runs the plain version; an unknown path
    raises."""
    rng = np.random.default_rng(11)
    a, b = rng.standard_normal((50, 130)), rng.standard_normal((50, 4))
    c = rng.standard_normal((130, 4))
    got = osgemm.tall_gram(torch.as_tensor(a), torch.as_tensor(b), path=path)
    np.testing.assert_array_equal(got.numpy(), osgemm.tall_gram_reference(
        torch.as_tensor(a), torch.as_tensor(b)).numpy())
    y = osgemm.tall_expand(torch.as_tensor(a), torch.as_tensor(c), path=path)
    np.testing.assert_array_equal(y.numpy(), osgemm.tall_expand_reference(
        torch.as_tensor(a), torch.as_tensor(c)).numpy())
    with pytest.raises(ValueError, match="path"):
        osgemm.tall_expand(torch.as_tensor(a), torch.as_tensor(c),
                           path="resident")


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


def _c_layouts():
    square = torch.zeros((482, 482), dtype=torch.float64)
    eigh_layout = torch.zeros((482, 482), dtype=torch.float64).T
    return {
        "row-major": (square[:480, :400], 1),
        "row-major, odd column offset": (square[:480, 1:401], 0),
        "column-major (eigh's eigenvectors)": (eigh_layout[:480, :400], 2),
        "column-major, odd row offset": (eigh_layout[1:481, :400], 0),
        "column-major, odd column stride": (
            torch.zeros((401, 481), dtype=torch.float64).T[:480, :400], 0),
        "one column of a column-major block": (eigh_layout[:480, :1], 2),
    }


@pytest.mark.parametrize("name", list(_c_layouts()))
def test_c_mode_by_layout(name):
    """The wide expand copies C's rows 16 bytes at a time where they start
    on 16 bytes (1), C's columns into a transposed stage where C is
    column-major with columns on 16 bytes (2), as the solver's eigenvector
    block is, and 8 bytes at a time otherwise (0)."""
    c, mode = _c_layouts()[name]
    assert osgemm.c_mode(c) == mode


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
    """Kernels 5 and 6's row tiles: every row of at most min(CSR_SPLIT,
    budget - 3) entries in exactly one tile, in order; a tile's entries,
    widened to 16-byte boundaries, fit the budget; no tile exceeds
    max_rows; a tile stops only where the next row would break one of the
    two limits or is left out."""
    rowptr = _rowptr(_row_cases()[case])
    n = len(rowptr) - 1
    tiles = onehot.csr_tiles(rowptr, budget, max_rows)
    assert tiles.dtype == np.int32 and tiles.shape == (len(tiles), 2)
    rp = rowptr.astype(np.int64)
    cap = min(onehot.CSR_SPLIT, budget - 3)
    kept = np.diff(rp) <= cap
    covered = np.zeros(n, np.int64)
    for r0, r1 in tiles:
        covered[r0:r1] += 1
        staged = -(-rp[r1] // 4) * 4 - rp[r0] // 4 * 4
        assert 1 <= r1 - r0 <= max_rows and staged <= budget
        if r1 < n and kept[r1]:    # greedy: the next row did not fit
            grown = -(-rp[r1 + 1] // 4) * 4 - rp[r0] // 4 * 4
            assert r1 - r0 == max_rows or grown > budget
    np.testing.assert_array_equal(covered, kept)
    assert np.all(tiles[1:, 0] >= tiles[:-1, 1])
    # every row longer than the budget (and every other row past the cap)
    # is in no tile: the split path takes it
    assert not covered[np.diff(rp) > budget].any()


def test_csr_tiles_reject_budgets_the_kernel_cannot_take():
    rowptr = _rowptr([3, 4])
    for budget in (0, 6, -4):
        with pytest.raises(ValueError, match="budget"):
            onehot.csr_tiles(rowptr, budget)
    with pytest.raises(ValueError, match="max_rows"):
        onehot.csr_tiles(rowptr, 8, 0)


def _level2_lengths(n=17_588):
    """Row lengths like the AMG level-2 operator of the cube FEM pair at
    nx=54: 17,588 rows of 400 to 1,289 entries, mean about 731."""
    rng = np.random.default_rng(2)
    lengths = np.clip(rng.normal(731, 160, n).round(), 400, 1289)
    lengths[[3, n // 2]] = [400, 1289]
    return lengths.astype(np.int64)


def _plan_cases():
    cases = dict(_row_cases())
    cases["AMG level 2 like"] = _level2_lengths()
    cases["split threshold edges"] = np.array(
        [onehot.CSR_SPLIT, onehot.CSR_SPLIT + 1, 0, onehot.CSR_PART,
         onehot.CSR_PART + 1, 3 * onehot.CSR_PART + 7, 5, 2449, 1])
    return cases


def _plan_of(rowptr):
    plan = onehot.csr_plan(torch.as_tensor(rowptr))
    split = plan.split.numpy()
    return (plan.tiles.numpy(), split[:plan.nsplit], split[plan.nsplit:],
            plan)


@pytest.mark.parametrize("case", list(_plan_cases()))
def test_csr_plan_covers_each_row_once(case):
    """Kernels 5 and 6's plan: every row of at most CSR_SPLIT entries lies in
    exactly one row tile, the tiles in row order and within the budget;
    every longer row (every row past the tile budget among them) lies in
    the split list, as parts 0..K-1 of K = ceil(len / CSR_PART) blocks,
    together and in order, the rows of more parts first and in row order
    within a count of parts; the rows of several parts are listed again for
    the second launch, their scratch slots numbered from 0 without gaps."""
    lengths = np.asarray(_plan_cases()[case], np.int64)
    rowptr = _rowptr(lengths)
    n = len(lengths)
    tiles, blocks, multi, plan = _plan_of(rowptr)
    long = lengths > onehot.CSR_SPLIT
    covered = np.zeros(n, np.int64)
    for r0, r1 in tiles:
        covered[r0:r1] += 1
        staged = -(-rowptr[r1] // 4) * 4 - rowptr[r0] // 4 * 4
        assert staged <= plan.budget and 1 <= r1 - r0 <= onehot.CSR_MAX_ROWS
    assert np.all(tiles[1:, 0] >= tiles[:-1, 1])
    np.testing.assert_array_equal(covered, ~long)
    assert not long[np.flatnonzero(covered)].any()
    # every row past the tile budget is in the split list
    assert set(np.flatnonzero(lengths > plan.budget)) <= set(blocks[:, 0])
    rows, first = np.unique(blocks[:, 0], return_index=True)
    np.testing.assert_array_equal(rows, np.flatnonzero(long))
    parts = -(-lengths[rows] // onehot.CSR_PART)
    assert len(blocks) == parts.sum() == plan.nsplit
    for r, i, k in zip(rows, first, parts):
        np.testing.assert_array_equal(blocks[i:i + k, 0], r)
        np.testing.assert_array_equal(blocks[i:i + k, 1], np.arange(k))
        np.testing.assert_array_equal(blocks[i:i + k, 2], k)
    heads = blocks[blocks[:, 1] == 0]
    order = np.lexsort((heads[:, 0], -heads[:, 2]))
    np.testing.assert_array_equal(order, np.arange(len(heads)))
    several = blocks[blocks[:, 2] > 1]
    np.testing.assert_array_equal(several[:, 3], np.arange(len(several)))
    assert np.all(blocks[blocks[:, 2] == 1, 3] == -1)
    firsts = several[several[:, 1] == 0]
    np.testing.assert_array_equal(
        multi.reshape(-1, 4), np.c_[firsts[:, 0], firsts[:, 3], firsts[:, 2],
                                    np.zeros(len(firsts), int)])
    assert plan.nmulti == len(multi) and plan.slots == len(several)


def _split_of_each_row(lengths):
    """Row -> (part, parts) of each of its split blocks, from the plan."""
    _, blocks, _, _ = _plan_of(_rowptr(lengths))
    out = {}
    for r, k, parts, _ in blocks:
        out.setdefault(int(r), []).append((int(k), int(parts)))
    return out


@pytest.mark.parametrize("case", ["long rows", "AMG level 2 like",
                                  "split threshold edges"])
def test_csr_split_depends_on_row_length_alone(case):
    """A row's path and its parts follow from its length alone: the same
    rows behind other rows, or cut out as a shard at any row (a rank's
    rows), get the same split, row for row."""
    lengths = np.asarray(_plan_cases()[case], np.int64)
    whole = _split_of_each_row(lengths)
    rng = np.random.default_rng(len(lengths))
    before = rng.integers(0, 3000, 17)
    moved = _split_of_each_row(np.concatenate([before, lengths]))
    assert {r - len(before): v for r, v in moved.items()
            if r >= len(before)} == whole
    for r0, r1 in [(0, len(lengths)), (1, len(lengths) - 1),
                   (len(lengths) // 3, len(lengths) // 3 + 5),
                   tuple(sorted(rng.integers(0, len(lengths), 2)))]:
        shard = _split_of_each_row(lengths[r0:r1])
        assert shard == {r - r0: v for r, v in whole.items() if r0 <= r < r1}


def test_csr_plan_puts_the_amg_level2_rows_on_the_split_path():
    """At the lengths of AMG level 2 (17,588 rows, mean about 731, at most
    1,289), no tile holds a row of more than CSR_SPLIT entries: every row
    runs on a block of its own, in one part."""
    lengths = _level2_lengths()
    assert lengths.max() == 1289 and 700 < lengths.mean() < 760
    tiles, blocks, multi, plan = _plan_of(_rowptr(lengths))
    assert len(tiles) == 0 and len(multi) == 0 and plan.slots == 0
    assert plan.nsplit == len(lengths)
    np.testing.assert_array_equal(np.sort(blocks[:, 0]),
                                  np.arange(len(lengths)))
    assert np.all(blocks[:, 1:] == [0, 1, -1])


def test_csr_part_is_the_kernels():
    """CSR_PART is the kernels' kPart, which sizes the shared memory where a
    block of the split path stages a part."""
    src = open(os.path.join(os.path.dirname(onehot.__file__), "csrc",
                            "csr_spmm.cu")).read()
    assert f"constexpr int kPart = {onehot.CSR_PART};" in src


def test_csr_split_rejects_what_it_cannot_plan():
    rowptr = _rowptr([3, 4])
    with pytest.raises(ValueError, match="split"):
        onehot.csr_split(rowptr, -1)
    with pytest.raises(ValueError, match="part"):
        onehot.csr_split(rowptr, 8, 0)


def _banded_csr(lengths, n_cols, seed):
    """A CSR matrix with rows of the given lengths, each a run of adjacent
    columns near its diagonal with a few scattered ones (the AMG coarse
    levels' shape), values standard normal; as numpy arrays."""
    rng = np.random.default_rng(seed)
    n = len(lengths)
    cols = []
    for r, d in enumerate(lengths):
        d = int(min(d, n_cols))
        centre = r * n_cols // max(n, 1)
        band = np.arange(centre - d // 2, centre - d // 2 + d) % n_cols
        keep = rng.random(d) < 0.8
        extra = rng.choice(n_cols, d - int(keep.sum()), replace=False)
        cols.append(np.unique(np.concatenate([band[keep], extra]))[:d])
    rowptr = _rowptr([len(c) for c in cols])
    colidx = np.concatenate(cols).astype(np.int32) if cols else \
        np.zeros(0, np.int32)
    return rowptr, colidx, rng.standard_normal(len(colidx))


def _tile_entries(vals, q):
    """The 16 x 8 tile q of ``csr_panels``' values, from its fragment
    order (lane 4 g + t holds (A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]))."""
    tile = np.zeros((16, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        tile[g, t], tile[g + 8, t], tile[g, t + 4], tile[g + 8, t + 4] = \
            vals[q, 4 * lane:4 * lane + 4]
    return tile


@pytest.mark.parametrize("case,n_cols", [
    ("AMG level 2 like", 17_588), ("AMG level 3 like", 1_350),
    ("long rows", 20_500), ("split threshold edges", 7_000)])
def test_csr_panels_cover_each_row_once(case, n_cols):
    """The panel path's plan (csr_plan with colidx, f64 values and the
    columns): in a matrix with split rows, every row of more than PANEL_MIN
    entries lies in exactly one panel slot, in row order; each panel's
    k-groups are distinct and in column order within each column chunk
    (fixed by the columns alone); the tiles, read back from the fragment
    order, hold exactly the rows' entries at their columns; every other row
    lies in exactly one row tile of the tile path, within its budget; the
    combine lists each panel row's chunk sums; ``fill`` counts the entries
    in the tiles' slots.  The kernel takes no shared memory."""
    if case == "AMG level 3 like":
        lengths = np.random.default_rng(3).integers(700, 1_350, 200)
    else:
        lengths = np.asarray(_plan_cases()[case], np.int64)[:300]
    lengths = np.minimum(lengths, n_cols)
    rowptr, colidx, values = _banded_csr(lengths, n_cols, len(lengths))
    plan = onehot.csr_plan(torch.as_tensor(rowptr), torch.as_tensor(colidx),
                           torch.as_tensor(values), n_cols)
    pn = plan.panels
    lengths = np.diff(rowptr.astype(np.int64))
    want = np.flatnonzero(lengths > onehot.PANEL_MIN)
    assert pn is not None and plan.nsplit > 0
    rows, ptr = pn.rows.numpy(), pn.ptr.numpy()
    kcol, vals, multi = pn.kcol.numpy(), pn.vals.numpy(), pn.multi.numpy()
    np.testing.assert_array_equal(rows, want)
    chunks = onehot.panel_chunks(n_cols)
    assert pn.chunks == chunks and len(ptr) == pn.npanels * chunks + 1
    assert pn.npanels == -(-len(rows) // onehot.PANEL_ROWS)
    assert ptr[0] == 0 and ptr[-1] == len(kcol) and np.all(np.diff(ptr) >= 0)
    width = -(-n_cols // chunks)
    dense = {}
    for p in range(pn.npanels):
        got = np.zeros((onehot.PANEL_ROWS, n_cols + onehot.PANEL_K))
        for c in range(chunks):
            ks = kcol[ptr[p * chunks + c]:ptr[p * chunks + c + 1]]
            assert np.all(np.diff(ks) > 0) and np.all(ks % onehot.PANEL_K == 0)
            assert np.all(ks // width == c)
            for q in range(ptr[p * chunks + c], ptr[p * chunks + c + 1]):
                got[:, kcol[q]:kcol[q] + onehot.PANEL_K] += \
                    _tile_entries(vals, q)
        for i in range(onehot.PANEL_ROWS):
            k = p * onehot.PANEL_ROWS + i
            if k < len(rows):
                dense[rows[k]] = got[i, :n_cols]
            else:
                assert not got[i].any()
    for r in rows:
        row = np.zeros(n_cols)
        row[colidx[rowptr[r]:rowptr[r + 1]]] = values[rowptr[r]:rowptr[r + 1]]
        np.testing.assert_array_equal(dense[r], row)
    covered = np.zeros(len(lengths), np.int64)
    for r0, r1 in pn.tiles.numpy():
        covered[r0:r1] += 1
        staged = -(-rowptr[r1] // 4) * 4 - rowptr[r0] // 4 * 4
        assert staged <= plan.budget
    np.testing.assert_array_equal(covered, lengths <= onehot.PANEL_MIN)
    np.testing.assert_array_equal(
        multi, np.c_[rows, np.arange(len(rows)) * chunks,
                     np.full(len(rows), chunks), np.zeros(len(rows), int)])
    assert pn.fill == pytest.approx(lengths[rows].sum() / vals.size)
    src = open(os.path.join(os.path.dirname(onehot.__file__), "csrc",
                            "csr_spmm.cu")).read()
    assert "fn<<<grid, (unsigned)(32 * warps), 0," in src


def test_csr_panels_only_with_split_rows_and_f64_values():
    """No panels without split rows, without colidx and values, for f32
    values, or where a row holds a column twice; the chunks follow the
    columns alone."""
    short = _rowptr([3, 5, 0, 7])
    cols = np.array([0, 1, 2, 0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 5, 6], np.int32)
    vals = np.ones(len(cols))
    plan = onehot.csr_plan(torch.as_tensor(short), torch.as_tensor(cols),
                           torch.as_tensor(vals), 7)
    assert plan.panels is None
    rowptr, colidx, values = _banded_csr([400, 20, 300], 500, 1)
    rp, ci = torch.as_tensor(rowptr), torch.as_tensor(colidx)
    assert onehot.csr_plan(rp).panels is None
    assert onehot.csr_plan(rp, ci, torch.as_tensor(values).float(),
                           500).panels is None
    assert onehot.csr_plan(rp, ci, torch.as_tensor(values), 500).panels
    twice = colidx.copy()
    twice[1] = twice[0]
    assert onehot.csr_panels(rowptr, twice, values, np.array([0]),
                             500) is None
    v = torch.as_tensor(values)
    plan = onehot.csr_plan(rp, ci, v, 500)
    full = plan.panels.fill >= onehot.PANEL_FILL
    # past CSR_WIDE_M the rows the panels do not take run on the wide path
    assert onehot.csr_path(plan, v, 75) == ("panel" if full else "wide")
    assert onehot.csr_path(plan, v, 10) == "split"
    assert onehot.csr_path(plan, v.clone(), 75) == "wide"
    assert [onehot.panel_chunks(n) for n in (1, 512, 513, 1_350, 4_096,
                                             4_097, 17_588)] == \
        [1, 1, 2, 3, 8, 1, 1]


@pytest.mark.parametrize("npanels,m", [(1091, 75), (255, 75), (1091, 10),
                                       (85, 10), (1091, 40), (3, 160),
                                       (1, 1)])
def test_panel_launch_covers_the_columns(npanels, m):
    """A panel launch: 5 n-tiles a warp where that leaves four warps an SM
    (132 SMs), else 2; a block of four panels where that leaves two blocks
    an SM, else one; the slabs cover all m columns."""
    warps, nt = onehot.panel_launch(npanels, m, 132)
    ntiles = -(-m // 8)
    assert nt in (2, 5) and warps in (1, 4)
    assert nt == 2 or npanels * -(-ntiles // 5) >= 4 * 132
    assert -(-m // (8 * nt)) * 8 * nt >= m
    blocks = -(-npanels // 4) * -(-ntiles // nt)
    assert (warps == 4) == (blocks >= 2 * 132)
    assert onehot.panel_launch(1091, 75, 132) == (4, 5)
    assert onehot.panel_launch(85, 75, 132) == (1, 2)


@pytest.mark.parametrize("case", list(_row_cases()))
def test_csr_tiles_leave_out_rows_past_longest(case):
    """``csr_tiles(..., longest=PANEL_MIN)``: the tile path's rows where the
    panel path takes the others, every row of at most PANEL_MIN entries in
    exactly one tile within the budget."""
    rowptr = _rowptr(_row_cases()[case])
    tiles = onehot.csr_tiles(rowptr, longest=onehot.PANEL_MIN)
    rp = rowptr.astype(np.int64)
    covered = np.zeros(len(rp) - 1, np.int64)
    for r0, r1 in tiles:
        covered[r0:r1] += 1
        assert -(-rp[r1] // 4) * 4 - rp[r0] // 4 * 4 <= onehot.CSR_BUDGET
    np.testing.assert_array_equal(covered, np.diff(rp) <= onehot.PANEL_MIN)


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


# ---- the wide path of kernels 1 and 2 (csrc/dia_spmm.cu, dia_spmm_wide) ----

# (name, item, m, x strides, x data_ptr % 16, y strides) of the operands a
# solve hands kernels 1 and 2, and the path the plan must take
_SOLVE_OPERANDS = [
    ("f32 CG m=10", 4, 10, (10, 1), 0, (10, 1), "narrow"),
    ("f32 CG m=40", 4, 40, (40, 1), 0, (40, 1), "wide"),
    ("f32 CG m=80", 4, 80, (80, 1), 0, (80, 1), "wide"),
    ("f32 halo (nw, 10)", 4, 10, (10, 1), 0, (10, 1), "narrow"),
    ("f64 V[:, 110:120]", 8, 10, (120, 1), 0, (10, 1), "narrow"),
    ("f64 ritz[:, 41:51]", 8, 10, (100, 1), 8, (10, 1), "narrow"),
    ("f64 refresh (n, 10)", 8, 10, (10, 1), 0, (10, 1), "narrow"),
    ("f64 ritz[:, 40:60]", 8, 20, (100, 1), 0, (20, 1), "wide"),
    ("f64 ritz[:, 41:61]", 8, 20, (100, 1), 8, (20, 1), "wide"),
    ("f64 gathered (n, 20)", 8, 20, (20, 1), 0, (20, 1), "wide"),
    ("f64 V[:, :100]", 8, 100, (120, 1), 0, (100, 1), "wide"),
    ("f64 V[:, 440:480]", 8, 40, (480, 1), 0, (40, 1), "wide"),
    ("f64 V[:, 880:960]", 8, 80, (960, 1), 0, (80, 1), "wide"),
    ("f64 ritz[:, 41:81]", 8, 40, (400, 1), 8, (40, 1), "wide"),
    ("f64 ritz[:, 41:121]", 8, 80, (800, 1), 8, (80, 1), "wide"),
    ("f64 refresh (n, 40)", 8, 40, (40, 1), 0, (40, 1), "wide"),
    ("f64 V[:, :400]", 8, 400, (480, 1), 0, (400, 1), "wide"),
    ("f64 V[:, :800]", 8, 800, (960, 1), 0, (800, 1), "wide"),
    ("f64 PAS (n, 75)", 8, 75, (75, 1), 0, (75, 1), "wide"),
    ("f64 PAS (n, 150)", 8, 150, (150, 1), 0, (150, 1), "wide"),
    ("f64 (100, n) transposed", 8, 100, (1, 5000), 0, (1, 5000), "narrow"),
    ("f32 (40, n) contiguous", 4, 40, (1, 5000), 0, (1, 5000), "narrow"),
]


@pytest.mark.parametrize("case", _SOLVE_OPERANDS, ids=lambda c: c[0])
def test_dia_plan_picks_the_wide_path_past_one_tile(case):
    """The plan takes the wide path at the wide solves' operands (the CG's
    (40, n) and (80, n), the windows of V and of the Ritz block, the f64
    refresh, the initial Rayleigh-Ritz's V[:, :size_x]) and at the
    headline's past one tile (the phased loop's 20-wide residual windows,
    the gathered (n, 20), V[:, :100]), and keeps the narrow one at m = 10
    (headline, FEM level 0, halo rows) and where columns are not adjacent;
    the narrow fields are those of the narrow plan."""
    _, item, m, (xs_i, xs_j), ptr, (ys_i, ys_j), want = case
    plan = spmm.dia_plan(m, xs_i, xs_j, ptr, ys_i, ys_j, 0, item)
    assert ("wide" if plan.wide else "narrow") == want
    narrow = spmm.dia_plan(m, xs_i, xs_j, ptr, ys_i, ys_j, 0, item, "narrow")
    assert narrow.wide is None
    assert (plan.vec, plan.col_tile, plan.flat, plan.rows16,
            plan.row_fast) == (narrow.vec, narrow.col_tile, narrow.flat,
                               narrow.rows16, narrow.row_fast)
    # the wide path takes it when asked where columns are adjacent and rows
    # a multiple of 16 bytes apart, or of 8 in f64 (two phases)
    if xs_j == 1 and (xs_i * item % 16 == 0 or item == 8):
        assert spmm.dia_plan(m, xs_i, xs_j, ptr, ys_i, ys_j, 0, item,
                             "wide").wide is not None
    else:
        with pytest.raises(ValueError, match="wide path cannot"):
            spmm.dia_plan(m, xs_i, xs_j, ptr, ys_i, ys_j, 0, item, "wide")


def _cover(w, n, m):
    """How often the wide launch of plan ``w`` writes each entry of an
    (n, m) product, by the kernel's own mapping: block (row block, slab),
    thread t of G = width / vec column groups: group t % G, rows
    (t // G) items + r."""
    count = np.zeros((n, m), dtype=np.int64)
    for i0 in range(0, n, w.rows):
        for c0, width in w.slabs(m):
            groups = width // w.vec
            for t in range(min(w.threads, groups * w.rt)):
                b, g = divmod(t, groups)
                for r in range(w.items):
                    a = i0 + b * w.items + r
                    if a < n:
                        c = c0 + g * w.vec
                        count[a, c:c + w.vec] += 1
    return count


@pytest.mark.parametrize("m", [12, 40, 44, 80, 100, 800])
@pytest.mark.parametrize("item,off", [(4, 0), (4, 1), (8, 0), (8, 1)])
def test_dia_wide_plan_covers_each_entry_once(m, item, off):
    """Forced onto the wide path, a column view at an even or odd offset of
    a wider basis: every (row, column) of y is written by exactly one thread
    of one block; slabs of whole 16-byte groups (or one of all m); at most
    DIA_WIDE_THREADS threads; every window row starts on 16 bytes and holds
    its segment; the ring of DIA_WIDE_STAGES stages fits what the block
    asks and the card's limit."""
    width = m + 8
    plan = spmm.dia_plan(m, width, 1, off * item % 16, m, 1, 0, item, "wide")
    w = plan.wide
    per16 = 16 // item
    n = 2 * w.rows + 5                 # a part-full last block
    assert (_cover(w, n, m) == 1).all()
    slabs = w.slabs(m)
    assert sum(width for _, width in slabs) == m
    assert len(slabs) == 1 or w.slab % per16 == 0
    assert all(width % w.vec == 0 for _, width in slabs)
    assert w.slab <= spmm.DIA_SLAB and w.threads <= spmm.DIA_WIDE_THREADS
    assert w.sh == off * item % 16 // item and w.sh % w.vec == 0
    rows = w.rows + spmm.DIA_RUN - 1
    window = w.stage_elems() - spmm.DIA_RUN * w.rows
    for a in range(rows):
        assert w.window_row(a) % per16 == 0
        assert w.window_row(a) + w.sh + w.slab <= window
        assert w.window_row(a) + w.ld <= window
    assert w.smem == spmm.DIA_WIDE_STAGES * item * w.stage_elems()
    assert w.smem <= 227 * 1024       # what a block may opt in to (H100)


@pytest.mark.parametrize("case", [c for c in _SOLVE_OPERANDS
                                  if c[-1] == "wide"], ids=lambda c: c[0])
def test_dia_wide_skew_spreads_a_warp_over_the_banks(case):
    """At the wide solves' operands, the reads of one window row by a warp
    (thread t: column group t % G of row block t // G) that shared memory
    serves together (128 bytes' worth) touch 32 different banks."""
    _, item, m, (xs_i, xs_j), ptr, (ys_i, ys_j), _ = case
    w = spmm.dia_plan(m, xs_i, xs_j, ptr, ys_i, ys_j, 0, item).wide
    groups = w.slab // w.vec
    active = groups * w.rt
    width = w.vec * item                       # bytes a thread reads
    for step in range(w.items + spmm.DIA_RUN - 1):
        addr = []
        for t in range(active):
            b, g = divmod(t, groups)
            addr.append((w.window_row(b * w.items + step) + w.sh
                         + g * w.vec) * item)
        for t0 in range(0, active - active % 32, 128 // width):
            banks = [(a // 4 + k) % 32 for a in addr[t0:t0 + 128 // width]
                     for k in range(width // 4)]
            assert len(set(banks)) == len(banks) == 32


# the plans of the operands the wide path took before f64 rows of two
# 16-byte phases joined it: (name, item, m, x strides, x data_ptr % 16, y
# strides, narrow fields (vec, col_tile, flat, rows16, row_fast), wide
# fields (vec, slab, rt, ld, skew, sh) or None)
_PLANS_BEFORE = [
    ("f64 V[:, 110:120]", 8, 10, (120, 1), 0, (10, 1),
     (2, 10, False, True, False), None),
    ("f64 refresh (n, 10)", 8, 10, (10, 1), 0, (10, 1),
     (2, 10, False, True, False), None),
    ("f32 CG m=10", 4, 10, (10, 1), 0, (10, 1), (2, 10, True, False, False),
     None),
    ("f64 PAS (n, 150)", 8, 150, (150, 1), 0, (150, 1),
     (2, 10, False, True, False), (2, 76, 3, 76, 12, 0)),
    ("f64 V[:, 440:480]", 8, 40, (480, 1), 0, (40, 1),
     (2, 10, False, True, False), (2, 40, 6, 40, 8, 0)),
    ("f64 V[:, 880:960]", 8, 80, (960, 1), 0, (80, 1),
     (2, 10, False, True, False), (2, 80, 3, 80, 0, 0)),
    ("f32 CG m=40", 4, 40, (40, 1), 0, (40, 1), (4, 20, False, False, False),
     (4, 40, 12, 40, 8, 0)),
    ("f32 CG m=80", 4, 80, (80, 1), 0, (80, 1), (4, 20, False, False, False),
     (4, 80, 6, 80, 16, 0)),
    ("f64 ritz[:, 41:81]", 8, 40, (400, 1), 8, (40, 1),
     (2, 10, False, False, False), (1, 40, 3, 42, 8, 1)),
    ("f64 ritz[:, 41:121]", 8, 80, (800, 1), 8, (80, 1),
     (2, 10, False, False, False), (1, 80, 1, 82, 0, 1)),
    ("f64 ritz[:, 41:61]", 8, 20, (100, 1), 8, (20, 1),
     (2, 10, False, False, False), (1, 20, 6, 22, 4, 1)),
]


@pytest.mark.parametrize("case", _PLANS_BEFORE, ids=lambda c: c[0])
def test_dia_plans_of_the_one_phase_operands_are_unchanged(case):
    """Every m = 10 operand keeps the narrow path, and the wide path's
    operands of one 16-byte phase ((n, 150), m = 40 and 80, the odd-offset
    ritz windows) keep their plans field for field."""
    name, item, m, (xs_i, xs_j), ptr, (ys_i, ys_j), narrow, wide = case
    plan = spmm.dia_plan(m, xs_i, xs_j, ptr, ys_i, ys_j, 0, item)
    assert (plan.vec, plan.col_tile, plan.flat, plan.rows16,
            plan.row_fast) == narrow
    w = plan.wide
    assert (None if w is None else (w.vec, w.slab, w.rt, w.ld, w.skew,
                                    w.sh)) == wide
    assert w is None or not w.two


def test_dia_plan_takes_the_wide_path_at_pas_block():
    """PAS's contiguous (n, 75) f64 block (rows 600 bytes apart, two 16-byte
    phases) takes the wide path: one slab, one element a read, room for the
    higher phase in each window row."""
    w = spmm.dia_plan(75, 75, 1, 0, 75, 1, 0, item=8).wide
    assert w is not None and w.two
    assert (w.vec, w.slab, w.rt, w.sh, w.items) == (1, 75, 1, 0, 16)
    assert w.ld >= 1 + 75 and w.ld % 2 == 0
    # the same rows at an odd start (a view at an odd column) too
    w1 = spmm.dia_plan(75, 151, 1, 8, 75, 1, 0, item=8).wide
    assert w1.two and w1.sh == 1
    # in f32 a row stride 8 bytes past 16 keeps the narrow path
    assert spmm.dia_plan(75, 78, 1, 0, 75, 1, 0, item=4).wide is None


@pytest.mark.parametrize("m,width,off", [(75, 75, 0), (75, 151, 1),
                                         (21, 23, 0), (74, 75, 1),
                                         (161, 161, 0)])
def test_dia_two_phase_plan_covers_each_entry_once(m, width, off):
    """f64 rows an odd number of doubles apart, forced onto the wide path:
    every (row, column) of y written by exactly one thread of one block;
    whole 16-byte slabs (or one of all m); each window row starts on 16
    bytes and holds its segment at either phase, within the stage."""
    plan = spmm.dia_plan(m, width, 1, off * 8 % 16, m, 1, 0, 8, "wide")
    w = plan.wide
    assert w.two and w.vec == 1 and w.sh == off % 2
    n = 2 * w.rows + 5
    assert (_cover(w, n, m) == 1).all()
    slabs = w.slabs(m)
    assert sum(width for _, width in slabs) == m
    assert len(slabs) == 1 or w.slab % 2 == 0
    assert w.threads <= spmm.DIA_WIDE_THREADS
    rows = w.rows + spmm.DIA_RUN - 1
    window = w.stage_elems() - spmm.DIA_RUN * w.rows
    for a in range(rows):
        assert w.window_row(a) % 2 == 0
        for phase in (0, 1):
            assert w.window_row(a) + phase + w.slab <= w.window_row(a) + w.ld
        assert w.window_row(a) + w.ld <= window
    assert w.smem <= 227 * 1024


def test_dia_path_argument_on_the_cpu(dia12):
    """``path=`` on a CPU tensor takes the plain version whatever it asks,
    counts no launch, and refuses a name it does not know."""
    n = dia12.shape[0]
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((n, 40)))
    before = dict(spmm.LAUNCHES)
    ref = spmm.dia_spmm_reference(dia12.values, dia12.offsets_t, x)
    for path in (None, "narrow", "wide"):
        got = spmm.dia_spmm(dia12.values, dia12.offsets_t, x, path=path)
        assert torch.equal(got, ref)
    assert spmm.LAUNCHES == before
    with pytest.raises(ValueError, match="path"):
        spmm.dia_spmm(dia12.values, dia12.offsets_t, x, path="tiles")


@pytest.mark.parametrize("case", list(_row_cases()))
def test_csr_plan_serves_both_dtypes(case):
    """One plan for kernels 5 and 6: the tiles csr_tiles gives at
    CSR_BUDGET, (first row, end) pairs whose entries fit 48 KB of shared
    memory at 8 bytes (f32) and at 12 bytes (f64) each, and whose 16-byte
    copies start on 4 entries (16 bytes of colidx, 16 or 32 of values); then
    csr_split's blocks and rows of several parts.  The split path's two
    buffers of warp sums (8 warps of 32 lanes of 2 doubles in f64, 4 warps
    of 4 floats in f32) fit the same shared memory."""
    rowptr = _rowptr(_row_cases()[case])
    plan = onehot.csr_plan(torch.as_tensor(rowptr))
    np.testing.assert_array_equal(plan.tiles.numpy(),
                                  onehot.csr_tiles(rowptr, onehot.CSR_BUDGET))
    blocks, multi = onehot.csr_split(rowptr)
    np.testing.assert_array_equal(plan.split.numpy(),
                                  np.concatenate([blocks, multi]))
    assert (plan.nsplit, plan.nmulti) == (len(blocks), len(multi))
    assert plan.tiles.dtype == plan.split.dtype == torch.int32
    assert plan.budget == onehot.CSR_BUDGET and plan.budget % 4 == 0
    for item, warps, lanes in ((4, 4, 4), (8, 8, 2)):
        assert plan.budget * (4 + item) <= 48 * 1024
        assert 2 * warps * 32 * lanes * item <= plan.budget * (4 + item)



def _delaunay_rcm(g: int = 10):
    """The P1 stiffness matrix of a Delaunay mesh of g^3 points (seed 1) in
    RCM order, as scipy CSR: the irregular cell's shape at a small size."""
    import scipy.sparse as sps
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from gcge_tpu_torch.io.fem import assemble_p1, random_delaunay_mesh

    rows, cols, av, _, n = assemble_p1(*random_delaunay_mesh(g ** 3, seed=1))
    a = sps.coo_matrix((av, (rows, cols)), shape=(n, n)).tocsr()
    perm = reverse_cuthill_mckee(a, symmetric_mode=True)
    return a[perm][:, perm].tocsr()


def _wide_cases():
    cases = dict(_plan_cases())
    cases["delaunay 10^3 rcm"] = _delaunay_rcm().indptr
    return cases


@pytest.mark.parametrize("case", list(_wide_cases()))
def test_csr_plan_wide_tiles_cover_each_row_once(case):
    """The wide path's tiles (``plan.wide``): csr_tiles' at CSR_WIDE_BUDGET
    and CSR_WIDE_ROWS, every row of at most CSR_SPLIT entries in exactly one
    of them, in order and within the budget, the longer rows left to the
    same split blocks as the 64-row tiles leave them to."""
    c = _wide_cases()[case]
    rowptr = c.astype(np.int32) if case.startswith("delaunay") else \
        _rowptr(np.asarray(c, np.int64))
    tiles, blocks, _, plan = _plan_of(rowptr)
    wide = plan.wide.numpy()
    assert plan.wide.dtype == torch.int32
    np.testing.assert_array_equal(
        wide, onehot.csr_tiles(rowptr, onehot.CSR_WIDE_BUDGET,
                               onehot.CSR_WIDE_ROWS))
    rp = rowptr.astype(np.int64)
    covered = np.zeros(len(rp) - 1, np.int64)
    for r0, r1 in wide:
        covered[r0:r1] += 1
        assert -(-rp[r1] // 4) * 4 - rp[r0] // 4 * 4 <= onehot.CSR_WIDE_BUDGET
        assert 1 <= r1 - r0 <= onehot.CSR_WIDE_ROWS
    assert np.all(wide[1:, 0] >= wide[:-1, 1])
    np.testing.assert_array_equal(covered, np.diff(rp) <= onehot.CSR_SPLIT)
    in_tiles = np.zeros(len(rp) - 1, np.int64)
    for r0, r1 in tiles:
        in_tiles[r0:r1] += 1
    np.testing.assert_array_equal(covered, in_tiles)
    assert not covered[blocks[:, 0]].any() if len(blocks) else True


def test_csr_wide_budget_fits_the_kernels():
    """The wide tiles stage no more than a tile of the 64-row plan (a budget
    the kernels take: a positive multiple of 4 whose entries fit 48 KB in
    both types), and every row the split path leaves to tiles fits it."""
    budget = onehot.CSR_WIDE_BUDGET
    assert 0 < budget <= onehot.CSR_BUDGET and budget % 4 == 0
    assert onehot.CSR_SPLIT <= budget - 3
    assert 0 < onehot.CSR_WIDE_ROWS <= onehot.CSR_MAX_ROWS


@pytest.mark.parametrize("m,want", [(1, "split"), (10, "split"),
                                    (20, "split"), (21, "wide"),
                                    (40, "wide"), (75, "wide"),
                                    (400, "wide")])
def test_csr_path_takes_the_wide_path_past_csr_wide_m(m, want):
    """csr_path by m: the 64-row tiles up to CSR_WIDE_M columns, the wide
    path's above, in both types, with or without long rows; the panel path
    where the plan holds full panels for the values (m of at least
    CSR_PANEL_M) before either."""
    rowptr = _rowptr([3, 5, 0, 7])
    cols = np.array([0, 1, 2, 0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 5, 6], np.int32)
    values = torch.ones(len(cols), dtype=torch.float64)
    plan = onehot.csr_plan(torch.as_tensor(rowptr), torch.as_tensor(cols),
                           values, 7)
    assert onehot.csr_path(plan, values, m) == want
    assert onehot.csr_path(plan, values.float(), m) == want
    long_rp, long_ci, long_v = _banded_csr([400, 20, 300], 500, 1)
    v = torch.as_tensor(long_v)
    long_plan = onehot.csr_plan(torch.as_tensor(long_rp),
                                torch.as_tensor(long_ci), v, 500)
    full = long_plan.panels.fill >= onehot.PANEL_FILL
    panel = full and m >= onehot.CSR_PANEL_M
    assert onehot.csr_path(long_plan, v, m) == ("panel" if panel else want)
    assert onehot.csr_path(long_plan, v.float(), m) == want
