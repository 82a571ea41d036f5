"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one.  They import neither
JAX nor gcge_tpu, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from gcge_tpu_torch import HybridOperator, make_operator, solve
from gcge_tpu_torch.io.fem import (assemble_p1, cube_fem_laplacian,
                                   random_delaunay_mesh)
from gcge_tpu_torch.benchmarks.pallas_isolate import make_planes
from gcge_tpu_torch.ops import _build, eighs, onehot, osgemm, probes, spmm
from gcge_tpu_torch.solvers import gcg, multigrid
from gcge_tpu_torch.solvers.bpcg import BlockPCGParams
from gcge_tpu_torch.solvers.orth import bgs_orth

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _laplacian_27(nx: int):
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


def _operand(layout, n, m, dtype, device, seed):
    """x for an SpMM of n rows, as ``(x, transposed)``: ``nm`` (n, m)
    row-major, ``nm view`` a column slice of a wider basis, ``mn`` a
    contiguous (m, n), ``mn view`` the transpose of a column slice, ``cg``
    the mixed inner CG's operand, (m, n) in shape and (n, m) in memory."""
    g = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn((n, m + 3), generator=g, dtype=dtype, device=device)
    x = {"nm": base[:, :m].contiguous(), "nm view": base[:, 2:2 + m],
         "mn": base[:, :m].T.contiguous(), "mn view": base[:, 2:2 + m].T,
         "cg": base[:, :m].contiguous().T}[layout]
    return x, layout.startswith(("mn", "cg"))


def _follows(y, x):
    """y lies in the memory order of x: x's strides where x is dense, else
    contiguous."""
    dense = x.is_contiguous() or x.T.is_contiguous()
    return y.stride() == x.stride() if dense and min(x.shape) > 1 \
        else y.is_contiguous()


_LAYOUTS = ["nm", "nm view", "mn", "mn view", "cg"]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-14),
                                       (torch.float32, 1e-6)])
@pytest.mark.parametrize("m", [1, 10, 16, 40, 80])
@pytest.mark.parametrize("layout", _LAYOUTS)
def test_dia_kernel_matches_plain(cuda, dtype, tol, m, layout):
    """Kernels 1 and 2 against the plain version in every layout: within
    tol of max |A||x| (sums of 27 terms in the working type), equal bits
    across two launches, the product in the memory order of x."""
    rows, cols, vals, n = _laplacian_27(12)
    op = make_operator(rows, cols, vals, (n, n), dtype=dtype, device=cuda)
    x, transposed = _operand(layout, n, m, dtype, cuda, 0)
    key = "dia_f64" if dtype == torch.float64 else "dia_f32"
    before = spmm.LAUNCHES[key]
    got = spmm.dia_spmm(op.values, op.offsets_t, x, transposed)
    again = spmm.dia_spmm(op.values, op.offsets_t, x, transposed)
    assert spmm.LAUNCHES[key] == before + 2
    assert got.shape == x.shape and torch.equal(got, again)
    assert _follows(got, x)
    ref = spmm.dia_spmm_reference(op.values, op.offsets_t, x, transposed)
    scale = spmm.dia_spmm_reference(op.values.abs(), op.offsets_t, x.abs(),
                                    transposed).max()
    assert float((got - ref).abs().max()) <= tol * float(scale)


@pytest.mark.parametrize("layout", _LAYOUTS)
def test_dia_f32_kernel_runs_and_edges(cuda, layout):
    """Kernel 2 with offsets in no order: a run of 20 consecutive offsets
    (longer than one staged window serves), lone offsets, offsets past
    either end of the matrix, and an odd n that leaves the last block
    part-full; against the plain version."""
    n, m = 1001, 10
    offsets = list(range(-10, 10)) + [400, -3, n + 5, -(n + 2), 999, -1000]
    rng = np.random.default_rng(8)
    values = torch.as_tensor(rng.standard_normal((len(offsets), n)),
                             dtype=torch.float32, device=cuda)
    offs = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    x, transposed = _operand(layout, n, m, torch.float32, cuda, 1)
    got = spmm.dia_spmm(values, offs, x, transposed)
    assert torch.equal(got, spmm.dia_spmm(values, offs, x, transposed))
    assert _follows(got, x)
    ref = spmm.dia_spmm_reference(values, offs, x, transposed)
    scale = spmm.dia_spmm_reference(values.abs(), offs, x.abs(),
                                    transposed).max()
    assert float((got - ref).abs().max()) <= 1e-6 * float(scale)


def _solve_operand(kind, n, m, device, seed):
    """An f64 column view of the kind a solve hands kernels 1 and 6:
    ``even``, ``V[:, o:o + m]`` of an (n, 120) basis at the even offset
    ``o = 120 - m`` rounded down to even (the W coupling ``V[:, 110:120]``,
    the initial Rayleigh-Ritz ``V[:, :100]`` at m = 100 from another even
    offset), rows 16-byte aligned; ``odd``, ``ritz[:, 41:41 + m]`` of a
    Ritz block at least 100 wide (the residual window), rows 8-byte aligned
    only."""
    g = torch.Generator(device=device).manual_seed(seed)
    if kind == "even":
        base = torch.randn((n, 120), generator=g, dtype=torch.float64,
                           device=device)
        off = (120 - m) // 2 * 2
    else:
        base = torch.randn((n, max(100, 41 + m)), generator=g,
                           dtype=torch.float64, device=device)
        off = 41
    x = base[:, off:off + m]
    assert x.data_ptr() % 16 == (0 if kind == "even" else 8)
    return x


def _check_f64_spmm(apply, plain, plain_abs, x, transposed, key, counters,
                    dense=None):
    """Two launches with equal bits, the product in the memory order of x,
    within 1e-14 of max |A||x| of the plain version (and of scipy's product
    where ``dense`` gives A on the host)."""
    before = counters[key]
    got, again = apply(x, transposed), apply(x, transposed)
    assert counters[key] == before + 2
    assert got.shape == x.shape and torch.equal(got, again)
    assert _follows(got, x)
    scale = float(plain_abs(x.abs(), transposed).max())
    assert float((got - plain(x, transposed)).abs().max()) <= 1e-14 * scale
    if dense is not None:
        xn = (x.T if transposed else x).cpu().numpy()
        y = (got.T if transposed else got).cpu().numpy()
        assert np.abs(y - dense @ xn).max() <= 1e-14 * scale
    return got


@pytest.mark.parametrize("m", [1, 10, 16, 100])
@pytest.mark.parametrize("kind", ["even", "odd", "nm", "mn", "mn view"])
def test_dia_f64_kernel_at_the_solve_operands(cuda, m, kind):
    """Kernel 1 on the operands a solve hands it (column views of V at an
    even and an odd offset) and the other layouts, at m in {1, 10, 16,
    100}, on the 27-point Laplacian at nx = 12 (n = 1,728: thirteen full
    blocks of 128 rows and a part-full last one)."""
    rows, cols, vals, n = _laplacian_27(12)
    op = make_operator(rows, cols, vals, (n, n), device=cuda)
    if kind in ("even", "odd"):
        x, transposed = _solve_operand(kind, n, m, cuda, m), False
    else:
        x, transposed = _operand(kind, n, m, torch.float64, cuda, m)
    dense = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    _check_f64_spmm(
        lambda z, t: spmm.dia_spmm(op.values, op.offsets_t, z, t),
        lambda z, t: spmm.dia_spmm_reference(op.values, op.offsets_t, z, t),
        lambda z, t: spmm.dia_spmm_reference(op.values.abs(), op.offsets_t,
                                             z, t),
        x, transposed, "dia_f64", spmm.LAUNCHES, dense)


@pytest.mark.parametrize("width,size_x,m", [(480, 400, 40), (960, 800, 80)])
@pytest.mark.parametrize("window", ["W coupling", "residual"])
def test_dia_kernels_at_the_wide_solve_operands(cuda, width, size_x, m,
                                                window):
    """Kernel 1 on the windows of the wide solves: the W coupling
    ``V[:, width - m:width]`` of the (n, width) basis (rows 16-byte
    aligned) and a residual window ``ritz[:, 41:41 + m]`` of the (n,
    size_x) Ritz block at an odd offset (8-byte aligned only); kernel 2 at
    the CG's ``(m, n)`` operand with strides ``(1, m)``; on the 27-point
    Laplacian at nx = 12."""
    rows, cols, vals, n = _laplacian_27(12)
    op = make_operator(rows, cols, vals, (n, n), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(width + m)
    parent = width if window == "W coupling" else size_x
    base = torch.randn((n, parent), generator=g, dtype=torch.float64,
                       device=cuda)
    x = base[:, width - m:] if window == "W coupling" else base[:, 41:41 + m]
    assert x.stride() == (parent, 1)
    assert x.data_ptr() % 16 == (0 if window == "W coupling" else 8)
    dense = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    _check_f64_spmm(
        lambda z, t: spmm.dia_spmm(op.values, op.offsets_t, z, t),
        lambda z, t: spmm.dia_spmm_reference(op.values, op.offsets_t, z, t),
        lambda z, t: spmm.dia_spmm_reference(op.values.abs(), op.offsets_t,
                                             z, t),
        x, False, "dia_f64", spmm.LAUNCHES, dense)
    v32 = op.values.float()
    xt, _ = _operand("cg", n, m, torch.float32, cuda, m)
    assert xt.stride() == (1, m)
    got = spmm.dia_spmm(v32, op.offsets_t, xt, True)
    assert torch.equal(got, spmm.dia_spmm(v32, op.offsets_t, xt, True))
    assert got.stride() == (1, m)
    ref = spmm.dia_spmm_reference(v32, op.offsets_t, xt, True)
    scale = spmm.dia_spmm_reference(v32.abs(), op.offsets_t, xt.abs(),
                                    True).max()
    assert float((got - ref).abs().max()) <= 1e-6 * float(scale)


def _wide_operand(kind, n, m, dtype, device, seed, halo=(0, 0)):
    """x for the wide path at m columns and n + hl + hr rows, as ``(x,
    transposed)``: ``cg`` the mixed inner CG's (m, n) with strides (1, m),
    ``dense`` a contiguous (n, m) (the f64 refresh), ``even`` / ``odd`` the
    column view of a wider basis at an even (V's W coupling) or odd (the
    Ritz block's residual window) offset."""
    g = torch.Generator(device=device).manual_seed(seed)
    rows = n + sum(halo)
    if kind == "cg":
        return torch.randn((rows, m), generator=g, dtype=dtype,
                           device=device).T, True
    if kind == "dense":
        return torch.randn((rows, m), generator=g, dtype=dtype,
                           device=device), False
    base = torch.randn((rows, m + 44), generator=g, dtype=dtype,
                       device=device)
    off = 40 if kind == "even" else 41
    return base[:, off:off + m], False


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-14),
                                       (torch.float32, 1e-6)])
@pytest.mark.parametrize("m", [40, 80])
@pytest.mark.parametrize("kind", ["cg", "dense", "even", "odd", "halo"])
def test_dia_wide_path_has_the_narrow_bits(cuda, dtype, tol, m, kind):
    """The wide path of kernels 1 and 2 against the narrow path, bit for
    bit, and within tol of max |A||x| of the plain version, at m = 40 and
    80 on the 27-point Laplacian at nx = 12 (blocks of the wide path
    part-full at the end): the CG operand, a contiguous (n, m), column
    views at an even and an odd offset, and a halo window (CG layout in
    f32, contiguous in f64); the plan takes the wide path there, and two
    launches give the same bits."""
    rows, cols, vals, n = _laplacian_27(12)
    op = make_operator(rows, cols, vals, (n, n), dtype=dtype, device=cuda)
    halo = (111, 120) if kind == "halo" else (0, 0)
    layout = kind if kind != "halo" else \
        ("cg" if dtype == torch.float32 else "dense")
    x, transposed = _wide_operand(layout, n, m, dtype, cuda, m, halo)

    def run(path=None):
        return spmm.dia_spmm(op.values, op.offsets_t, x, transposed, halo,
                             path=path)

    spmm.LAUNCHES["dia_f64"] = spmm.LAUNCHES["dia_f32"] = 0
    wide, narrow = run("wide"), run("narrow")
    assert torch.equal(wide, narrow)
    assert torch.equal(run(), wide) and torch.equal(run(), wide)
    assert sum(spmm.LAUNCHES.values()) == 4
    xs = (x.stride(1), x.stride(0)) if transposed else x.stride()
    ys = (wide.stride(1), wide.stride(0)) if transposed else wide.stride()
    assert spmm.dia_plan(m, *xs, x.data_ptr() % 16, *ys,
                         wide.data_ptr() % 16, x.element_size()).wide
    ref = spmm.dia_spmm_reference(op.values, op.offsets_t, x, transposed,
                                  halo)
    scale = spmm.dia_spmm_reference(op.values.abs(), op.offsets_t, x.abs(),
                                    transposed, halo).max()
    assert float((wide - ref).abs().max()) <= tol * float(scale)


@pytest.mark.parametrize("m", [21, 75])
@pytest.mark.parametrize("kind", ["dense", "even", "odd", "halo"])
def test_dia_two_phase_wide_path_has_the_narrow_bits(cuda, m, kind):
    """Kernel 1's wide path at f64 rows an odd number of doubles apart (PAS's
    contiguous (n, 75) block, whose rows alternate between two 16-byte
    phases), on the 27-point Laplacian at nx = 12: a contiguous (n, m) of
    odd m, column views at an even and an odd offset of an (n, 2m + 1)
    basis, and a contiguous halo window; the plan takes the wide path with
    two phases, its product has the narrow path's bits, equal bits on two
    launches, and lies within 1.5e-15 of max |A||x| of the plain
    version."""
    rows, cols, vals, n = _laplacian_27(12)
    op = make_operator(rows, cols, vals, (n, n), device=cuda)
    halo = (111, 120) if kind == "halo" else (0, 0)
    g = torch.Generator(device=cuda).manual_seed(m)
    base = torch.randn((n + sum(halo), 2 * m + 1), generator=g,
                       dtype=torch.float64, device=cuda)
    x = {"dense": base[:, :m].contiguous(), "halo": base[:, :m].contiguous(),
         "even": base[:, 2:2 + m], "odd": base[:, 1:1 + m]}[kind]
    assert x.stride(0) % 2 == 1

    def run(path=None):
        return spmm.dia_spmm(op.values, op.offsets_t, x, False, halo,
                             path=path)

    wide, narrow = run("wide"), run("narrow")
    plan = spmm.dia_plan(m, *x.stride(), x.data_ptr() % 16, *wide.stride(),
                         wide.data_ptr() % 16, 8)
    assert plan.wide is not None and plan.wide.two
    assert torch.equal(wide, narrow)
    assert torch.equal(run(), wide) and torch.equal(run(), wide)
    ref = spmm.dia_spmm_reference(op.values, op.offsets_t, x, False, halo)
    scale = spmm.dia_spmm_reference(op.values.abs(), op.offsets_t, x.abs(),
                                    False, halo).max()
    assert float((wide - ref).abs().max()) <= 1.5e-15 * float(scale)


@pytest.mark.parametrize("m", [1, 10, 100])
@pytest.mark.parametrize("kind", ["even", "odd"] + _LAYOUTS)
def test_dia_f64_kernel_runs_and_edges(cuda, m, kind):
    """Kernel 1 with offsets in no order: a run of 20 consecutive offsets
    (longer than one staged window serves), lone offsets, offsets past
    either end of the matrix, and an odd n that leaves the last block
    part-full and the value rows off 16 bytes; against the plain version."""
    n = 1001
    offsets = list(range(-10, 10)) + [400, -3, n + 5, -(n + 2), 999, -1000]
    rng = np.random.default_rng(8)
    values = torch.as_tensor(rng.standard_normal((len(offsets), n)),
                             device=cuda)
    offs = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    if kind in ("even", "odd"):
        x, transposed = _solve_operand(kind, n, m, cuda, 1), False
    else:
        x, transposed = _operand(kind, n, m, torch.float64, cuda, 1)
    _check_f64_spmm(
        lambda z, t: spmm.dia_spmm(values, offs, z, t),
        lambda z, t: spmm.dia_spmm_reference(values, offs, z, t),
        lambda z, t: spmm.dia_spmm_reference(values.abs(), offs, z, t),
        x, transposed, "dia_f64", spmm.LAUNCHES)


@pytest.mark.parametrize("n,p,q", [(157, 7, 3), (5000, 120, 10),
                                   (4099, 100, 100), (300, 33, 65)])
def test_tall_gemm_kernels_match_plain(cuda, n, p, q):
    """Kernels 3 and 4 against the plain versions on strided views: within
    1e-13 of ||a_i|| ||b_j|| (Gram) and of max (|a| |c|) (expand)."""
    g = torch.Generator(device=cuda).manual_seed(n)
    basis = torch.randn((n, p + 5), generator=g, dtype=torch.float64,
                        device=cuda)
    a = basis[:, 2:2 + p]
    b = torch.randn((n, q), generator=g, dtype=torch.float64, device=cuda)
    norms = a.norm(dim=0)[:, None] * b.norm(dim=0)[None, :]
    diff = osgemm.tall_gram(a, b) - osgemm.tall_gram_reference(a, b)
    assert float((diff.abs() / norms).max()) <= 1e-13
    c = torch.randn((q, p), generator=g, dtype=torch.float64,
                    device=cuda).T                           # strided (p, q)
    diff = osgemm.tall_expand(a, c) - osgemm.tall_expand_reference(a, c)
    assert float(diff.abs().max()) <= 1e-13 * float((a.abs() @ c.abs()).max())


def _tall_operands(cuda, n, p, q, seed, view="contiguous"):
    """a (n, p) and b (n, q) as the solver hands them: column slices of a
    wider basis (row stride 120), or the view named."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64,
                           device=cuda)

    if view == "odd column offset":              # v[:, 1:], base + 8 bytes
        a = randn(n, p + 1)[:, 1:]
    elif view == "odd row stride":
        a = randn(n, p + 3)[:, :p]
    else:
        a = randn(n, max(p, 120))[:, :p]
    return a, randn(n, q)


def _check_tall(a, b, c, path=None):
    """Kernels 3/4 (on ``path``, None: the one :func:`osgemm.tall_path`
    picks) against the plain versions within 1e-13 (Gram: of ||a_i||
    ||b_j|| per entry; expand: of max |a| |c|), and equal bits across two
    launches."""
    got = osgemm.tall_gram(a, b, path=path)
    again = osgemm.tall_gram(a, b, path=path)
    ref = osgemm.tall_gram_reference(a, b)
    norms = a.norm(dim=0)[:, None] * b.norm(dim=0)[None, :] + 1e-300
    assert got.shape == ref.shape and got.is_contiguous()
    if got.numel():
        assert float(((got - ref).abs() / norms).max()) <= 1e-13
    assert torch.equal(got, again)
    y = osgemm.tall_expand(a, c, path=path)
    y2 = osgemm.tall_expand(a, c, path=path)
    yref = osgemm.tall_expand_reference(a, c)
    assert y.shape == yref.shape and y.is_contiguous()
    if y.numel():
        scale = float((a.abs() @ c.abs()).max()) + 1e-300
        assert float((y - yref).abs().max()) <= 1e-13 * scale
    assert torch.equal(y, y2)


# the main path's shape classes: Gram (p x q) and expand (n x p)(p x q),
# at nev=50 (m=120) and at the production widths nev=200 (m=480, block 40)
# and nev=400 (m=960, block 80)
@pytest.mark.parametrize("p,q", [(120, 10), (110, 10), (10, 10), (100, 100),
                                 (120, 100), (120, 120),
                                 (480, 40), (440, 40), (40, 40), (400, 400),
                                 (480, 400), (960, 80), (880, 80), (80, 80),
                                 (800, 800), (960, 800)])
@pytest.mark.parametrize("n", [3001, 1000, 64, 5, 0])
def test_tall_kernels_main_path_shapes(cuda, n, p, q):
    """Every main-path shape class at small n, n not a multiple of a row
    tile (64) or of a Gram stage, n below one tile, and n = 0."""
    a, b = _tall_operands(cuda, n, p, q, seed=n + p + q)
    c = torch.randn((p, q), dtype=torch.float64, device=cuda)
    _check_tall(a, b, c)


@pytest.mark.parametrize("view", ["odd column offset", "odd row stride"])
def test_tall_kernels_on_unaligned_views(cuda, view):
    """Views whose rows do not start on 16 bytes take the 8-byte variant of
    the same kernels, with the same tolerance."""
    a, b = _tall_operands(cuda, 2049, 110, 10, seed=7, view=view)
    assert osgemm.copy_vec(a) == 1
    c = torch.randn((110, 10), dtype=torch.float64, device=cuda)
    _check_tall(a, b, c)


def test_tall_expand_transposed_c_and_c_beyond_shared_memory(cuda):
    """A transposed C (column stride != 1), and a (480 x 400) C whose
    k q 8 bytes exceed the shared memory: on the narrow path the expand loops
    over q-tiles and k-chunks, later k-chunks adding into Y (the wide path
    takes this class by default: ``path="narrow"`` keeps the loop
    checked)."""
    a, b = _tall_operands(cuda, 1500, 120, 100, seed=3)
    ct = torch.randn((100, 120), dtype=torch.float64, device=cuda).T
    _check_tall(a, b, ct)
    g = torch.Generator(device=cuda).manual_seed(4)
    a2 = torch.randn((900, 480), generator=g, dtype=torch.float64,
                     device=cuda)
    b2 = torch.randn((900, 400), generator=g, dtype=torch.float64,
                     device=cuda)
    c2 = torch.randn((480, 400), generator=g, dtype=torch.float64,
                     device=cuda)
    plan = osgemm.expand_plan(900, 480, 400, 132)
    assert plan.q_tile < 400 and plan.k_chunk < 480     # several launches
    _check_tall(a2, b2, c2, path="narrow")


# the wide classes of the production widths (nev=400: m=960, block 80, 2 nev
# = 800; nev=200: m=480, 2 nev = 400) at a small n, not a multiple of a
# row band
_WIDE_CLASSES = [(960, 800), (800, 800), (960, 80), (880, 80), (480, 400),
                 (400, 400)]


def _wide_operands(cuda, p, q, view, n=4099, seed=0):
    """a = columns 0..p-1 of an (n, m) basis (row stride m, as the solver's
    V[:, :k]), b (n, q), and c a (p x q) block of an (m x m) matrix (the
    eigenvector block's c[:, :size_x]); ``view="odd column offset"`` moves
    a and c one column right, so no row of theirs starts on 16 bytes."""
    g = torch.Generator(device=cuda).manual_seed(seed + p + q)
    m = 960 if max(p, q) > 480 else 480
    off = 1 if view == "odd column offset" else 0

    def randn(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64,
                           device=cuda)

    a = randn(n, m + off)[:, off:off + p]
    c = randn(m + off, m + off)[:p, off:off + q]
    if view == "column-major c":     # c[:, :size_x] of eigh's eigenvectors
        c = randn(m, m).T[:p, :q]
    return a, randn(n, q), c


@pytest.mark.parametrize("view", ["strided", "odd column offset",
                                  "column-major c"])
@pytest.mark.parametrize("p,q", _WIDE_CLASSES)
def test_tall_kernels_wide_path_at_the_wide_classes(cuda, p, q, view):
    """Kernels 3 and 4 take the wide path at the production classes, and
    hold 1e-13 against the plain versions with equal bits across two
    launches, on the solver's strided views (16-byte copies), on views at
    an odd column offset (8-byte copies) and with a column-major C (the
    eigenvector block's layout: a transposed stage); the narrow path stays
    reachable with ``path="narrow"`` and agrees to the same tolerance."""
    assert osgemm.tall_path(p, q) == "wide"
    a, b, c = _wide_operands(cuda, p, q, view)
    assert osgemm.copy_vec(a) == (1 if view == "odd column offset" else 2)
    assert osgemm.c_mode(c) == {"strided": 1, "odd column offset": 0,
                                "column-major c": 2}[view]
    before = dict(osgemm.LAUNCHES)
    _check_tall(a, b, c)
    assert osgemm.LAUNCHES["gram"] == before["gram"] + 2
    assert osgemm.LAUNCHES["expand"] == before["expand"] + 2
    _check_tall(a, b, c, path="narrow")


@pytest.mark.parametrize("p,q", _WIDE_CLASSES)
def test_tall_kernels_wide_path_in_a_cuda_graph(cuda, p, q):
    """The wide path captured in a CUDA graph and replayed gives the bits
    of the eager launches: no atomics, no counter that outlives a call (C
    column-major, as the solver's eigenvector block)."""
    a, b, c = _wide_operands(cuda, p, q, "column-major c", seed=1)
    eager_c, eager_y = osgemm.tall_gram(a, b), osgemm.tall_expand(a, c)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            got_c, got_y = osgemm.tall_gram(a, b), osgemm.tall_expand(a, c)
    for _ in range(2):
        got_c.zero_()
        got_y.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got_c, eager_c) and torch.equal(got_y, eager_y)


def test_wide_path_raises_when_its_launch_fails(cuda, monkeypatch):
    """A wide-path launch that reports a CUDA error raises; nothing falls
    back to the narrow path, torch.matmul or the plain version."""
    a, b, c = _wide_operands(cuda, 960, 800, "strided", n=300)
    lib = _build.lib()

    class Failing:
        def __getattr__(self, name):
            if name.endswith("_wide_f64"):
                return lambda *args: 1        # cudaErrorInvalidValue
            return getattr(lib, name)

    monkeypatch.setattr(_build, "lib", lambda: Failing())
    with pytest.raises(RuntimeError, match="wide"):
        osgemm.tall_gram(a, b)
    with pytest.raises(RuntimeError, match="wide"):
        osgemm.tall_expand(a, c)


def test_dmma_fragment_layout(cuda):
    """One 16 x 8 x 8 tile through the kernels' f64 mma, fragments read
    straight from device memory, against a @ c."""
    g = torch.Generator(device=cuda).manual_seed(8)
    a = torch.randn((16, 8), generator=g, dtype=torch.float64, device=cuda)
    c = torch.randn((8, 8), generator=g, dtype=torch.float64, device=cuda)
    got = osgemm.dmma_tile_check(a, c)
    scale = float((a.abs() @ c.abs()).max())
    assert float((got - a @ c).abs().max()) <= 1e-15 * scale


def test_kernels_raise_on_what_they_do_not_take(cuda):
    a = torch.zeros((64, 4), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        osgemm.tall_gram(a, a)
    with pytest.raises(ValueError):
        osgemm.tall_expand(a.double(), torch.zeros((4, 2),
                                                   dtype=torch.float64))
    rows, cols, vals, n = _laplacian_27(4)
    op = make_operator(rows, cols, vals, (n, n), device=cuda)
    with pytest.raises(TypeError):
        op.matvec(torch.zeros((n, 2), dtype=torch.float32, device=cuda))
    with pytest.raises(ValueError):
        op.matvec(torch.zeros((n, 2), dtype=torch.float64))


def test_small_solve_on_card_matches_cpu(cuda):
    """A small headline-style solve on the card and on the CPU: eigenvalues
    within 1e-10 relative, with every kernel launched on the card."""
    rows, cols, vals, n = _laplacian_27(10)
    a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    x0 = np.random.default_rng(0).uniform(-1, 1, (n, 20))
    kw = dict(nev=10, block_size=10, max_iter=120, cg_max_iter=30,
              cg_mixed=True, cg_refine=2, cg_auto_shift=True, verbose=0,
              x0=x0)
    for counters in (spmm.LAUNCHES, osgemm.LAUNCHES):
        for key in counters:
            counters[key] = 0
    ev_gpu, _, conv_gpu = solve(a, device=cuda, **kw)
    assert all(c > 0 for c in {**spmm.LAUNCHES, **osgemm.LAUNCHES}.values())
    ev_cpu, _, conv_cpu = solve(a, device="cpu", **kw)
    assert conv_gpu >= 10 and conv_cpu >= 10
    assert np.max(np.abs(ev_gpu - ev_cpu) / np.abs(ev_cpu)) <= 1e-10


def _irregular_csr(n: int, seed: int, long_rows=()):
    """Random rows of 0 to 30 entries; rows 0 and n-1 empty, row 5 with one
    entry, and the rows ``long_rows`` with as many entries as given.
    Returns scipy CSR and the device-independent CSR arrays."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 31, n)
    deg[[0, n - 1]] = 0
    deg[5] = 1
    for r, d in long_rows:
        deg[r] = d
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, len(rows))
    vals = rng.standard_normal(len(rows))
    a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    return a, onehot.pack_csr(rows, cols, vals, (n, n))


# rows of the split path: past the tile budget (``long``), or of the AMG
# coarse levels' lengths, on both sides of CSR_SPLIT and of one part
# (``amg``: level 2's 400-1,289 entries, level 2 R's 2,449 in two parts, a
# row of three parts)
_LONG_ROWS = {
    "short": [],
    "long": [(7, 3 * onehot.CSR_BUDGET + 5), (1000, onehot.CSR_BUDGET + 1)],
    "amg": [(3, onehot.CSR_SPLIT), (4, onehot.CSR_SPLIT + 1), (9, 400),
            (10, 731), (11, 1289), (500, 2449), (501, 2 * onehot.CSR_PART),
            (777, 2 * onehot.CSR_PART + 1), (1029, 924)],
}


@pytest.mark.parametrize("dtype,tol,key", [
    (torch.float64, 1e-14, "csr_f64"), (torch.float32, 1e-5, "csr_f32")])
@pytest.mark.parametrize("m", [1, 10, 16, 40])
@pytest.mark.parametrize("layout", _LAYOUTS)
@pytest.mark.parametrize("rows", ["short", "long", "amg"])
def test_csr_kernel_matches_plain(cuda, dtype, tol, key, m, layout, rows):
    """Kernels 5 and 6 against the plain version in every layout, n = 1031
    (no multiple of a block), with empty rows, a one-entry row and (``long``,
    ``amg``) rows of the split path: within tol of max |A||x| (the split
    path sums in another order); two launches give the same bits; the
    product lies in the memory order of x."""
    n = 1031
    long_rows = _LONG_ROWS[rows]
    a, (rowptr, colidx, values) = _irregular_csr(n, m, long_rows)
    rowptr, colidx = (torch.as_tensor(t, device=cuda)
                      for t in (rowptr, colidx))
    values = torch.as_tensor(values, device=cuda).to(dtype)
    plan = onehot.csr_plan(rowptr)
    x, transposed = _operand(layout, n, m, dtype, cuda, 1)
    before = onehot.LAUNCHES[key]
    got = onehot.csr_spmm(rowptr, colidx, values, x, transposed, plan)
    again = onehot.csr_spmm(rowptr, colidx, values, x, transposed, plan)
    assert onehot.LAUNCHES[key] == before + 2
    assert got.shape == x.shape and torch.equal(got, again)
    assert _follows(got, x)
    ref = onehot.csr_spmm_reference(rowptr, colidx, values, x, transposed)
    scale = onehot.csr_spmm_reference(rowptr, colidx, values.abs(), x.abs(),
                                      transposed).max()
    assert float((got - ref).abs().max()) <= tol * float(scale)
    y = got.T if transposed else got
    assert not y[0].any() and not y[n - 1].any()             # empty rows
    xn = (x.T if transposed else x).double().cpu().numpy()
    assert np.abs(y.double().cpu().numpy() - a @ xn).max() <= \
        (tol if dtype == torch.float64 else 1e-4) * float(scale)


def test_csr_f32_kernel_on_unaligned_arrays(cuda):
    """Kernel 5 takes colidx and values that do not start on 16 bytes
    (4-byte copies), and refuses to run without its row tiles."""
    n = 700
    _, (rowptr, colidx, values) = _irregular_csr(n, 3)
    rowptr = torch.as_tensor(rowptr, device=cuda)
    colidx = torch.as_tensor(np.concatenate([colidx[:1], colidx]),
                             device=cuda)[1:]
    values = torch.as_tensor(np.concatenate([values[:1], values]),
                             device=cuda).float()[1:]
    assert colidx.data_ptr() % 16 and values.data_ptr() % 16
    x, _ = _operand("cg", n, 10, torch.float32, cuda, 2)
    with pytest.raises(ValueError, match="row tiles"):
        onehot.csr_spmm(rowptr, colidx, values, x, True)
    got = onehot.csr_spmm(rowptr, colidx, values, x, True,
                          onehot.csr_plan(rowptr))
    ref = onehot.csr_spmm_reference(rowptr, colidx, values, x, True)
    scale = onehot.csr_spmm_reference(rowptr, colidx, values.abs(), x.abs(),
                                      True).max()
    assert float((got - ref).abs().max()) <= 1e-5 * float(scale)


@pytest.mark.parametrize("m", [1, 10, 40])
@pytest.mark.parametrize("kind", ["even", "odd", "nm", "mn", "mn view"])
@pytest.mark.parametrize("rows", ["short", "long", "amg"])
def test_csr_f64_kernel_at_the_solve_operands(cuda, m, kind, rows):
    """Kernel 6 on the operands a solve hands it (column views of V at an
    even and an odd offset) and the other layouts, at m in {1, 10, 40}, on
    n = 1031 rows with empty first and last rows, a one-entry row and
    (``long``, ``amg``) rows of the split path; in the operator's own
    plan."""
    n = 1031
    long_rows = _LONG_ROWS[rows]
    a, (rowptr, colidx, values) = _irregular_csr(n, m, long_rows)
    op = onehot.CsrOperator(*(torch.as_tensor(t, device=cuda)
                              for t in (rowptr, colidx, values)), n)
    if kind in ("even", "odd"):
        x, transposed = _solve_operand(kind, n, m, cuda, 3), False
    else:
        x, transposed = _operand(kind, n, m, torch.float64, cuda, 3)
    got = _check_f64_spmm(
        lambda z, t: op.matvec_t(z) if t else op.matvec(z),
        lambda z, t: onehot.csr_spmm_reference(op.rowptr, op.colidx,
                                               op.values, z, t),
        lambda z, t: onehot.csr_spmm_reference(op.rowptr, op.colidx,
                                               op.values.abs(), z, t),
        x, transposed, "csr_f64", onehot.LAUNCHES, a)
    y = got.T if transposed else got
    assert not y[0].any() and not y[n - 1].any()             # empty rows


def _basis_view(n, m, dtype, device, seed):
    """``V[:, 120 - m:120]`` of an (n, 120) basis (``V[:, 110:120]`` at
    m = 10, the W coupling's operand)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n, 120), generator=g, dtype=dtype,
                       device=device)[:, 120 - m:]


def _csr_rows_of(rowptr, colidx, values, r0, r1):
    """Rows [r0, r1) of a CSR matrix as a CSR of their own, over the same
    columns (a rank's shard before its columns are windowed)."""
    lo, hi = int(rowptr[r0]), int(rowptr[r1])
    return ((rowptr[r0:r1 + 1] - lo).contiguous(), colidx[lo:hi].contiguous(),
            values[lo:hi].contiguous())


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-14),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("m", [1, 10, 16, 40, 75])
@pytest.mark.parametrize("layout", ["nm", "mn", "V view", "cg"])
def test_csr_split_rows_same_bits_in_the_whole_matrix_and_a_shard(
        cuda, dtype, tol, m, layout):
    """Rows of the split path (the AMG coarse levels' lengths and longer;
    at m = 75, PAS's width, several slabs of column groups side by side)
    against the plain version, within tol of max |A||x|; the same bits on
    two launches, and for a block of rows computed inside the whole matrix
    and as its own CSR (cut at rows that split tiles of the whole, and
    shifted by one row), with the same x."""
    n = 1031
    a, (rowptr, colidx, values) = _irregular_csr(n, 100 + m,
                                                 _LONG_ROWS["amg"])
    rowptr, colidx = (torch.as_tensor(t, device=cuda)
                      for t in (rowptr, colidx))
    values = torch.as_tensor(values, device=cuda).to(dtype)
    if layout == "V view":
        x, transposed = _basis_view(n, m, dtype, cuda, 5), False
    else:
        x, transposed = _operand(layout, n, m, dtype, cuda, 5)
    plan = onehot.csr_plan(rowptr)
    assert plan.nsplit > 0 and plan.nmulti > 0
    got = onehot.csr_spmm(rowptr, colidx, values, x, transposed, plan)
    assert torch.equal(got, onehot.csr_spmm(rowptr, colidx, values, x,
                                            transposed, plan))
    ref = onehot.csr_spmm_reference(rowptr, colidx, values, x, transposed)
    scale = onehot.csr_spmm_reference(rowptr, colidx, values.abs(), x.abs(),
                                      transposed).max()
    assert float((got - ref).abs().max()) <= tol * float(scale)
    whole = got.T if transposed else got
    for r0, r1 in ((1, 13), (2, 520), (400, 1031), (0, 1031)):
        rp, ci, va = _csr_rows_of(rowptr, colidx, values, r0, r1)
        part = onehot.csr_spmm(rp, ci, va, x, transposed,
                               onehot.csr_plan(rp))
        if transposed:
            part = part.T
        assert torch.equal(part, whole[r0:r1]), (r0, r1)


def _banded_long_csr(n: int, seed: int, scatter: float = 0.1):
    """Rows of the AMG coarse levels' shape: most rows 300 to 900 entries in
    a band around the diagonal with a share ``scatter`` of them moved to
    random columns (all of them at 1), some short rows (the tile path's)
    and an empty one; n columns, no column twice in a row."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r in range(n):
        d = 0 if r == 5 else int(rng.integers(2, 40)) if r % 17 == 3 else \
            int(rng.integers(300, 900))
        lo = min(max(r - d // 2, 0), n - d)
        c = np.arange(lo, lo + d)
        drop = rng.random(d) < scatter
        c[drop] = rng.integers(0, n, int(drop.sum()))
        c = np.unique(c)
        rows.append(np.full(len(c), r))
        cols.append(c)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = rng.standard_normal(len(rows))
    return onehot.pack_csr(rows, cols, vals, (n, n))


@pytest.mark.parametrize("n", [1031, 4500])
@pytest.mark.parametrize("m", [10, 75])
@pytest.mark.parametrize("layout", ["nm", "mn", "V view", "cg"])
def test_csr_panel_path_same_bits_in_the_whole_matrix_and_a_shard(
        cuda, n, m, layout):
    """Kernel 6's panel path (forced) against the plain version within 1e-14
    of max |A||x|; the same bits on two launches; a block of rows computed
    inside the whole matrix and as its own CSR with its own plan (cut at
    rows that split panels, shifted by one row) gives the same bits.
    n = 4,500 has more than PANEL_NARROW columns (one column chunk), n =
    1,031 fewer (chunks of 512 columns, their sums added in chunk
    order)."""
    rowptr, colidx, values = (torch.as_tensor(t, device=cuda)
                              for t in _banded_long_csr(n, m))
    if layout == "V view":
        x, transposed = _basis_view(n, m, torch.float64, cuda, 5), False
    else:
        x, transposed = _operand(layout, n, m, torch.float64, cuda, 5)
    plan = onehot.csr_plan(rowptr, colidx, values, n)
    pn = plan.panels
    assert pn is not None and pn.chunks == onehot.panel_chunks(n)
    path = "panel"
    before = onehot.LAUNCHES["csr_f64_panel"]
    got = onehot.csr_spmm(rowptr, colidx, values, x, transposed, plan, path)
    assert torch.equal(got, onehot.csr_spmm(rowptr, colidx, values, x,
                                            transposed, plan, path))
    assert onehot.LAUNCHES["csr_f64_panel"] == before + 2
    ref = onehot.csr_spmm_reference(rowptr, colidx, values, x, transposed)
    scale = onehot.csr_spmm_reference(rowptr, colidx, values.abs(), x.abs(),
                                      transposed).max()
    assert float((got - ref).abs().max()) <= 1e-14 * float(scale)
    whole = got.T if transposed else got
    for r0, r1 in ((1, 13), (2, 520), (400, n), (0, n)):
        rp, ci, va = _csr_rows_of(rowptr, colidx, values, r0, r1)
        part = onehot.csr_spmm(rp, ci, va, x, transposed,
                               onehot.csr_plan(rp, ci, va, n), "panel")
        if transposed:
            part = part.T
        assert torch.equal(part, whole[r0:r1]), (r0, r1)


def test_csr_panel_path_only_where_the_plan_takes_it(cuda):
    """The plan's choice: the split path at m = 10 and where the tiles are
    less than PANEL_FILL full (rows of random columns), the panel path at m
    = 75 on banded rows; ``path="panel"`` raises without panels for the
    values (f32 values, a plan made from rowptr alone)."""
    n, m = 1500, 75
    rowptr, colidx, values = (torch.as_tensor(t, device=cuda)
                              for t in _banded_long_csr(n, 3))
    plan = onehot.csr_plan(rowptr, colidx, values, n)
    x = torch.randn((n, m), dtype=torch.float64, device=cuda)
    for width, want in ((10, 0), (m, 1)):
        before = onehot.LAUNCHES["csr_f64_panel"]
        onehot.csr_spmm(rowptr, colidx, values, x[:, :width], False, plan)
        assert onehot.LAUNCHES["csr_f64_panel"] == before + want
    rp, ci, va = (torch.as_tensor(t, device=cuda)
                  for t in _banded_long_csr(6000, 4, scatter=1.0))
    sparse = onehot.csr_plan(rp, ci, va, 6000)
    assert sparse.panels is not None and \
        sparse.panels.fill < onehot.PANEL_FILL
    before = onehot.LAUNCHES["csr_f64_panel"]
    onehot.csr_spmm(rp, ci, va, torch.randn((6000, m), dtype=torch.float64,
                                            device=cuda), False, sparse)
    assert onehot.LAUNCHES["csr_f64_panel"] == before
    with pytest.raises(ValueError, match="panels"):
        onehot.csr_spmm(rowptr, colidx, values, x, False,
                        onehot.csr_plan(rowptr), "panel")
    with pytest.raises(ValueError, match="panels"):
        onehot.csr_spmm(rowptr, colidx, values.float(), x.float(), False,
                        plan, "panel")


def _delaunay_rcm_csr(g: int):
    """The irregular cell's matrix at a g^3 Delaunay mesh in RCM order, as
    CSR arrays."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    a = _delaunay(g)
    perm = reverse_cuthill_mckee(a, symmetric_mode=True)
    a = a[perm][:, perm].tocsr()
    return (a.indptr.astype(np.int32), a.indices.astype(np.int32), a.data)


def _irregular_wide_operand(kind, n, dtype, device, seed):
    """The irregular nev=200 solve's operands of kernels 5 and 6, as ``(x,
    transposed)``: the CG's ``(40, n)`` with strides (1, 40) (``cg``),
    ``V[:, 440:480]`` of an (n, 480) basis (``V``), the residual window
    ``ritz[:, 41:81]`` of an (n, 400) Ritz block at an odd offset (rows
    8-byte aligned only, ``ritz``), the contiguous refresh ``(n, 40)``, and
    the initial Rayleigh-Ritz ``V[:, :400]`` (``V400``)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, dtype=dtype, device=device)

    return {"cg": lambda: (randn(n, 40).T, True),
            "V": lambda: (randn(n, 480)[:, 440:480], False),
            "ritz": lambda: (randn(n, 400)[:, 41:81], False),
            "(n, 40)": lambda: (randn(n, 40), False),
            "V400": lambda: (randn(n, 480)[:, :400], False)}[kind]()


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-14),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("kind", ["cg", "V", "ritz", "(n, 40)", "V400"])
@pytest.mark.parametrize("extra", ["mesh", "split rows"])
def test_csr_wide_path_has_the_tile_bits(cuda, dtype, tol, kind, extra):
    """The wide path of kernels 5 and 6 (the same kernels on tiles of at
    most CSR_WIDE_ROWS rows) on the irregular cell's matrix (a 20^3
    Delaunay mesh in RCM order, and with rows of the split path added):
    the 64-row tiles' bits, the same bits on two launches and in a
    ``window_csr`` shard (a rank's rows of a four-rank row mesh, its
    columns re-indexed into its halo window), within tol of max |A||x| of
    the plain version; the wrapper takes it by itself at these widths, and
    its launch counters move."""
    from gcge_tpu_torch.parallel import dist_ops
    from gcge_tpu_torch.parallel.mesh import RowMesh

    rowptr, colidx, values = _delaunay_rcm_csr(20)
    n = len(rowptr) - 1
    if extra == "split rows":
        rng = np.random.default_rng(4)
        lengths = np.diff(rowptr)
        lengths[[10, n // 2]] = [onehot.CSR_SPLIT + 40, onehot.CSR_PART + 3]
        cols = [np.sort(rng.choice(n, d, replace=False)) if r in
                (10, n // 2) else colidx[rowptr[r]:rowptr[r + 1]]
                for r, d in enumerate(lengths)]
        colidx = np.concatenate(cols).astype(np.int32)
        rowptr = np.r_[0, np.cumsum(lengths)].astype(np.int32)
        values = rng.standard_normal(len(colidx))
    pad = -n % 4                                # four equal row blocks
    rowptr = np.r_[rowptr, np.full(pad, rowptr[-1])].astype(np.int32)
    n += pad
    op = onehot.CsrOperator(torch.as_tensor(rowptr, device=cuda),
                            torch.as_tensor(colidx, device=cuda),
                            torch.as_tensor(values, device=cuda), n)
    vals = op.values.to(dtype)
    plan = op.plan
    assert (plan.nsplit > 0) == (extra == "split rows")
    x, transposed = _irregular_wide_operand(kind, n, dtype, cuda, 7)
    m = x.shape[0] if transposed else x.shape[1]
    assert onehot.csr_path(plan, vals, m) == "wide"
    key = "csr_f64" if dtype == torch.float64 else "csr_f32"

    def run(path=None):
        return onehot.csr_spmm(op.rowptr, op.colidx, vals, x, transposed,
                               plan, path)

    before = dict(onehot.LAUNCHES)
    got, again = run(), run("wide")
    assert onehot.LAUNCHES[key] == before[key] + 2
    assert onehot.LAUNCHES[key + "_wide"] == before[key + "_wide"] + 2
    assert torch.equal(got, again) and torch.equal(got, run("split"))
    assert onehot.LAUNCHES[key + "_wide"] == before[key + "_wide"] + 2
    assert _follows(got, x)
    ref = onehot.csr_spmm_reference(op.rowptr, op.colidx, vals, x,
                                    transposed)
    scale = float(onehot.csr_spmm_reference(op.rowptr, op.colidx,
                                            vals.abs(), x.abs(),
                                            transposed).max())
    assert float((got - ref).abs().max()) <= tol * scale
    # a rank's rows of a four-rank mesh, as the sharded operator holds them
    whole = got.T if transposed else got
    xn = x.T if transposed else x
    rp = rowptr.astype(np.int64)
    for rank in range(4):
        mesh = RowMesh(None, rank, 4, cuda, (0, 1, 2, 3))
        r0, ln = mesh.block(n)
        cols = colidx[rp[r0]:rp[r0 + ln]]
        hl, hr = r0 - min(cols.min(), r0), max(cols.max(), r0 + ln - 1) - \
            (r0 + ln - 1)
        shard = dist_ops.window_csr(mesh, rp[r0:r0 + ln + 1] - rp[r0], cols,
                                    values[rp[r0]:rp[r0 + ln]], n, hl, hr,
                                    torch.float64).local
        window = torch.zeros((ln + hl + hr, m), dtype=dtype, device=cuda)
        lo, hi = max(r0 - hl, 0), min(r0 + ln + hr, n)
        window[lo - (r0 - hl):hi - (r0 - hl)] = xn[lo:hi]
        part = onehot.csr_spmm(shard.rowptr, shard.colidx,
                               shard.values.to(dtype),
                               window.T if transposed else window,
                               transposed, shard.plan)
        part = part.T if transposed else part
        assert torch.equal(part, whole[r0:r0 + ln]), rank


def test_csr_f64_kernel_on_unaligned_arrays_and_needs_a_plan(cuda):
    """Kernel 6 takes colidx and values that do not start on 16 bytes
    (4- and 8-byte copies), and refuses to run without its row tiles."""
    n = 700
    _, (rowptr, colidx, values) = _irregular_csr(n, 4)
    rowptr = torch.as_tensor(rowptr, device=cuda)
    colidx = torch.as_tensor(np.concatenate([colidx[:1], colidx]),
                             device=cuda)[1:]
    values = torch.as_tensor(np.concatenate([values[:1], values]),
                             device=cuda)[1:]
    assert colidx.data_ptr() % 16 and values.data_ptr() % 16
    x = _solve_operand("even", n, 10, cuda, 2)
    with pytest.raises(ValueError, match="row tiles"):
        onehot.csr_spmm(rowptr, colidx, values, x)
    got = onehot.csr_spmm(rowptr, colidx, values, x, False,
                          onehot.csr_plan(rowptr))
    ref = onehot.csr_spmm_reference(rowptr, colidx, values, x)
    scale = onehot.csr_spmm_reference(rowptr, colidx, values.abs(),
                                      x.abs()).max()
    assert float((got - ref).abs().max()) <= 1e-14 * float(scale)


def test_csr_kernel_raises_on_what_it_does_not_take(cuda):
    _, (rowptr, colidx, values) = _irregular_csr(64, 0)
    rowptr, colidx, values = (torch.as_tensor(t, device=cuda)
                              for t in (rowptr, colidx, values))
    x = torch.zeros((64, 2), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        onehot.csr_spmm(rowptr, colidx, values.float(), x)
    with pytest.raises(TypeError):
        onehot.csr_spmm(rowptr.long(), colidx, values, x)
    with pytest.raises(ValueError):
        onehot.csr_spmm(rowptr, colidx, values, x.cpu())
    with pytest.raises(ValueError):
        onehot.csr_spmm(rowptr, colidx[::2], values[::2], x)


def test_mask_probe_kernel_matches_plain(cuda):
    """Kernel 7 against the plain version, bit for bit, for ids inside and
    outside the iota range; the probe's answer on the card is True."""
    rng = np.random.default_rng(0)
    for ids0 in (np.arange(128) % 8, rng.integers(0, 300, 128)):
        ids = np.zeros((8, 128), np.int32)
        ids[0] = ids0
        ids_t = torch.as_tensor(ids, device=cuda)
        before = onehot.LAUNCHES["mask_probe"]
        got = onehot.onehot_mask_probe(ids_t)
        assert onehot.LAUNCHES["mask_probe"] == before + 1
        assert torch.equal(got, onehot.onehot_mask_reference(ids_t))
    assert onehot.bf16_mask_supported(cuda) is True


def test_csr_operator_probes_the_card_when_built(cuda):
    """``CsrOperator.from_coo`` launches the mask probe once per operator
    built on the card, and never for an operator on the CPU."""
    a, _ = _irregular_csr(64, 0)
    before = onehot.LAUNCHES["mask_probe"]
    onehot.CsrOperator.from_scipy(a, device="cpu")
    assert onehot.LAUNCHES["mask_probe"] == before
    onehot.CsrOperator.from_scipy(a, device=cuda)
    assert onehot.LAUNCHES["mask_probe"] == before + 1


def _delaunay(g: int):
    rows, cols, av, _, n = assemble_p1(*random_delaunay_mesh(g ** 3, seed=1))
    return sps.coo_matrix((av, (rows, cols)), shape=(n, n)).tocsr()


def test_hybrid_operator_on_card_matches_scipy(cuda):
    """DIA core on kernels 1/2 plus CSR remainder on kernels 5/6: f64 within
    1e-14 and f32 within 1e-5 of max |A||x| of scipy's product."""
    n = 5000
    rng = np.random.default_rng(2)
    a = sps.diags([rng.standard_normal(n - abs(k)) for k in range(-6, 7)],
                  list(range(-6, 7)), format="coo")
    r = rng.integers(0, n, 900)
    c = rng.integers(0, n, 900)
    a = (a + sps.coo_matrix((rng.standard_normal(900), (r, c)),
                            shape=(n, n))).tocoo()
    op = HybridOperator.from_coo(a.row, a.col, a.data, (n, n), device=cuda,
                                 max_diags=13)
    assert op.rest is not None and op.nnz == a.nnz
    x = rng.standard_normal((n, 10))
    scale = (abs(a) @ np.abs(x)).max()
    ref = a @ x
    for counters in (spmm.LAUNCHES, onehot.LAUNCHES):
        for key in counters:
            counters[key] = 0
    y64 = op.matvec(torch.as_tensor(x, device=cuda))
    f32 = HybridOperator(type(op.dia)(op.dia.values.float(), op.dia.offsets,
                                      op.dia.n_cols), op.rest)
    y32 = f32.matvec(torch.as_tensor(x, device=cuda).float())
    assert np.abs(y64.cpu().numpy() - ref).max() <= 1e-14 * scale
    assert y32.dtype == torch.float32
    assert np.abs(y32.double().cpu().numpy() - ref).max() <= 1e-5 * scale
    assert spmm.LAUNCHES == {"dia_f64": 1, "dia_f32": 1}
    assert onehot.LAUNCHES["csr_f64"] == 1 and onehot.LAUNCHES["csr_f32"] == 1


def test_small_irregular_solve_on_card_matches_cpu(cuda):
    """The irregular slice at a 10^3 Delaunay mesh through solve(rcm=True)
    on the card and on the CPU: eigenvalues within 1e-10 relative, host
    residuals in the caller's ordering, kernels 3 to 6 launched."""
    a = _delaunay(10)
    n = a.shape[0]
    x0 = np.random.default_rng(0).uniform(-1, 1, (n, 20))
    kw = dict(nev=10, block_size=10, max_iter=200, cg_max_iter=60,
              cg_mixed=True, cg_refine=3, cg_auto_shift=True, verbose=0,
              x0=x0, rcm=True)
    for counters in (onehot.LAUNCHES, osgemm.LAUNCHES):
        for key in counters:
            counters[key] = 0
    ev_gpu, evec, conv_gpu = solve(a, device=cuda, **kw)
    assert onehot.LAUNCHES["csr_f32"] > 0 and onehot.LAUNCHES["csr_f64"] > 0
    assert all(c > 0 for c in osgemm.LAUNCHES.values())
    ev_cpu, _, conv_cpu = solve(a, device="cpu", **kw)
    assert conv_gpu >= 10 and conv_cpu >= 10
    assert np.max(np.abs(ev_gpu - ev_cpu) / np.abs(ev_cpu)) <= 1e-10
    x = evec[:, :10].cpu().numpy()
    res = np.linalg.norm(a @ x - x * ev_gpu[None, :10], axis=0) / (
        np.abs(ev_gpu[:10]) * np.linalg.norm(x, axis=0))
    assert res.max() <= 2e-8


def test_fma_probe_kernel_matches_plain(cuda):
    """Kernel 8: the Dekker block bit for bit; ``a*b - p`` the exact error
    (nvcc fused it into one FMA) or zero (it did not)."""
    rng = np.random.default_rng(0)
    a = torch.as_tensor((rng.standard_normal(probes.PROBE_SHAPE) * 1.7)
                        .astype(np.float32), device=cuda)
    b = torch.as_tensor((rng.standard_normal(probes.PROBE_SHAPE) * 0.3)
                        .astype(np.float32), device=cuda)
    before = probes.LAUNCHES["fma_probe"]
    res = probes.fma_probe(a, b)
    assert probes.LAUNCHES["fma_probe"] == before + 1
    ref = probes.fma_probe_plain(a, b)
    assert torch.equal(res.out[8:], ref[8:])
    assert torch.equal(res.out[:8], ref[:8]) or not bool(res.out[:8].any())
    assert res.fused == torch.equal(res.out[:8], res.out[8:])
    assert res.nonzeros == int(torch.count_nonzero(ref[8:]))
    with pytest.raises(ValueError):
        probes.fma_probe(a.T.contiguous().T, b)


@pytest.mark.parametrize("p,q,n,nr", [(16, 1, 64, 64), (32, 8, 300, 128),
                                      (128, 16, 5000, 1024)])
@pytest.mark.parametrize("mode", probes.MODES)
def test_slice_gram_kernel_matches_plain(cuda, p, q, n, nr, mode):
    """Kernel 9, every mode: zeros without the dot; ``full`` bit for bit
    (7-bit slices: a chunk's sum is exact in f32 and the chunk slabs are
    added in the plain version's order); ``dot`` within 1e-5 of the largest
    entry (bf16 values of any exponent, a chunk summed in another order);
    two launches give equal bits."""
    planes = make_planes(p, q, n, nr, cuda, seed=p)
    before = probes.LAUNCHES["slice_gram"]
    got = probes.slice_gram(*planes, mode=mode, nr=nr)
    again = probes.slice_gram(*planes, mode=mode, nr=nr)
    assert probes.LAUNCHES["slice_gram"] == before + 2
    ref = probes.slice_gram_plain(*planes, mode=mode, nr=nr)
    assert got.shape == (7 * p, 7 * q) and torch.equal(got, again)
    if mode in ("none", "peel"):
        assert not bool(got.any())
    elif mode == "full":
        assert torch.equal(got, ref)
    else:
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
        assert not bool(got[p:].any()) and not bool(got[:, q:].any())


def test_bf16_mma_fragment_layout(cuda):
    """One 64 x 112 x 64 product through kernel 9's stack layout,
    descriptors and bf16 wgmma, against ``a.float() @ b.float().T``:
    products of bf16 values are exact in f32, and 64 of them sum to within
    a few units of the last place of the largest partial sum."""
    g = torch.Generator(device=cuda).manual_seed(9)
    a = torch.randn((64, 64), generator=g, device=cuda).bfloat16()
    b = torch.randn((112, 64), generator=g, device=cuda).bfloat16()
    before = probes.CHECK_LAUNCHES["bf16_mma_tile"]
    got = probes.bf16_mma_tile_check(a, b)
    assert probes.CHECK_LAUNCHES["bf16_mma_tile"] == before + 1
    scale = float((a.float().abs() @ b.float().abs().T).max())
    assert float((got - a.float() @ b.float().T).abs().max()) <= \
        1e-6 * scale


@pytest.mark.parametrize("p,q,n,nr,run", [(32, 5, 1280, 128, 3),
                                          (48, 16, 7 * 1024, 1024, 2),
                                          (16, 16, 640, 64, 4)])
@pytest.mark.parametrize("mode", ["dot", "full"])
def test_slice_gram_kernel_in_runs(cuda, p, q, n, nr, run, mode):
    """Kernel 9 with runs of several chunks and a ragged last run: ``full``
    bit for bit against the plain version summed in the same runs and
    against the TPU kernel's order (the sums are exact at these sizes),
    ``dot`` within 1e-5 of the largest entry; two launches equal."""
    planes = make_planes(p, q, n, nr, cuda, seed=q)
    plan = probes.slice_gram_plan(p, q, planes[0].shape[1], nr, 132, run)
    assert plan.run == run and plan.runs * run > planes[0].shape[1] // nr
    got = probes._slice_gram(*planes, mode, nr, run)
    assert torch.equal(got, probes._slice_gram(*planes, mode, nr, run))
    ref = probes.slice_gram_plain(*planes, mode=mode, nr=nr, run=run)
    if mode == "full":
        assert torch.equal(got, ref)
        assert torch.equal(got, probes.slice_gram_plain(*planes, mode=mode,
                                                        nr=nr))
    else:
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("run", [1, 3])
def test_slice_gram_kernel_peel_paths(cuda, run):
    """Kernel 9 peels in full-rate adds where a warp's values are small
    (|hi| < 2^15, |lo| < 2^-21) and by ``rint`` elsewhere, with the same
    bits.  Here some rows of A and B get, every 64 columns, a value with
    hi = 0 and lo = n 2^-28 (n in 128..255): their warps take the general
    path, the others the fast one, and every sum stays exact, so ``full``
    gives the plain version's bits."""
    ahi, alo, bhi, blo = make_planes(32, 9, 640, 128, cuda, seed=7)
    rng = np.random.default_rng(7)
    for hi, lo, rows in ((ahi, alo, (3, 20)), (bhi, blo, (1, 8))):
        for r in rows:
            cols = torch.arange(r % 64, hi.shape[1], 64, device=cuda)
            n = rng.integers(128, 256, cols.numel()) * \
                rng.choice([-1.0, 1.0], cols.numel())
            hi[r, cols] = 0.0
            lo[r, cols] = torch.as_tensor(n * 2.0 ** -28, dtype=torch.float32,
                                          device=cuda)
    planes = (ahi, alo, bhi, blo)
    got = probes._slice_gram(*planes, "full", 128, run)
    assert torch.equal(got, probes.slice_gram_plain(*planes, mode="full",
                                                    nr=128, run=run))
    assert torch.equal(got, probes.slice_gram_plain(*planes, mode="full",
                                                    nr=128))


def test_slice_gram_kernel_at_the_script_shape(cuda):
    """``full`` at the measurement script's shape (P=128, Q=16, 154 chunks)
    with the plan's runs: the bits of the plain version summed in the same
    runs; with runs of one chunk, the bits of the TPU kernel's order."""
    planes = make_planes(128, 16, 157464, 1024, cuda)
    plan = probes.slice_gram_plan(128, 16, planes[0].shape[1], 1024,
                                  _build.sm_count(cuda))
    got = probes.slice_gram(*planes, mode="full")
    assert torch.equal(got, probes.slice_gram_plain(*planes, mode="full",
                                                    run=plan.run))
    assert torch.equal(probes._slice_gram(*planes, "full", 1024, 1),
                       probes.slice_gram_plain(*planes, mode="full"))


def test_slice_gram_kernel_raises_on_what_it_does_not_take(cuda):
    ahi, alo, bhi, blo = make_planes(16, 4, 128, 64, cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        probes.slice_gram(ahi[:8].contiguous(), alo[:8].contiguous(), bhi,
                          blo, nr=64)
    with pytest.raises(ValueError, match="contiguous"):
        probes.slice_gram(ahi[:, ::2], alo[:, ::2], bhi[:, ::2], blo[:, ::2],
                          nr=64)
    with pytest.raises(ValueError, match="multiple of 64"):
        probes.slice_gram(ahi, alo, bhi, blo, nr=32)
    big = make_planes(16, 17, 128, 64, cuda)
    with pytest.raises(ValueError, match="Q <= 16"):
        probes.slice_gram(*big, nr=64)
    with pytest.raises(ValueError, match="run"):
        probes._slice_gram(ahi, alo, bhi, blo, "full", 64, 0)
    with pytest.raises(TypeError):
        probes.bf16_mma_tile_check(ahi[:, :64].contiguous(),
                                   ahi[:, :64].contiguous())


@pytest.mark.parametrize("layout", ["dia", "csr"])
def test_captured_cg_stage_matches_eager(cuda, layout):
    """The f32 CG stage replayed from its CUDA graph against the same stage
    run eagerly, and against the early-exit CG: equal bits, over several
    calls with other residuals, masks and shifts on the same buffers."""
    if layout == "dia":
        rows, cols, vals, n = _laplacian_27(12)
        op = make_operator(rows, cols, vals, (n, n), device=cuda)
    else:
        a, (rowptr, colidx, values) = _irregular_csr(3000, seed=4)
        sym = (a + a.T + sps.identity(3000) * 40.0).tocoo()
        op = onehot.CsrOperator.from_coo(sym.row, sym.col, sym.data,
                                         sym.shape, device=cuda)
        n = 3000
    bs = 10
    cg = BlockPCGParams(max_iter=15, rate=1e-2, tol=1e-14)
    key, counters = ("dia_f32", spmm.LAUNCHES) if layout == "dia" else \
        ("csr_f32", onehot.LAUNCHES)
    counters[key] = 0
    captured = gcg._MixedStage(op, None, cg, bs, fixed=True, capture=True)
    # the warm-up before the capture launched one stage's kernels; the
    # capture itself launched none
    per_stage = counters[key]
    assert per_stage >= cg.max_iter
    eager = gcg._MixedStage(op, None, cg, bs, fixed=True, capture=False)
    early = gcg._MixedStage(op, None, cg, bs, fixed=False, capture=False)
    assert captured.graph is not None and eager.graph is None
    g = torch.Generator(device=cuda).manual_seed(1)
    replays = gcg.GRAPH_REPLAYS["cg_stage"]
    for trial, active in enumerate((10, 7, 0)):
        r = torch.randn((n, bs), generator=g, dtype=torch.float64,
                        device=cuda)
        mask = torch.arange(bs, device=cuda) < active
        sigma = torch.full((), 0.5 + trial, dtype=torch.float64, device=cuda)
        was = counters[key]
        d_cap, k_cap = captured(r, mask, sigma)
        # a replay counts the kernels it launches, as the eager stage does
        assert counters[key] - was == per_stage
        d_eag, k_eag = eager(r, mask, sigma)
        assert counters[key] - was == 2 * per_stage
        d_ear, k_ear = early(r, mask, float(sigma))
        assert torch.equal(d_cap, d_eag) and torch.equal(d_cap, d_ear)
        assert int(k_cap) == int(k_eag) == int(k_ear)
        assert d_cap.dtype == torch.float64 and d_cap.shape == (n, bs)
    assert gcg.GRAPH_REPLAYS["cg_stage"] == replays + 3


def test_fused_solve_on_card_matches_phased_and_cpu(cuda):
    """A small headline-style solve by the fused loop on the card (captured
    CG stage) against the phased loop on the card (equal counts, eigenvalues
    within 1e-10) and against the fused loop on the CPU (within 1e-10)."""
    rows, cols, vals, n = _laplacian_27(10)
    a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    x0 = np.random.default_rng(0).uniform(-1, 1, (n, 20))
    kw = dict(nev=10, block_size=10, max_iter=120, cg_max_iter=30,
              cg_mixed=True, cg_refine=2, cg_auto_shift=True, verbose=0,
              x0=x0)
    replays = gcg.GRAPH_REPLAYS["cg_stage"]
    ev_f, _, conv_f = solve(a, device=cuda, fuse=5, **kw)
    assert gcg.GRAPH_REPLAYS["cg_stage"] > replays
    ev_p, _, conv_p = solve(a, device=cuda, fuse=0, **kw)
    ev_c, _, conv_c = solve(a, device="cpu", fuse=5, **kw)
    assert conv_f == conv_p >= 10 and conv_c >= 10
    assert np.max(np.abs(ev_f - ev_p) / np.abs(ev_p)) <= 1e-10
    assert np.max(np.abs(ev_f - ev_c) / np.abs(ev_c)) <= 1e-10


def _fem_hierarchy(nx, device):
    """The cube FEM pair's hierarchy at ``nx`` (four levels at nx=12: DIA,
    Hybrid, CSR and DIA operators, CSR transfers)."""
    rows, cols, av, bv, n = cube_fem_laplacian(nx)
    return multigrid.build_hierarchy(rows, cols, av, n, b_vals=bv,
                                     device=device), n


@pytest.mark.parametrize("smoother", ["chebyshev", "cg"])
def test_vcycle_on_card_matches_cpu(cuda, smoother):
    """One V-cycle (and ``bamg_preconditioner``'s) on the card against the
    same on the CPU: 1e-12 of the largest entry; kernels 1 and 6 launched
    (the fine DIA level, the CSR level and the transfers)."""
    h_gpu, n = _fem_hierarchy(12, cuda)
    h_cpu, _ = _fem_hierarchy(12, "cpu")
    assert [type(lv.a_op).__name__ for lv in h_gpu.levels] == \
        ["DiaOperator", "HybridOperator", "CsrOperator", "DiaOperator"]
    rng = np.random.default_rng(0)
    b = rng.standard_normal((n, 10))
    spmm.LAUNCHES["dia_f64"] = onehot.LAUNCHES["csr_f64"] = 0
    got = multigrid._vcycle(h_gpu, 0, torch.as_tensor(b, device=cuda),
                            torch.zeros((n, 10), dtype=torch.float64,
                                        device=cuda), (2, 2, 2, 2), 30,
                            1e-16, 1e-13, smoother)
    ref = multigrid._vcycle(h_cpu, 0, torch.as_tensor(b),
                            torch.zeros((n, 10), dtype=torch.float64),
                            (2, 2, 2, 2), 30, 1e-16, 1e-13, smoother)
    assert spmm.LAUNCHES["dia_f64"] > 0 and onehot.LAUNCHES["csr_f64"] > 0
    scale = ref.abs().max()
    assert (got.cpu() - ref).abs().max() <= 1e-12 * scale
    pre = multigrid.bamg_preconditioner(h_gpu)(torch.as_tensor(b, device=cuda))
    pre_ref = multigrid.bamg_preconditioner(h_cpu)(torch.as_tensor(b))
    assert (pre.cpu() - pre_ref).abs().max() <= 1e-12 * pre_ref.abs().max()


def test_captured_cg_stage_with_preconditioner_matches_eager(cuda):
    """The f32 CG stage with ``bamg_preconditioner`` inside it, replayed
    from its CUDA graph, against the same stage run eagerly: equal bits over
    several residuals, masks and shifts; a replay counts the V-cycle's
    kernel-1 and kernel-6 launches."""
    h, n = _fem_hierarchy(12, cuda)
    op = h.levels[0].a_op
    pre = multigrid.bamg_preconditioner(h)
    bs = 10
    cg = BlockPCGParams(max_iter=15, rate=1e-2, tol=1e-14)
    captured = gcg._MixedStage(op, None, cg, bs, fixed=True, capture=True,
                               precond=pre)
    eager = gcg._MixedStage(op, None, cg, bs, fixed=True, capture=False,
                            precond=pre)
    assert captured.graph is not None and captured.transposed
    g = torch.Generator(device=cuda).manual_seed(2)
    for trial, active in enumerate((10, 6)):
        r = torch.randn((n, bs), generator=g, dtype=torch.float64,
                        device=cuda)
        mask = torch.arange(bs, device=cuda) < active
        sigma = torch.full((), -5.0 + trial, dtype=torch.float64,
                           device=cuda)
        was = dict(onehot.LAUNCHES)
        d_cap, k_cap = captured(r, mask, sigma)
        assert onehot.LAUNCHES["csr_f64"] > was["csr_f64"]
        d_eag, k_eag = eager(r, mask, sigma)
        assert torch.equal(d_cap, d_eag)
        assert int(k_cap) == int(k_eag)
        assert torch.isfinite(d_cap).all()


@pytest.mark.parametrize("m", [12, 40])
def test_bgs_orth_on_card_matches_cpu(cuda, m):
    """``bgs_orth`` on the card (kernels 3 and 4 in its projections)
    against the CPU: equal rank, the same zero columns, the span to 1e-12,
    B-orthonormal to 1e-12."""
    n = 5000
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, m))
    x[:, 5] = x[:, 2] + 0.5 * x[:, 1]
    d = rng.uniform(0.5, 2.0, n)
    d_gpu = torch.as_tensor(d, device=cuda)
    osgemm.LAUNCHES["gram"] = osgemm.LAUNCHES["expand"] = 0
    q_gpu, r_gpu = bgs_orth(torch.as_tensor(x, device=cuda),
                            lambda v: d_gpu[:, None] * v)
    assert osgemm.LAUNCHES["gram"] > 0 and osgemm.LAUNCHES["expand"] > 0
    q_cpu, r_cpu = bgs_orth(torch.as_tensor(x),
                            lambda v: torch.as_tensor(d)[:, None] * v)
    assert int(r_gpu) == int(r_cpu) == m - 1
    q, qc = q_gpu.cpu().numpy(), q_cpu.numpy()
    keep = np.abs(qc).max(axis=0) > 0
    assert np.array_equal(np.abs(q).max(axis=0) > 0, keep)
    q, qc = q[:, keep], qc[:, keep]
    assert np.abs(q.T @ (d[:, None] * q) - np.eye(m - 1)).max() <= 1e-12
    assert np.abs(q @ (q.T * d[None, :]) - qc @ (qc.T * d[None, :])).max() \
        <= 1e-12


@pytest.mark.parametrize("m", [1, 10, 75])
def test_csr_kernel_on_rectangular_transfers(cuda, m):
    """Kernel 6 on the hierarchy's rectangular P and R (at nx=24 the last
    restriction's rows reach 1,236 entries, past the tile budget of 1,024:
    the split path, or at m = 75 the panel path where the plan takes it)
    against the plain version on the same card: 1e-14 of max |P| |x|, in
    the (n, m) layout and transposed, equal bits across two launches and
    for the middle third of the rows as a CSR of its own, planned as the
    operator plans (colidx, values, columns) and on the path the whole
    matrix took (onehot.csr_path)."""
    h, _ = _fem_hierarchy(24, cuda)
    longest = h.levels[-2].r_op.rowptr.diff().max()
    assert int(longest) > onehot.CSR_BUDGET
    for lv in h.levels[:-1]:
        for op in (lv.p_op, lv.r_op):
            assert isinstance(op, onehot.CsrOperator)
            assert op.shape[0] != op.shape[1]
            for transposed in (False, True):
                g = torch.Generator(device=cuda).manual_seed(m)
                x = torch.randn((op.shape[1], m), generator=g,
                                dtype=torch.float64, device=cuda)
                if transposed:
                    x = x.T.contiguous()
                got = onehot.csr_spmm(op.rowptr, op.colidx, op.values, x,
                                      transposed, op.plan)
                ref = onehot.csr_spmm_reference(op.rowptr, op.colidx,
                                                op.values, x, transposed)
                scale = onehot.csr_spmm_reference(
                    op.rowptr, op.colidx, op.values.abs(), x.abs(),
                    transposed).max()
                assert (got - ref).abs().max() <= 1e-14 * scale
                assert torch.equal(got, onehot.csr_spmm(
                    op.rowptr, op.colidx, op.values, x, transposed, op.plan))
                # the rows of the long restriction's middle third as a CSR
                # of their own: the same bits
                n = op.shape[0]
                r0, r1 = n // 3, 2 * n // 3
                rp, ci, va = _csr_rows_of(op.rowptr, op.colidx, op.values,
                                          r0, r1)
                part = onehot.csr_spmm(
                    rp, ci, va, x, transposed,
                    onehot.csr_plan(rp, ci, va, op.shape[1]),
                    onehot.csr_path(op.plan, op.values, m))
                whole = got.T if transposed else got
                assert torch.equal(part.T if transposed else part,
                                   whole[r0:r1])


# ---------------------------------------------------------------------------
# the halo window of kernels 1 and 2, and a one-rank NCCL mesh
# ---------------------------------------------------------------------------


def _halo_operand(layout, n, hl, hr, m, dtype, device, seed):
    """x of a windowed product: ``n + hl + hr`` rows in ``layout``."""
    return _operand(layout, n + hl + hr, m, dtype, device, seed)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-14),
                                       (torch.float32, 1e-6)])
@pytest.mark.parametrize("m", [1, 10, 16])
@pytest.mark.parametrize("layout", _LAYOUTS)
@pytest.mark.parametrize("halo", [(111, 111), (0, 111), (120, 3)])
def test_dia_halo_kernel_matches_plain(cuda, dtype, tol, m, layout, halo):
    """Kernels 1 and 2 on a halo window (the 27-point stencil at nx=12,
    offsets up to 157 apart; a window of a rank's rows between its
    neighbours' halos) against the plain version: within tol of
    max |A||x|, equal bits across two launches, ``(n, m)`` or ``(m, n)`` in
    the memory order of x."""
    rows, cols, vals, n = _laplacian_27(12)
    op = make_operator(rows, cols, vals, (n, n), dtype=dtype, device=cuda)
    x, transposed = _halo_operand(layout, n, *halo, m, dtype, cuda, 3)
    got = spmm.dia_spmm(op.values, op.offsets_t, x, transposed, halo)
    again = spmm.dia_spmm(op.values, op.offsets_t, x, transposed, halo)
    assert torch.equal(got, again)
    assert got.shape == ((m, n) if transposed else (n, m))
    assert got.stride() == spmm.empty_in_order_of(x, got.shape).stride()
    ref = spmm.dia_spmm_reference(op.values, op.offsets_t, x, transposed,
                                  halo)
    scale = spmm.dia_spmm_reference(op.values.abs(), op.offsets_t, x.abs(),
                                    transposed, halo).max()
    assert float((got - ref).abs().max()) <= tol * float(scale)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("layout", _LAYOUTS)
def test_dia_zero_halo_keeps_the_square_bits(cuda, dtype, layout):
    """``halo=(0, 0)`` is the square product: its bits equal those of the
    same product on x between zero halos (the window path adds exact
    zeros where the square one skips a term)."""
    rows, cols, vals, n = _laplacian_27(12)
    op = make_operator(rows, cols, vals, (n, n), dtype=dtype, device=cuda)
    x, transposed = _operand(layout, n, 10, dtype, cuda, 4)
    hl = hr = 157
    xn = x.T if transposed else x
    w = torch.nn.functional.pad(xn, (0, 0, hl, hr))
    square = spmm.dia_spmm(op.values, op.offsets_t, x, transposed)
    window = spmm.dia_spmm(op.values, op.offsets_t,
                           w.T if transposed else w, transposed, (hl, hr))
    assert torch.equal(square, window)


def test_one_rank_nccl_mesh_matches_no_mesh(cuda):
    """A one-rank NCCL group on the card: the sharded DIA (halo window,
    kernels 1 and 2, the CG's all_reduce inside the captured stage) and CSR
    (kernels 5 and 6 on the window) solves equal the solves without a mesh
    bit for bit, on the fused and the phased loop."""
    import socket

    import torch.distributed as dist

    from gcge_tpu_torch import GCGParams, gcg_solve
    from gcge_tpu_torch.parallel import (dist_ops, row_mesh,
                                         shard_operator)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = row_mesh()
        rows, cols, vals, n = _laplacian_27(12)
        dia = make_operator(rows, cols, vals, (n, n), device=cuda)
        a, _ = _irregular_csr(3000, seed=4)
        sym = (a + a.T + sps.identity(3000) * 40.0).tocoo()
        csr = onehot.CsrOperator.from_coo(sym.row, sym.col, sym.data,
                                          sym.shape, device=cuda)
        kw = dict(nev=6, block_size=3, max_iter=80, cg_mixed=True,
                  cg_auto_shift=True, verbose=0)
        for op, fuse in ((dia, 4), (dia, 0), (csr, 0), (csr, 4)):
            p = GCGParams(fuse=fuse, **kw)
            plain = gcg_solve(op, None, p)
            dist_ops.WINDOWED.update({k: 0 for k in dist_ops.WINDOWED})
            sharded = gcg_solve(shard_operator(op, mesh), None, p, mesh=mesh)
            assert np.array_equal(plain.eval, sharded.eval)
            assert torch.equal(plain.evec, sharded.evec)
            assert plain.num_iter == sharded.num_iter
            kind = "dia" if op is dia else "csr"
            assert dist_ops.WINDOWED[f"{kind}_f64"] > 0
            assert dist_ops.WINDOWED[f"{kind}_f32"] > 0
    finally:
        dist.destroy_process_group()


def test_one_rank_nccl_grid_matches_no_mesh(cuda):
    """A (1, 1) grid on a one-rank NCCL group (its row and column groups
    are new one-rank groups, set up by a collective before the f32 stage is
    captured): the sharded DIA solve equals the solve without a mesh bit
    for bit, on the fused and the phased loop."""
    import socket

    import torch.distributed as dist

    from gcge_tpu_torch import GCGParams, gcg_solve
    from gcge_tpu_torch.parallel import dist_ops, grid_mesh, shard_operator

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        grid = grid_mesh(1, 1)
        rows, cols, vals, n = _laplacian_27(12)
        dia = make_operator(rows, cols, vals, (n, n), device=cuda)
        kw = dict(nev=6, block_size=3, max_iter=80, cg_mixed=True,
                  cg_auto_shift=True, verbose=0)
        for fuse in (4, 0):
            p = GCGParams(fuse=fuse, **kw)
            plain = gcg_solve(dia, None, p)
            dist_ops.WINDOWED.update({k: 0 for k in dist_ops.WINDOWED})
            sharded = gcg_solve(shard_operator(dia, grid), None, p,
                                mesh=grid)
            assert np.array_equal(plain.eval, sharded.eval)
            assert torch.equal(plain.evec, sharded.evec)
            assert plain.num_iter == sharded.num_iter
            assert dist_ops.WINDOWED["dia_f64"] > 0
            assert dist_ops.WINDOWED["dia_f32"] > 0
    finally:
        dist.destroy_process_group()


def _warm_h1(me, batch, noise, device, seed):
    """``(B, me, me)`` matrices ``u0^T h u0`` of random symmetric ``h``
    with warm starts carrying ``noise`` of error (the Jacobi kernel's
    operand in ``jacobi_polish``)."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((batch, me, me), generator=g, dtype=torch.float64)
    h = a + a.transpose(-2, -1)
    _, q = torch.linalg.eigh(h)
    q = q + noise * torch.randn(q.shape, generator=g, dtype=torch.float64)
    h1 = q.transpose(-2, -1) @ h @ q
    return (0.5 * (h1 + h1.transpose(-2, -1))).to(device)


@pytest.mark.parametrize("me,batch,noise", [
    (2, 3, 1.0), (64, 64, 1e-6), (120, 1, 1e-6), (80, 1, 1e-3),
    (160, 1, 1e-6), (240, 1, 1e-6), (120, 1, 0.0), (480, 2, 1e-6),
    (480, 1, 1e-6), (512, 8, 1e-6), (960, 1, 1e-6), (100, 1, 1e-6)])
def test_jacobi_kernel_has_the_plain_bits(cuda, me, batch, noise):
    """The Jacobi kernel (``csrc/jacobi.cu``) at the launch shapes of the
    solves (a batch of cluster blocks over two SMs each; one matrix on a
    cluster of 16 with H's buffers and V in shared memory, V alone there
    (480, 512), neither (960); 100 over 15 blocks of 7 rows and the last
    of 2) against its plain version on the card: the same sweep counts and
    the same bits (both round every operation once, in the same order),
    twice."""
    h1 = _warm_h1(me, batch, noise, cuda, me)
    for _ in range(2):
        hk, vk, kk = eighs.jacobi_sweeps(h1, 6)
        hp, vp, kp = eighs.jacobi_sweeps_plain(h1, 6)
        torch.cuda.synchronize()
        assert torch.equal(kk, kp)
        assert torch.equal(hk, hp) and torch.equal(vk, vp)
    if noise:
        assert int(kk.min()) > 0


@pytest.mark.parametrize("cluster", [1, 2, 3, 16])
@pytest.mark.parametrize("me,batch", [(2, 2), (30, 3), (240, 2)])
def test_jacobi_kernel_at_every_cluster_size_has_the_plain_bits(
        cuda, me, batch, cluster):
    """The kernel with its cluster size forced (blocks that own no rows at
    me = 2 over 3 or 16, and at 30 over 16; 240 over 16 as the plan's,
    over 1 with both matrices in device memory): the plain version's bits
    and sweep counts, launched as a cluster."""
    h1 = _warm_h1(me, batch, 1e-3, cuda, me + cluster)
    before = eighs.LAUNCHES["jacobi"]
    hk, vk, kk = eighs.jacobi_sweeps(h1, 6, cluster=cluster)
    hp, vp, kp = eighs.jacobi_sweeps_plain(h1, 6)
    torch.cuda.synchronize()
    assert eighs.LAUNCHES["jacobi"] == before + 1
    assert torch.equal(kk, kp) and int(kk.min()) > 0
    assert torch.equal(hk, hp) and torch.equal(vk, vp)


@pytest.mark.parametrize("me,batch", [(64, 64), (480, 8)])
def test_jacobi_kernel_on_a_ranks_slice_has_the_batch_bits(cuda, me, batch):
    """``eigh_newton`` under a mesh polishes each rank's slice of the
    cluster blocks: the Jacobi kernel on each 4-way slice of a batch (64
    blocks of 64, the cluster stage's; 8 of 480, the closing stage's at
    nev=200) from a 1e-6 warm start gives the bits and sweep counts of the
    matching blocks of the whole batch's launch (each block stops on its
    own)."""
    h1 = _warm_h1(me, batch, 1e-6, cuda, me + batch)
    whole = eighs.jacobi_sweeps(h1, 4)
    kb = batch // 4
    for r in range(4):
        part = eighs.jacobi_sweeps(h1[r * kb:(r + 1) * kb], 4)
        for got, ref in zip(part, whole):
            assert torch.equal(got, ref[r * kb:(r + 1) * kb])
    assert int(whole[2].min()) > 0


def test_eighs_on_the_card_match_the_cpu(cuda):
    """``eigh_jacobi`` and ``eigh_newton`` on the card against the same
    functions on the CPU and against LAPACK: eigenvalues 1e-12, residual
    and orthonormality 1e-12; the Jacobi kernel launched."""
    g = torch.Generator().manual_seed(3)
    q, _ = torch.linalg.qr(torch.randn((200, 200), generator=g,
                                       dtype=torch.float64))
    lam = torch.cat([torch.full((70,), 1.0) + 1e-9 * torch.arange(70),
                     torch.linspace(2.0, 9.0, 130, dtype=torch.float64)])
    h = (q * lam) @ q.T
    h = 0.5 * (h + h.T)
    eighs.LAUNCHES["jacobi"] = 0
    for fn in (eighs.eigh_jacobi, eighs.eigh_newton):
        w, u = fn(h.to(cuda))
        w_cpu, _ = fn(h)
        w, u = w.cpu(), u.cpu()
        assert (w - w_cpu).abs().max() <= 1e-12 * 9.0
        assert (w - lam).abs().max() <= 1e-12 * 9.0
        assert (h @ u - u * w).abs().max() <= 1e-12 * 9.0
        assert (u.T @ u - torch.eye(200, dtype=torch.float64)).abs().max() \
            <= 1e-12
    assert eighs.LAUNCHES["jacobi"] >= 2
