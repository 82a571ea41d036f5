"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one.  They import neither
JAX nor gcge_tpu, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from gcge_tpu_torch import make_operator, solve
from gcge_tpu_torch.ops import osgemm, spmm


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


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-14),
                                       (torch.float32, 1e-6)])
@pytest.mark.parametrize("transposed", [False, True])
def test_dia_kernel_matches_plain(cuda, dtype, tol, transposed):
    """Kernels 1 and 2 against the plain version: within tol of max |A||x|
    (sums of 27 terms in the working type)."""
    rows, cols, vals, n = _laplacian_27(12)
    op = make_operator(rows, cols, vals, (n, n), dtype=dtype, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    basis = torch.randn((n, 13), generator=g, dtype=dtype, device=cuda)
    x = basis[:, 1:11].T if transposed else basis[:, 1:11]   # strided views
    before = dict(spmm.LAUNCHES)
    got = spmm.dia_spmm(op.values, op.offsets_t, x, transposed)
    ref = spmm.dia_spmm_reference(op.values, op.offsets_t, x, transposed)
    scale = spmm.dia_spmm_reference(op.values.abs(), op.offsets_t, x.abs(),
                                    transposed).max()
    assert float((got - ref).abs().max()) <= tol * float(scale)
    key = "dia_f64" if dtype == torch.float64 else "dia_f32"
    assert spmm.LAUNCHES[key] == before[key] + 1


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
