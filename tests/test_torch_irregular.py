"""The port's irregular-matrix slice as a whole against gcge_tpu on the same
inputs: gcg_solve with the mixed inner CG on a CsrOperator and on a
HybridOperator, and solve(rcm=True).

Both packages get the same full-width starting block from numpy.  Where
gcge_tpu runs its one-hot Pallas kernels (EllOneHotOperator), they run in
interpret mode, as tests/test_onehot.py runs them on the CPU.  Eigenvalues
must agree to 1e-10 relative, the converged counts must be equal and the
iteration counts within 2 (the f32 stages of the mixed inner CG sum in
another order, so the convergence test can fire one iteration earlier or
later).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import gcge_tpu
from gcge_tpu.ops.operators import EllOneHotOperator as JEllOneHot
from gcge_tpu.ops.operators import HybridOperator as JHybrid
from gcge_tpu.solvers.gcg import GCGParams as JParams
from gcge_tpu.solvers.gcg import gcg_solve as j_gcg_solve
import gcge_tpu_torch
from gcge_tpu_torch import CsrOperator, GCGParams, HybridOperator, gcg_solve
from gcge_tpu_torch.io.fem import assemble_p1, random_delaunay_mesh
from gcge_tpu_torch.ops import onehot
from gcge_tpu_torch.solvers import gcg as tgcg

torch.set_num_threads(2)

# the irregular solve's parameters (mixed inner CG in three stages, auto
# shift, phased loop), at a small size
IRREGULAR = dict(nev=8, block_size=4, max_iter=200, cg_max_iter=60,
                 cg_mixed=True, cg_refine=3, cg_auto_shift=True, fuse=0,
                 verbose=0)


def _assert_parity(tr, jr, nev):
    assert tr.nev_conv >= nev and tr.nev_conv == jr.nev_conv
    ev_t, ev_j = np.asarray(tr.eval)[:nev], np.asarray(jr.eval)[:nev]
    assert np.max(np.abs(ev_t - ev_j) / np.abs(ev_j)) <= 1e-10
    assert abs(tr.num_iter - jr.num_iter) <= 2


def _residuals(a, ev, x):
    r = a @ x - x * ev[None, :]
    return np.linalg.norm(r, axis=0) / (np.abs(ev) * np.linalg.norm(x, axis=0))


@pytest.fixture(scope="module")
def delaunay():
    """P1 stiffness matrix on a 10^3 unstructured Delaunay mesh (n = 729,
    6 to ~25 entries a row), as the irregular slice builds it."""
    rows, cols, av, _, n = assemble_p1(*random_delaunay_mesh(10 ** 3, seed=1))
    x0 = np.random.default_rng(0).uniform(-1, 1, (n, 16))
    return rows, cols, av, n, x0


def _laplacian_1d(n):
    r = np.arange(n)
    rows = np.concatenate([r, r[:-1], r[1:]])
    cols = np.concatenate([r, r[1:], r[:-1]])
    vals = np.concatenate([np.full(n, 2.0), np.full(2 * (n - 1), -1.0)])
    return rows, cols, vals


def test_csr_gcg_solve_matches_jax_onehot_delaunay(delaunay, monkeypatch):
    """gcg_solve(cg_mixed) on a CsrOperator against gcge_tpu on an
    EllOneHotOperator: the f32 stages run transposed through block_pcg_t on
    the f32 copy of the values, the f64 applications on the f64 values."""
    rows, cols, vals, n, x0 = delaunay
    jop = JEllOneHot.from_coo(rows, cols, vals, (n, n), r_tile=128,
                              w_tile=128, j_max=128)
    jr = j_gcg_solve(jop, None, JParams(**IRREGULAR), x0=jnp.asarray(x0))
    top = CsrOperator.from_coo(rows, cols, vals, (n, n), device="cpu")
    seen = {"t": 0, "n": 0}
    real_t, real_n = tgcg.block_pcg_t, tgcg.block_pcg

    def spy_t(mv, r, *args, **kw):
        assert r.dtype == torch.float32 and r.shape == (4, n)
        seen["t"] += 1
        return real_t(mv, r, *args, **kw)

    def spy_n(*args, **kw):
        seen["n"] += 1
        return real_n(*args, **kw)

    monkeypatch.setattr(tgcg, "block_pcg_t", spy_t)
    monkeypatch.setattr(tgcg, "block_pcg", spy_n)
    tr = gcg_solve(top, None, GCGParams(**IRREGULAR), x0=x0)
    _assert_parity(tr, jr, 8)
    assert seen["t"] == 3 * tr.num_iter and seen["n"] == 0
    assert top._values32 is not None and top._values32.dtype == torch.float32
    assert onehot.LAUNCHES["csr_f32"] == 0 == onehot.LAUNCHES["csr_f64"]
    a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    assert _residuals(a, tr.eval[:8], tr.evec[:, :8].numpy()).max() <= 2e-8


def test_csr_gcg_solve_matches_jax_onehot_laplacian_1d():
    """The 1-D Laplacian of gcge_tpu's own one-hot solve test, against it and
    the analytic spectrum."""
    n = 400
    rows, cols, vals = _laplacian_1d(n)
    kw = dict(nev=6, block_size=3, max_iter=80, verbose=0, cg_mixed=True,
              cg_refine=2, cg_max_iter=30)
    x0 = np.random.default_rng(1).uniform(-1, 1, (n, 12))
    jop = JEllOneHot.from_coo(rows, cols, vals, (n, n), r_tile=128,
                              w_tile=128, j_max=128)
    jr = j_gcg_solve(jop, None, JParams(**kw), x0=jnp.asarray(x0))
    top = CsrOperator.from_coo(rows, cols, vals, (n, n), device="cpu")
    tr = gcg_solve(top, None, GCGParams(**kw), x0=x0)
    _assert_parity(tr, jr, 6)
    exact = 2 - 2 * np.cos(np.arange(1, 7) * np.pi / (n + 1))
    np.testing.assert_allclose(tr.eval[:6], exact, rtol=1e-7)


def test_hybrid_gcg_solve_matches_jax():
    """gcg_solve(cg_mixed) on a HybridOperator (f32 twin of both parts,
    (n, m) layout through block_pcg) against gcge_tpu's HybridOperator: a
    banded SPD core on 9 diagonals plus one far outlier pair a row."""
    rng = np.random.default_rng(3)
    n = 500
    rows, cols, vals = [], [], []
    for off in range(1, 5):
        r = np.arange(n - off)
        w = -rng.uniform(0.5, 1.5, n - off)
        rows += [r, r + off]
        cols += [r + off, r]
        vals += [w, w]
    r = np.arange(0, n - 150, 3)
    c = r + 120 + r % 30
    w = -rng.uniform(0.1, 0.3, len(r))
    rows += [r, c, np.arange(n)]
    cols += [c, r, np.arange(n)]
    vals += [w, w, np.zeros(n)]
    rows, cols, vals = map(np.concatenate, (rows, cols, vals))
    diag = np.bincount(rows, weights=-vals, minlength=n) \
        + rng.uniform(0.5, 1.5, n)
    vals[-n:] = diag                                  # diagonally dominant
    jop = JHybrid.from_coo(rows, cols, vals, (n, n), max_diags=9)
    top = HybridOperator.from_coo(rows, cols, vals, (n, n), device="cpu",
                                  max_diags=9)
    assert top.rest is not None and jop.ell is not None
    kw = dict(nev=6, block_size=3, max_iter=150, verbose=0, cg_mixed=True,
              cg_refine=2, cg_max_iter=30, cg_auto_shift=True)
    x0 = np.random.default_rng(4).uniform(-1, 1, (n, 12))
    jr = j_gcg_solve(jop, None, JParams(**kw), x0=jnp.asarray(x0))
    tr = gcg_solve(top, None, GCGParams(**kw), x0=x0)
    _assert_parity(tr, jr, 6)
    a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    assert _residuals(a, tr.eval[:6], tr.evec[:, :6].numpy()).max() <= 2e-8


def test_solve_rcm_matches_jax(delaunay):
    """solve(rcm=True) against gcge_tpu.solve(rcm=True) on the Delaunay
    matrix given in a scrambled ordering: the same eigenvalues, and the same
    eigenvectors in the caller's ordering up to sign (1e-6: the vectors are
    converged to a residual of 1e-8 over gaps of a few percent)."""
    rows, cols, vals, n, x0 = delaunay
    scramble = np.random.default_rng(9).permutation(n)
    a = sps.coo_matrix((vals, (scramble[rows], scramble[cols])),
                       shape=(n, n)).tocsr()
    kw = {k: v for k, v in IRREGULAR.items() if k != "nev"}
    ev_j, evec_j, conv_j = gcge_tpu.solve(a, None, nev=8, rcm=True,
                                          x0=jnp.asarray(x0), **kw)
    ev_t, evec_t, conv_t = gcge_tpu_torch.solve(a, None, nev=8, rcm=True,
                                                device="cpu", x0=x0, **kw)
    assert conv_t >= 8 and conv_t == conv_j
    assert np.max(np.abs(ev_t - np.asarray(ev_j)) / np.abs(ev_j)) <= 1e-10
    xt, xj = evec_t[:, :8].numpy(), np.asarray(evec_j)[:, :8]
    assert _residuals(a, ev_t, xt).max() <= 2e-8      # caller's ordering
    sign = np.sign(np.sum(xt * xj, axis=0))
    assert np.abs(xt * sign[None, :] - xj).max() <= 1e-6 * np.abs(xj).max()
    with pytest.raises(ValueError, match="sparse"):
        gcge_tpu_torch.solve(a.toarray(), nev=2, rcm=True, device="cpu")
    with pytest.raises(ValueError, match="prebuilt"):
        gcge_tpu_torch.api._as_operator(
            CsrOperator.from_scipy(a, device="cpu"), torch.float64, "cpu",
            perm=np.arange(n))


@pytest.mark.slow
def test_irregular_iterations_match_jax_at_middle_size():
    """The irregular cell's solve (nev=50, block 10, inner CG budget 60 in
    three mixed stages, auto shift, phased loop) on the P1 stiffness matrix
    of a 30^3-point Delaunay mesh (seed 1, n = 24,389) after RCM, as
    ``benchmarks/irregular.py`` orders it, in both packages in f64 on the
    CPU from the same starting block: gcge_tpu on the operator its
    ``make_operator`` picks off the TPU (gather-ELL), the port on
    ``CsrOperator``.  The same converged count, iterations within 2,
    eigenvalues within 1e-10.  It prints both counts.  About two minutes;
    ``-m 'not slow'`` deselects it."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from gcge_tpu.io.fem import assemble_p1 as j_assemble_p1
    from gcge_tpu.io.fem import random_delaunay_mesh as j_delaunay
    from gcge_tpu.ops.operators import make_operator as j_make_operator
    from gcge_tpu_torch import make_operator

    def rcm_matrix(mesh, assemble):
        rows, cols, av, _, n = assemble(*mesh(30 ** 3, seed=1))
        a = sps.coo_matrix((av, (rows, cols)), shape=(n, n)).tocsr()
        perm = reverse_cuthill_mckee(a, symmetric_mode=True)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n)
        return inv[rows], inv[cols], av, n

    kw = dict(nev=50, block_size=10, max_iter=300, cg_max_iter=60,
              cg_refine=3, cg_mixed=True, cg_auto_shift=True, fuse=0,
              verbose=0)
    rows, cols, vals, n = rcm_matrix(j_delaunay, j_assemble_p1)
    x0 = np.random.default_rng(0).uniform(-1, 1, (n, 100))
    jr = j_gcg_solve(j_make_operator(rows, cols, vals, (n, n)), None,
                     JParams(**kw), x0=jnp.asarray(x0))
    t_rows, t_cols, t_vals, _ = rcm_matrix(random_delaunay_mesh, assemble_p1)
    np.testing.assert_array_equal(t_rows, rows)
    np.testing.assert_array_equal(t_cols, cols)
    top = make_operator(t_rows, t_cols, t_vals, (n, n), device="cpu")
    assert isinstance(top, CsrOperator)
    tr = gcg_solve(top, None, GCGParams(**kw), x0=x0)
    print(f"irregular n={n}: gcge_tpu {jr.num_iter} iterations, "
          f"{jr.nev_conv} converged; gcge_tpu_torch {tr.num_iter} "
          f"iterations, {tr.nev_conv} converged")
    _assert_parity(tr, jr, 50)
