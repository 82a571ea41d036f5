"""The port's PAS solver (``gcge_tpu_torch.solvers.pas``) against
``gcge_tpu``'s on the same numpy inputs, f64 on the CPU.

Inputs are those of ``tests/test_pas.py``: the composite operator on a
random symmetric matrix, the 1-D Laplacian at n=400 with three levels
(explicit span, fused and phased sweeps, and the composite Rayleigh-Ritz),
and the cube FEM pair at nx=6 with its mass matrices coarsened.  Each
``gcge_tpu`` result is computed once, in a module fixture.

Tolerances: the composite operator's action to 1e-11 of the dense
``PASMAT``'s; PAS eigenvalues within 1e-9 of ``gcge_tpu``'s and equal
converged counts.  The coarsest level's GCG starts from each package's own
random block, so the iterates are not the same bits: they agree in their
spans.  The port's fused and phased sweeps give equal bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sps
import torch

import gcge_tpu
from gcge_tpu.ops.operators import DenseOperator as JDense
from gcge_tpu.solvers import multigrid as jmg
from gcge_tpu.solvers import pas as jpas
import gcge_tpu_torch
from gcge_tpu_torch import DenseOperator
from gcge_tpu_torch.io.fem import cube_fem_laplacian
from gcge_tpu_torch.solvers import multigrid as tmg
from gcge_tpu_torch.solvers import pas as tpas
from tests.conftest import laplacian_1d, laplacian_1d_eigs

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_augmented_operator_matches_jax_and_the_dense_composite():
    """``AugmentedOperator.matvec`` against ``gcge_tpu``'s and against the
    explicit ``PASMAT = [Xp^T A Xp, Xp^T A; A Xp, A]``; ``to_fine``
    collapses ``[u; q]`` to ``Xp u + q``."""
    rng = np.random.default_rng(42)
    n, k, m = 60, 4, 3
    a = rng.standard_normal((n, n))
    a = a + a.T
    xp = rng.standard_normal((n, k))
    s = rng.standard_normal((n + k, m))
    op = tpas.AugmentedOperator(DenseOperator(_t(a)), _t(xp))
    jop = jpas.AugmentedOperator(JDense(jnp.asarray(a)), jnp.asarray(xp))
    assert op.shape == jop.shape == (n + k, n + k)
    pasmat = np.block([[xp.T @ a @ xp, xp.T @ a], [a @ xp, a]])
    got = op.matvec(_t(s)).numpy()
    np.testing.assert_allclose(got, pasmat @ s, rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(got, np.asarray(jop.matvec(jnp.asarray(s))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(op.to_fine(_t(s)).numpy(),
                               xp @ s[:k] + s[k:], rtol=1e-13)


def _lap_coo(n):
    a, _ = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    return rows, cols, a[rows, cols]


# name: (problem, max_levels, pas_solve keywords)
_CASES = {
    "explicit": ("lap400", 3, dict(nev=4, final_sweeps=10, bamg_cycles=6,
                                   tol_rel=1e-7)),
    "composite": ("lap400", 3, dict(nev=6, final_sweeps=12, bamg_cycles=6,
                                    tol_rel=1e-7, composite_rr=True)),
    "fem": ("fem6", 2, dict(nev=4, final_sweeps=8, tol_rel=1e-6)),
}


def _problem(name):
    if name == "lap400":
        rows, cols, vals = _lap_coo(400)
        return rows, cols, vals, None, 400
    return cube_fem_laplacian(6)


@pytest.fixture(scope="module")
def cases():
    """Each case's ``gcge_tpu`` result and the port's hierarchy."""
    out = {}
    for name, (prob, levels, kw) in _CASES.items():
        rows, cols, av, bv, n = _problem(prob)
        jh = jmg.build_hierarchy(rows, cols, av, n, b_vals=bv,
                                 max_levels=levels)
        th = tmg.build_hierarchy(rows, cols, av, n, b_vals=bv,
                                 max_levels=levels, device="cpu")
        nev = kw.pop("nev")
        jres = jpas.pas_solve(jh, nev, verbose=0, **kw)
        out[name] = (th, nev, kw, jres, (rows, cols, av, bv, n))
    return out


@pytest.mark.parametrize("name", list(_CASES))
def test_pas_solve_matches_jax(cases, name):
    """Eigenvalues within 1e-9 of ``gcge_tpu``'s and equal converged
    counts; the explicit-span cases also with ``fuse=False``, which is
    accepted and changes no bit; the levels' histories end at the
    result."""
    th, nev, kw, jres, _ = cases[name]
    runs = [tpas.pas_solve(th, nev, verbose=0, **kw)]
    if not kw.get("composite_rr"):
        runs.append(tpas.pas_solve(th, nev, verbose=0, fuse=False, **kw))
        np.testing.assert_array_equal(runs[0].eval, runs[1].eval)
        assert runs[0].sweeps == runs[1].sweeps
    for res in runs:
        # the FEM case stops short (``gcge_tpu`` declares 2 of 4 there too)
        assert res.nev_conv == jres.nev_conv
        assert res.nev_conv >= (2 if name == "fem" else nev)
        np.testing.assert_allclose(res.eval, np.asarray(jres.eval),
                                   rtol=1e-9)
        assert [lv for lv, _ in res.level_history] == \
            [lv for lv, _ in jres.level_history]
        np.testing.assert_array_equal(res.level_history[-1][1][:nev],
                                      res.eval)
        assert len(res.sweeps) == th.num_levels - 1
        assert res.evec.shape == (th.levels[0].a_op.shape[0], nev)


def test_pas_solve_reaches_the_exact_spectrum(cases):
    """The standard case against the closed form, the generalized one
    against scipy's dense pencil (both as ``tests/test_pas.py`` holds
    ``gcge_tpu``)."""
    th, nev, kw, _, _ = cases["explicit"]
    res = tpas.pas_solve(th, nev, verbose=0, **kw)
    np.testing.assert_allclose(res.eval, laplacian_1d_eigs(400)[:nev],
                               rtol=1e-6)
    th, nev, kw, _, (rows, cols, av, bv, n) = cases["fem"]
    res = tpas.pas_solve(th, nev, verbose=0, **kw)
    a = sps.coo_matrix((av, (rows, cols)), shape=(n, n)).toarray()
    b = sps.coo_matrix((bv, (rows, cols)), shape=(n, n)).toarray()
    exact = scipy.linalg.eigh(a, b, eigvals_only=True)
    np.testing.assert_allclose(res.eval, exact[:nev], rtol=1e-6)


def test_solve_pas_matches_jax():
    """``solve(method="pas")`` on the CPU against ``gcge_tpu.solve`` on the
    1-D Laplacian (n=400, three levels): eigenvalues 1e-9, equal converged
    counts; with ``pas_composite_rr`` the same spectrum; the eigenvectors
    come back in the caller's order under RCM."""
    a = sps.csr_matrix(laplacian_1d(400)[0])
    kw = dict(nev=4, multigrid=3, method="pas", pas_final_sweeps=10,
              pas_cycles=6, tol_rel=1e-7, verbose=0)
    ej, _, cj = gcge_tpu.solve(a, None, **kw)
    et, evec, ct = gcge_tpu_torch.solve(a, None, device="cpu", **kw)
    assert ct == cj >= 4
    np.testing.assert_allclose(et, np.asarray(ej)[:4], rtol=1e-9)
    assert evec.shape == (400, 4)
    ec, _, cc = gcge_tpu_torch.solve(a, None, device="cpu",
                                     pas_composite_rr=True, **kw)
    assert cc >= 4
    np.testing.assert_allclose(ec, et, rtol=1e-9)
    # a permuted copy of the matrix, and RCM back to the banded order
    perm = np.random.default_rng(0).permutation(400)
    ap = a[perm][:, perm].tocsr()
    ep, vp, cp = gcge_tpu_torch.solve(ap, None, device="cpu", rcm=True, **kw)
    assert cp >= 4
    np.testing.assert_allclose(ep, et, rtol=1e-9)
    x = vp.numpy()
    r = ap @ x - x * ep[None, :]
    assert np.abs(r).max() <= 1e-6 * np.abs(ep).max()
    with pytest.raises(ValueError, match="scipy sparse B"):
        gcge_tpu_torch.solve(a, np.ones(400), device="cpu", **kw)
