"""The port's multigrid (``gcge_tpu_torch.solvers.multigrid``) against
``gcge_tpu``'s on the same numpy inputs, f64 on the CPU.

Inputs: the 1-D Laplacian of ``tests/test_multigrid.py`` (n=512, three
levels), the cube FEM pair at nx=6 (two levels, as ``tests/test_pas.py``)
and at nx=12 (four levels: DIA, Hybrid, CSR and DIA operators; its set-up,
its transfer and its preconditioner only, since ``gcge_tpu``'s side takes a
minute to compile the rest).  Each hierarchy is built once per package.

Tolerances: the set-up is the same scipy code, so every level's A, B, P and
R agree to 1e-15 of their largest entry and ``lam_max`` exactly; transfers,
Chebyshev smoothing, one V-cycle and one preconditioner application to
1e-12 of the result's largest entry; ``bamg_solve`` takes as many cycles and
gives ``x`` to 1e-10; GCG preconditioned by a V-cycle takes the same
iterations within one and gives eigenvalues within 1e-10, and the port's
phased and fused loops give the same eigenvalues.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import gcge_tpu
from gcge_tpu.ops.operators import make_operator as j_make_operator
from gcge_tpu.solvers import multigrid as jmg
from gcge_tpu.solvers.gcg import GCGParams as JParams
from gcge_tpu.solvers.gcg import gcg_solve as j_gcg_solve
import gcge_tpu_torch
from gcge_tpu_torch import CsrOperator, GCGParams, gcg_solve, make_operator
from gcge_tpu_torch.io.fem import cube_fem_laplacian
from gcge_tpu_torch.solvers import multigrid as tmg
from tests.conftest import laplacian_1d

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _problem(name):
    """``(rows, cols, a_vals, b_vals, n, max_levels)`` of a hierarchy case."""
    if name == "lap512":
        a, _ = laplacian_1d(512)
        rows, cols = np.nonzero(a)
        return rows, cols, a[rows, cols], None, 512, 3
    nx = {"fem6": 6, "fem12": 12}[name]
    rows, cols, av, bv, n = cube_fem_laplacian(nx)
    return rows, cols, av, bv, n, 4


_CACHE = {}


def _hier(name):
    """Both packages' hierarchies of a case, built once: ``(problem, jax
    hierarchy, port hierarchy)``."""
    if name not in _CACHE:
        rows, cols, av, bv, n, levels = prob = _problem(name)
        jh = jmg.build_hierarchy(rows, cols, av, n, b_vals=bv,
                                 max_levels=levels)
        th = tmg.build_hierarchy(rows, cols, av, n, b_vals=bv,
                                 max_levels=levels, device="cpu")
        _CACHE[name] = (prob, jh, th)
    return _CACHE[name]


def _dense(op):
    """A ``gcge_tpu`` operator (DIA, ELL or Hybrid) as a dense numpy matrix,
    from its arrays (its own ``to_dense`` loops over the diagonals
    eagerly, which takes minutes on the coarse levels)."""
    if hasattr(op, "dia"):
        out = _dense(op.dia)
        return out if op.ell is None else out + _dense(op.ell)
    values = np.asarray(op.values)
    if hasattr(op, "offsets"):
        n = values.shape[1]
        out = np.zeros((n, op.n_cols))
        for d, off in enumerate(op.offsets):
            i = np.arange(max(0, -off), min(n, op.n_cols - off))
            out[i, i + off] += values[d, i]
        return out
    out = np.zeros((values.shape[0], op.n_cols))
    rows = np.repeat(np.arange(values.shape[0]), values.shape[1])
    np.add.at(out, (rows, np.asarray(op.indices).ravel()), values.ravel())
    return out


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(got - ref).max() <= tol * scale


CASES = ["lap512", "fem6", "fem12"]


@pytest.mark.parametrize("name", CASES)
def test_build_hierarchy_matches_jax(name):
    """Equal level sizes; each level's A, B, P, R and 1/diag(A) within
    1e-15 of their largest entry; equal ``lam_max``; the transfers are CSR
    operators (one kernel-6 launch a product on the card)."""
    (_, _, _, bv, n, _), jh, th = _hier(name)
    assert th.num_levels == jh.num_levels >= 2
    assert len(th.setup) == th.num_levels
    for jl, tl in zip(jh.levels, th.levels):
        assert tl.a_op.shape == jl.a_op.shape
        assert tl.a_op.device.type == "cpu"
        _close(tl.a_op.to_dense().numpy(), _dense(jl.a_op), 1e-15)
        if bv is None:
            assert tl.b_op is None and jl.b_op is None
        else:
            _close(tl.b_op.to_dense().numpy(), _dense(jl.b_op), 1e-15)
        _close(tl.dinv.numpy(), jl.dinv, 1e-15)
        assert tl.lam_max == jl.lam_max
        if jl.p_op is None:
            assert tl.p_op is None and tl.r_op is None
            continue
        for t_op, j_op in ((tl.p_op, jl.p_op), (tl.r_op, jl.r_op)):
            assert isinstance(t_op, CsrOperator)
            assert t_op.shape == j_op.shape and t_op.shape[0] != t_op.shape[1]
            _close(t_op.to_dense().numpy(), _dense(j_op), 1e-15)


@pytest.mark.parametrize("name", ["lap512", "fem12"])
def test_rectangular_csr_transfer_matches_jax_ell(name):
    """The finest prolongator's COO packed as the port's CSR operator
    against the same COO packed by ``gcge_tpu``'s ``make_operator``
    (rectangular: ELL), P and R on a block of 5 columns: 1e-15 of
    max |P| |x|."""
    _, jh, _ = _hier(name)
    p = sps.coo_matrix(_dense(jh.levels[0].p_op))
    rng = np.random.default_rng(0)
    for r, c, shape in ((p.row, p.col, p.shape),
                        (p.col, p.row, (p.shape[1], p.shape[0]))):
        t_op = CsrOperator.from_coo(r, c, p.data, shape, device="cpu")
        j_op = j_make_operator(r, c, p.data, shape)
        x = rng.standard_normal((shape[1], 5))
        got = t_op.matvec(_t(x)).numpy()
        ref = np.asarray(j_op.matvec(jnp.asarray(x)))
        scale = (abs(sps.coo_matrix((p.data, (r, c)), shape=shape))
                 @ np.abs(x)).max()
        assert np.abs(got - ref).max() <= 1e-15 * scale


@pytest.mark.parametrize("name", ["lap512", "fem6"])
def test_transfers_and_smoother_match_jax(name):
    """``multivec_from_i_to_j`` down to the coarsest level and back, and
    three Chebyshev steps on each level: 1e-12.  (``gcge_tpu``'s side runs
    jitted here and below: eagerly it takes minutes.)"""
    (_, _, _, _, n, _), jh, th = _hier(name)
    top = th.num_levels - 1
    x = np.random.default_rng(1).standard_normal((n, 4))
    down_j = jax.jit(lambda v: jmg.multivec_from_i_to_j(jh, v, 0, top))(
        jnp.asarray(x))
    down_t = tmg.multivec_from_i_to_j(th, _t(x), 0, top)
    _close(down_t.numpy(), down_j, 1e-12)
    _close(tmg.multivec_from_i_to_j(th, down_t, top, 0).numpy(),
           jax.jit(lambda v: jmg.multivec_from_i_to_j(jh, v, top, 0))(
               down_j), 1e-12)
    assert tmg.multivec_from_i_to_j(th, down_t, top, top) is down_t
    rng = np.random.default_rng(2)
    for jl, tl in zip(jh.levels, th.levels):
        m = tl.a_op.shape[0]
        b, x0 = rng.standard_normal((m, 3)), rng.standard_normal((m, 3))
        ref = jax.jit(lambda b, x, jl=jl: jmg.chebyshev_smooth(
            jl.a_op.matvec, jl.dinv, b, x, jl.lam_max, 3))(
                jnp.asarray(b), jnp.asarray(x0))
        got = tmg.chebyshev_smooth(tl.a_op.matvec, tl.dinv, _t(b), _t(x0),
                                   tl.lam_max, 3)
        _close(got.numpy(), ref, 1e-12)


@pytest.mark.parametrize("smoother", ["cg", "chebyshev"])
@pytest.mark.parametrize("name", ["lap512", "fem6"])
def test_vcycle_matches_jax(name, smoother):
    """One V-cycle from a random guess, both smoothers: 1e-12."""
    (_, _, _, _, n, _), jh, th = _hier(name)
    rng = np.random.default_rng(3)
    b, x0 = rng.standard_normal((n, 3)), rng.standard_normal((n, 3))
    ref = jax.jit(lambda b, x: jmg._vcycle(
        jh, 0, b, x, (3, 3, 3, 3), 20, 1e-16, 1e-13, smoother))(
            jnp.asarray(b), jnp.asarray(x0))
    got = tmg._vcycle(th, 0, _t(b), _t(x0), (3, 3, 3, 3), 20, 1e-16, 1e-13,
                      smoother)
    _close(got.numpy(), ref, 1e-12)


@pytest.mark.parametrize("smoother", ["cg", "chebyshev"])
def test_bamg_solve_matches_jax(smoother):
    """``bamg_solve`` on the 512-point Laplacian: equal cycle counts, x to
    1e-10, the residual under rtol."""
    (_, _, _, _, n, _), jh, th = _hier("lap512")
    a, _ = laplacian_1d(n)
    x_true = np.random.default_rng(5).standard_normal((n, 3))
    b = a @ x_true
    xj, itj, _ = jmg.bamg_solve(jh, jnp.asarray(b), max_cycles=30, rtol=1e-9,
                                smoother=smoother)
    xt, itt, rel = tmg.bamg_solve(th, _t(b), max_cycles=30, rtol=1e-9,
                                  smoother=smoother)
    assert itt == itj < 30
    assert float(rel.max()) < 1e-9
    _close(xt.numpy(), xj, 1e-10)


@pytest.mark.parametrize("name", CASES)
def test_bamg_preconditioner_matches_jax(name):
    """``bamg_preconditioner``'s defaults applied to one block of 6: 1e-12;
    it reads nothing back (its coarse CG runs its whole budget)."""
    (_, _, _, _, n, _), jh, th = _hier(name)
    r = np.random.default_rng(4).standard_normal((n, 6))
    ref = jax.jit(jmg.bamg_preconditioner(jh))(jnp.asarray(r))
    got = tmg.bamg_preconditioner(th)(_t(r))
    _close(got.numpy(), ref, 1e-12)


def _amg_gcg_case():
    n = 600
    a, _ = laplacian_1d(n)
    rows, cols = np.nonzero(a)
    return n, rows, cols, a[rows, cols]


@pytest.fixture(scope="module")
def amg_gcg():
    """The 1-D Laplacian of ``test_bamg_preconditioner_helper`` at n=600
    (where its condition number, 1.5e5, leaves eigenvalues 1e-10 above the
    rounding floor; four levels down to 50 rows): GCG with
    ``bamg_preconditioner`` by ``gcge_tpu``, and the port's operator and
    hierarchy."""
    n, rows, cols, vals = _amg_gcg_case()
    x0 = np.random.default_rng(6).uniform(-1, 1, (n, 10))
    kw = dict(nev=5, block_size=3, max_iter=60, verbose=0, cg_max_iter=10)
    jh = jmg.build_hierarchy(rows, cols, vals, n, max_levels=4, min_coarse=50)
    jres = j_gcg_solve(j_make_operator(rows, cols, vals, (n, n)), None,
                       JParams(**kw, linear_precond=jmg.bamg_preconditioner(
                           jh)), x0=jnp.asarray(x0))
    th = tmg.build_hierarchy(rows, cols, vals, n, max_levels=4,
                             min_coarse=50, device="cpu")
    op = make_operator(rows, cols, vals, (n, n), device="cpu")
    return op, th, kw, x0, jres


@pytest.mark.parametrize("fuse", [0, 3])
def test_gcg_with_bamg_preconditioner_matches_jax(amg_gcg, fuse):
    """Both loops against ``gcge_tpu``'s phased loop: converged, iterations
    within one, eigenvalues 1e-10; the fused loop gives the phased loop's
    eigenvalues."""
    op, th, kw, x0, jres = amg_gcg
    params = GCGParams(**kw, linear_precond=tmg.bamg_preconditioner(th))
    res = gcg_solve(op, None, replace(params, fuse=fuse), x0=x0)
    assert res.nev_conv >= 5 and res.nev_conv == jres.nev_conv
    assert abs(res.num_iter - jres.num_iter) <= 1
    np.testing.assert_allclose(res.eval[:5], jres.eval[:5], rtol=1e-10)
    if fuse:
        phased = gcg_solve(op, None, params, x0=x0)
        assert res.num_iter == phased.num_iter
        np.testing.assert_array_equal(res.eval, phased.eval)


def test_mixed_stage_composes_the_preconditioner(amg_gcg):
    """The mixed inner CG's f32 stages take the V-cycle in both layouts
    (DIA: transposed; ELL: ``(n, m)``), against ``gcge_tpu``'s mixed branch
    with the same preconditioner: converged, iterations within one,
    eigenvalues 1e-10."""
    from gcge_tpu_torch import SparseOperator

    op, th, kw, x0, _ = amg_gcg
    n, rows, cols, vals = _amg_gcg_case()
    jh = jmg.build_hierarchy(rows, cols, vals, n, max_levels=4, min_coarse=50)
    mixed = dict(kw, cg_mixed=True, cg_refine=2, cg_auto_shift=True)
    jres = j_gcg_solve(j_make_operator(rows, cols, vals, (n, n)), None,
                       JParams(**mixed, linear_precond=jmg.bamg_preconditioner(
                           jh)), x0=jnp.asarray(x0))
    ell = SparseOperator.from_coo(rows, cols, vals, (n, n), device="cpu")
    for a_op in (op, ell):
        res = gcg_solve(a_op, None, GCGParams(
            **mixed, linear_precond=tmg.bamg_preconditioner(th)), x0=x0)
        assert res.nev_conv >= 5 and res.nev_conv == jres.nev_conv
        assert abs(res.num_iter - jres.num_iter) <= 1
        np.testing.assert_allclose(res.eval[:5], jres.eval[:5], rtol=1e-10)


def test_solve_multigrid_matches_jax():
    """``solve(multigrid=2)`` on the CPU against ``gcge_tpu.solve`` on the
    cube FEM pair at nx=8 (B projected onto A's pattern), and in RCM order:
    eigenvalues 1e-10, equal converged counts; the eigenvectors come back
    in the caller's order."""
    rows, cols, av, bv, n = cube_fem_laplacian(8)
    a = sps.coo_matrix((av, (rows, cols)), shape=(n, n)).tocsr()
    b = sps.coo_matrix((bv, (rows, cols)), shape=(n, n)).tocsr()
    x0 = np.random.default_rng(7).uniform(-1, 1, (n, 8))
    kw = dict(nev=4, block_size=2, max_iter=80, verbose=0)
    ej, _, cj = gcge_tpu.solve(a, b, multigrid=2, x0=x0, **kw)
    for rcm in (False, True):
        et, evec, ct = gcge_tpu_torch.solve(a, b, multigrid=2, x0=x0,
                                            device="cpu", rcm=rcm, **kw)
        assert ct == cj >= 4
        np.testing.assert_allclose(et[:4], np.asarray(ej)[:4], rtol=1e-10)
        x = evec[:, :4].numpy()
        r = a @ x - (b @ x) * et[None, :4]
        assert np.abs(r).max() <= 1e-7 * np.abs(et[:4]).max()
    with pytest.raises(ValueError, match="outside"):
        gcge_tpu_torch.solve(a, sps.identity(n, format="csr") + sps.csr_matrix(
            ([1.0], ([0], [n - 1])), shape=(n, n)), multigrid=2,
            device="cpu", **kw)
    with pytest.raises(ValueError, match="scipy sparse A"):
        gcge_tpu_torch.solve(a.toarray(), None, multigrid=2, device="cpu",
                             **kw)
