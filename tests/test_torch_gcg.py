"""The port's GCG slice (phased path) against gcge_tpu on the same inputs.

Both packages get the same full-width starting block from numpy, so no
random numbers are drawn on either side.  Eigenvalues must agree to 1e-10
relative and the converged counts must be equal.  The iteration counts may
differ by up to 2: the spectra have degenerate and near-degenerate clusters,
where the two ``eigh``s return different eigenbases, and the f32 stages of
the mixed inner CG sum in another order, so the iterates drift apart at
rounding level and the convergence test can fire one iteration earlier or
later.
"""

import os
import subprocess
import sys
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import gcge_tpu
from gcge_tpu.ops.operators import DenseOperator as JDense
from gcge_tpu.ops.operators import DiagOperator as JDiag
from gcge_tpu.ops.operators import SparseOperator as JSparse
from gcge_tpu.ops.operators import make_operator as j_make_operator
from gcge_tpu.solvers.gcg import GCGParams as JParams
from gcge_tpu.solvers.gcg import gcg_solve as j_gcg_solve
import gcge_tpu_torch
from gcge_tpu_torch import (DenseOperator, DiagOperator, GCGParams,
                            SparseOperator, gcg_solve, make_operator)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the headline solve's parameters, at a small size
HEADLINE = dict(nev=10, block_size=10, max_iter=120, cg_max_iter=30,
                cg_mixed=True, cg_refine=2, cg_auto_shift=True, fuse=0,
                verbose=0)


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


def _assert_parity(ev_t, conv_t, it_t, ev_j, conv_j, it_j, nev,
                   equal_conv=True):
    assert conv_t >= nev and conv_j >= nev
    if equal_conv:
        assert conv_t == conv_j
    ev_t, ev_j = np.asarray(ev_t)[:nev], np.asarray(ev_j)[:nev]
    assert np.max(np.abs(ev_t - ev_j) / np.abs(ev_j)) <= 1e-10
    if it_t is not None:
        assert abs(it_t - it_j) <= 2


@pytest.fixture(scope="module")
def stencil10():
    rows, cols, vals, n = stencil_27(10)
    x0 = np.random.default_rng(0).uniform(-1, 1, (n, 20))
    return rows, cols, vals, n, x0


def test_slice_gcg_solve_matches_jax(stencil10):
    """gcg_solve with the headline parameters (mixed inner CG, refine 2,
    auto shift, phased) on an nx=10 27-point stencil, nev=10."""
    rows, cols, vals, n, x0 = stencil10
    jr = j_gcg_solve(j_make_operator(rows, cols, vals, (n, n)), None,
                     JParams(**HEADLINE), x0=jnp.asarray(x0))
    tr = gcg_solve(make_operator(rows, cols, vals, (n, n), device="cpu"),
                   None, GCGParams(**HEADLINE), x0=x0)
    _assert_parity(tr.eval, tr.nev_conv, tr.num_iter,
                   jr.eval, jr.nev_conv, jr.num_iter, 10)
    # the Ritz vectors are eigenvectors to the solver's tolerance
    a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    x = tr.evec[:, :10].numpy()
    res = np.linalg.norm(a @ x - x * tr.eval[None, :10], axis=0)
    assert res.max() <= 1e-8 * np.abs(tr.eval[:10]).max() * 2


def test_slice_solve_matches_jax(stencil10):
    """The same through the one-call frontends, scipy matrix in."""
    rows, cols, vals, n, x0 = stencil10
    a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    kw = {k: v for k, v in HEADLINE.items() if k != "nev"}
    ev_j, _, conv_j = gcge_tpu.solve(a, None, nev=10, x0=jnp.asarray(x0),
                                     **kw)
    ev_t, evec_t, conv_t = gcge_tpu_torch.solve(a, None, nev=10,
                                                device="cpu", x0=x0, **kw)
    assert evec_t.device.type == "cpu" and evec_t.shape == (n, 20)
    _assert_parity(ev_t, conv_t, None, ev_j, conv_j, None, 10)


def test_generalized_cg_order2_restart_matches_jax():
    """A x = lambda B x with diagonal B, the plain f64 inner CG with
    cg_order=2, and restart growth (nev_init < nev_max)."""
    n = 400
    h = 1.0 / (n + 1)
    a = (np.diag(np.full(n, 2.0 / h)) - np.diag(np.full(n - 1, 1.0 / h), 1)
         - np.diag(np.full(n - 1, 1.0 / h), -1))
    rows, cols = np.nonzero(a)
    vals = a[rows, cols]
    d = np.random.default_rng(5).uniform(0.5, 1.5, n) * h
    # nev > 2*block_size: the first target is 8 pairs at size_x 12, then
    # the basis grows by the P and W widths
    kw = dict(nev=12, block_size=4, nev_max=24, nev_init=12, max_iter=200,
              cg_order=2, cg_max_iter=20, verbose=0)
    x0 = np.random.default_rng(6).uniform(-1, 1, (n, 12))
    jr = j_gcg_solve(j_make_operator(rows, cols, vals, (n, n)),
                     JDiag(jnp.asarray(d)), JParams(**kw), x0=jnp.asarray(x0))
    tr = gcg_solve(make_operator(rows, cols, vals, (n, n), device="cpu"),
                   DiagOperator(torch.as_tensor(d)), GCGParams(**kw), x0=x0)
    assert len(tr.eval) == len(jr.eval) > 12       # the basis grew
    _assert_parity(tr.eval, tr.nev_conv, tr.num_iter,
                   jr.eval, jr.nev_conv, jr.num_iter, 12)


@pytest.mark.parametrize("kind", ["ell", "dense"])
def test_mixed_inner_cg_on_other_operators_matches_jax(kind):
    """cg_mixed on an ELL operator (f32 CG stages in the (n, m) layout) and
    on a dense one (no f32 form: the plain f64 CG), generalized with a
    diagonal B.  Both must converge the wanted pairs; the converged counts
    may differ past ``nev``: the last convergence check can take in one more
    pair on one side, because the f32 stages sum in another order."""
    rows, cols, vals, n = stencil_27(7)
    # a random diagonal splits the stencil's degenerate clusters, so that
    # the converged count does not hinge on where a cluster is cut
    vals = vals + np.where(rows == cols, np.random.default_rng(6).uniform(
        0.0, 3.0, len(vals)), 0.0)
    d = np.random.default_rng(7).uniform(0.5, 1.5, n)
    kw = dict(nev=6, block_size=6, max_iter=100, cg_mixed=True,
              cg_auto_shift=True, verbose=0)
    x0 = np.random.default_rng(8).uniform(-1, 1, (n, 12))
    if kind == "ell":
        jop = JSparse.from_coo(rows, cols, vals, (n, n))
        top = SparseOperator.from_coo(rows, cols, vals, (n, n), device="cpu")
    else:
        a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).toarray()
        jop, top = JDense(jnp.asarray(a)), DenseOperator(torch.as_tensor(a))
    jr = j_gcg_solve(jop, JDiag(jnp.asarray(d)), JParams(**kw),
                     x0=jnp.asarray(x0))
    tr = gcg_solve(top, DiagOperator(torch.as_tensor(d)), GCGParams(**kw),
                   x0=x0)
    _assert_parity(tr.eval, tr.nev_conv, tr.num_iter,
                   jr.eval, jr.nev_conv, jr.num_iter, 6, equal_conv=False)


@pytest.mark.parametrize("nev,block_size,nev_max", [
    (30, 0, 0), (10, 3, 0), (10, 0, 25), (1, 0, 0)])
def test_resolved_matches_jax(nev, block_size, nev_max):
    kw = dict(nev=nev, block_size=block_size, nev_max=nev_max)
    t, j = GCGParams(**kw).resolved(1000), JParams(**kw).resolved(1000)
    for f in ("nev", "block_size", "nev_max", "nev_init", "multi_max"):
        assert getattr(t, f) == getattr(j, f)


def test_options_not_ported_raise(stencil10):
    """What is not ported raises before the solve starts, naming its ROADMAP
    item (checkpoint_path, profile_dir, mesh and distribute, the grid too,
    run since they were ported: tests/test_torch_utils.py,
    tests/test_torch_dist.py; rr_warm='struct' solves, and takes the
    structural warm start under rr_backend='newton':
    test_rr_warm_struct_matches_auto_and_jax; every backend of gcge_tpu
    runs: tests/test_torch_eighs.py); an unknown rr_warm or rr_backend
    raises ValueError; a distributed solve without a process group
    raises."""
    rows, cols, vals, n, _ = stencil10
    op = make_operator(rows, cols, vals, (n, n), device="cpu")
    res = gcg_solve(op, None, GCGParams(nev=4, rr_warm="struct", verbose=0))
    assert res.nev_conv >= 4
    with pytest.raises(ValueError, match="rr_warm"):
        gcg_solve(op, None, GCGParams(nev=4, rr_warm="newton"))
    with pytest.raises(ValueError, match="unknown eigh backend"):
        gcg_solve(op, None, GCGParams(nev=4, rr_backend="lapack"))
    with pytest.raises(TypeError, match="RowMesh"):
        gcg_solve(op, None, GCGParams(nev=4), mesh=object())
    # multigrid and method="pas" run since they were ported
    # (tests/test_torch_multigrid.py, tests/test_torch_pas.py)
    a = sps.identity(50, format="csr")
    # no process group: a distributed solve never runs undistributed
    with pytest.raises(RuntimeError, match="process group"):
        gcge_tpu_torch.solve(a, nev=2, device="cpu", distribute="grid")
    with pytest.raises(RuntimeError, match="process group"):
        gcge_tpu_torch.solve(a, nev=2, device="cpu", distribute=True)
    with pytest.raises(ValueError, match="unknown method"):
        gcge_tpu_torch.solve(a, nev=2, device="cpu", method="lobpcg")
    with pytest.raises(ValueError, match="exceeds"):
        GCGParams(nev=30).resolved(50)


def test_rr_warm_struct_matches_auto_and_jax(stencil10):
    """``rr_warm='struct'`` under ``rr_backend='newton'`` takes the
    structural warm start (gcge_tpu's ``_rr_struct_warm``) in the
    Rayleigh-Ritz steps whose X-W coupling is small, and matches gcge_tpu's
    ``'struct'`` solve with the same backend to the parity tolerances (the
    same converged count, eigenvalues 1e-10, iterations within 2: its
    ``'auto'`` solve takes 26 iterations in the port and 27 in gcge_tpu
    here), and the ``'off'`` solve's eigenvalues; off the Newton backend
    ``'struct'`` is ``'auto'``: the same bits."""
    from gcge_tpu_torch.solvers import gcg as t_gcg

    rows, cols, vals, n, x0 = stencil10
    op = make_operator(rows, cols, vals, (n, n), device="cpu")
    kw = dict(nev=6, block_size=3, verbose=0)
    auto, struct = (gcg_solve(op, None, GCGParams(rr_warm=warm, **kw),
                              x0=x0[:, :12]) for warm in ("auto", "struct"))
    np.testing.assert_array_equal(auto.eval, struct.eval)
    assert torch.equal(auto.evec, struct.evec)
    assert (auto.num_iter, auto.nev_conv) == (struct.num_iter,
                                              struct.nev_conv)
    taken = []
    warm = t_gcg._rr_struct_warm

    def counted(*args):
        out = warm(*args)
        taken.append(out[3])
        return out

    kw["rr_backend"] = "newton"
    t_gcg._rr_struct_warm = counted
    try:
        newton = gcg_solve(op, None, GCGParams(rr_warm="struct", **kw),
                           x0=x0[:, :12])
    finally:
        t_gcg._rr_struct_warm = warm
    # one Rayleigh-Ritz step an iteration, all but the first take the warm
    # start's path; its premise fails in the early, coupled ones
    assert len(taken) == newton.num_iter
    assert 0 < sum(taken) < len(taken)
    off = gcg_solve(op, None, GCGParams(rr_warm="off", **kw), x0=x0[:, :12])
    assert off.nev_conv == newton.nev_conv
    np.testing.assert_allclose(newton.eval[:6], off.eval[:6], rtol=1e-10)
    jr = j_gcg_solve(j_make_operator(rows, cols, vals, (n, n)), None,
                     JParams(rr_warm="struct", **kw),
                     x0=jnp.asarray(x0[:, :12]))
    _assert_parity(newton.eval, newton.nev_conv, newton.num_iter,
                   jr.eval, jr.nev_conv, jr.num_iter, 6)


@pytest.mark.parametrize("backend,warm", [("newton", "off"),
                                          ("jacobi", "auto")])
def test_gcg_backend_matches_jax(stencil10, backend, warm):
    """``gcg_solve`` at stencil10 scale (nev 6, block 3) with
    ``rr_backend=backend, rr_warm=warm`` against gcge_tpu's from the same
    starting block, to this file's parity rule (the same converged count,
    eigenvalues 1e-10, iterations within 2: the stencil's clusters of three
    give the two packages' eighs different bases; the 'auto' solve itself
    takes 26 iterations in the port and 27 in gcge_tpu here).  Neither runs
    the structural warm start (``'off'``, or off the Newton backend); the
    solve with it is :func:`test_rr_warm_struct_matches_auto_and_jax`."""
    from gcge_tpu_torch.solvers import gcg as t_gcg

    rows, cols, vals, n, x0 = stencil10
    kw = dict(nev=6, block_size=3, verbose=0, rr_backend=backend,
              rr_warm=warm)
    taken = []
    warm_start = t_gcg._rr_struct_warm
    t_gcg._rr_struct_warm = lambda *a: taken.append(a) or warm_start(*a)
    try:
        tr = gcg_solve(make_operator(rows, cols, vals, (n, n), device="cpu"),
                       None, GCGParams(**kw), x0=x0[:, :12])
    finally:
        t_gcg._rr_struct_warm = warm_start
    jr = j_gcg_solve(j_make_operator(rows, cols, vals, (n, n)), None,
                     JParams(**kw), x0=jnp.asarray(x0[:, :12]))
    _assert_parity(tr.eval, tr.nev_conv, tr.num_iter, jr.eval, jr.nev_conv,
                   jr.num_iter, 6)
    assert not taken


def test_newton_backend_at_the_f32_warm_width_follows_auto():
    """``rr_backend='newton'`` where the projected problem passes 768 rows
    (nev=400, m=960, where gcge_tpu's ``eigh_newton`` starts from the f32
    eigh and the port's from the f64 one) follows the ``'auto'`` solve from
    the same start: the same count after 7 iterations and the same lowest
    Ritz values to 1e-10.  From LAPACK's f32 eigenvectors the refinement
    repels at the third Rayleigh-Ritz step here: the eigenvalues kept an
    error of 1e-6 and no pair converged."""
    from gcge_tpu_torch.io.stencil import build_3d27
    from gcge_tpu_torch.utils import sweep

    rows, cols, vals, n = build_3d27(12)
    op = make_operator(rows, cols, vals, (n, n), device="cpu")
    base = replace(sweep.production_params(400, op), fuse=0, max_iter=7,
                   verbose=0)
    x0 = np.random.default_rng(2).uniform(-1, 1, (n, 800))
    auto, newton = (gcg_solve(op, None, replace(base, rr_backend=backend),
                              x0=x0) for backend in ("auto", "newton"))
    assert newton.nev_conv == auto.nev_conv > 0
    np.testing.assert_allclose(newton.eval[:40], auto.eval[:40], rtol=1e-10)


def test_eigsh_cpu():
    """scipy-style frontend on a 1-D Laplacian with a known spectrum."""
    n = 200
    a = sps.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                  [-1, 0, 1], format="csr")
    w, v = gcge_tpu_torch.eigsh(a, k=4, device="cpu", block_size=4,
                                verbose=0)
    exact = 2 - 2 * np.cos(np.arange(1, 5) * np.pi / (n + 1))
    assert np.max(np.abs(w - exact) / exact) <= 1e-10
    assert v.shape == (n, 4)
    with pytest.raises(ValueError):
        gcge_tpu_torch.eigsh(a, k=4, which="LM", device="cpu")


def test_port_never_imports_jax():
    """With ``jax`` unimportable, the port imports (the command-line
    driver and the sweep too) and runs a tiny CPU solve; no module of
    gcge_tpu or jax is loaded."""
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "import numpy as np, scipy.sparse as sps",
        "import gcge_tpu_torch",
        "from gcge_tpu_torch.utils.convert import operator_from_numpy",
        "from gcge_tpu_torch.utils import cli, sweep",
        "n = 60",
        "a = sps.diags([-np.ones(n-1), 2*np.ones(n), -np.ones(n-1)],"
        " [-1, 0, 1], format='csr')",
        "ev, _, conv = gcge_tpu_torch.solve(a, nev=3, device='cpu',"
        " block_size=3, verbose=0)",
        "assert conv >= 3, conv",
        "bad = [m for m, mod in sys.modules.items() if mod is not None"
        " and m.split('.')[0] in ('jax', 'jaxlib', 'gcge_tpu')]",
        "assert not bad, bad",
        "print('ok')",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_params_take_every_field_of_gcge_tpu():
    """Every field of ``gcge_tpu.GCGParams`` exists in the port's, with the
    same default (``dtype`` apart: a torch dtype against a jnp one)."""
    import dataclasses

    ours = {f.name: f.default for f in dataclasses.fields(GCGParams)}
    theirs = {f.name: f.default for f in dataclasses.fields(JParams)}
    assert set(theirs) <= set(ours), set(theirs) - set(ours)
    for name, default in theirs.items():
        if name != "dtype":
            assert ours[name] == default, name


def _laplacian_solve(**kw):
    n = 60
    a = sps.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                  [-1, 0, 1], format="csr")
    op = make_operator(*(lambda c: (c.row, c.col, c.data))(a.tocoo()),
                       (n, n), device="cpu")
    return gcg_solve(op, None, GCGParams(nev=3, block_size=3, max_iter=60,
                                         verbose=0, **kw))


# field: (values that run, (value, exception, message) that raise); the
# values that run change nothing: gcge_tpu gives them this meaning off the TPU
_FIELDS = {
    "linear_solver": ([None], []),
    "linear_precond": ([None], []),
    # without checkpoint_path, checkpoint_every writes nothing (gcge_tpu's
    # rule); tests/test_torch_utils.py runs it with a path
    "checkpoint_every": ([0, 5], []),
    "rr_warm": (["auto", "struct", "off"], [("warm", ValueError, "rr_warm")]),
    # 'jacobi', 'newton' and 'host' run too, to the default's values (the
    # test below); an unknown backend raises
    "rr_backend": (["auto", "device"], [("lapack", ValueError, "unknown")]),
    "fuse_hotswap": (["auto", "on", "off"], [("yes", ValueError,
                                              "fuse_hotswap")]),
    "orth_proj_precision": (["auto", "f64"],
                            [("osgemm", ValueError, "Ozaki"),
                             ("mixed", ValueError, "Ozaki"),
                             ("f32", ValueError, "unknown")]),
    "rr_gemm_precision": (["auto", "f64"],
                          [("osgemm", ValueError, "Ozaki"),
                           ("bf16", ValueError, "unknown")]),
}


def _user_solver(block_pcg, params_cls, **cg):
    """The user inner solver of ``tests/test_gcg.py``: a block CG of its
    own budget, from either package."""
    def solver(matvec, rhs, x0, active):
        x, _ = block_pcg(matvec, rhs, x0, params_cls(**cg), active0=active)
        return x
    return solver


def _matched_values(name):
    """The values of ``linear_solver``/``linear_precond`` that change the
    solve, for the port and for ``gcge_tpu``: a user block CG (budget 40,
    rate 1e-3) and a diagonal preconditioner."""
    from gcge_tpu.solvers.bpcg import BlockPCGParams as JCG
    from gcge_tpu.solvers.bpcg import block_pcg as j_block_pcg
    from gcge_tpu_torch.solvers.bpcg import BlockPCGParams, block_pcg

    if name == "linear_solver":
        cg = dict(max_iter=40, rate=1e-3, tol=1e-14)
        return (_user_solver(block_pcg, BlockPCGParams, **cg),
                _user_solver(j_block_pcg, JCG, **cg))
    # a diagonal preconditioner that is not a multiple of the identity (a
    # multiple would leave the CG's iterates as they are)
    d = 0.5 + 0.25 * np.cos(np.arange(60))
    return (lambda r: torch.as_tensor(d)[:, None] * r,
            lambda r: jnp.asarray(d)[:, None] * r)


@pytest.mark.parametrize("name", list(_FIELDS))
def test_params_field_runs_or_raises(name):
    """Each of the eight fields the port took from ``gcge_tpu.GCGParams``:
    the accepted values construct and solve a small problem with the
    default's bits, on both loops; the others raise, a value for the TPU
    only saying so, before the solve starts.  ``linear_solver``
    and ``linear_precond`` (ported since) also run with a value that
    changes the solve, and match ``gcge_tpu`` on the same starting block:
    iterations within one, eigenvalues 1e-10, the fused loop the phased
    loop's eigenvalues.  ``rr_backend``'s other eighs (ported since:
    ``'jacobi'``, ``'newton'``, ``'host'``; ``tests/test_torch_eighs.py``
    holds them to gcge_tpu) give the default's iterations, count and
    converged eigenvalues to 1e-10, on both loops."""
    runs, raises = _FIELDS[name]
    if name == "rr_backend":
        for value in ("jacobi", "newton", "host"):
            for fuse in (0, 2):
                ref = _laplacian_solve(fuse=fuse)
                got = _laplacian_solve(rr_backend=value, fuse=fuse)
                assert (got.num_iter, got.nev_conv) == (ref.num_iter,
                                                        ref.nev_conv)
                np.testing.assert_allclose(got.eval[:3], ref.eval[:3],
                                           rtol=1e-10)
    if name in ("linear_solver", "linear_precond"):
        ours, theirs = _matched_values(name)
        n = 60
        a = sps.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                      [-1, 0, 1], format="csr").tocoo()
        x0 = np.random.default_rng(3).uniform(-1, 1, (n, 6))
        kw = dict(nev=3, block_size=3, max_iter=60, verbose=0)
        jr = j_gcg_solve(j_make_operator(a.row, a.col, a.data, (n, n)), None,
                         JParams(**kw, **{name: theirs}), x0=jnp.asarray(x0))
        op = make_operator(a.row, a.col, a.data, (n, n), device="cpu")
        phased = gcg_solve(op, None, GCGParams(**kw, **{name: ours}), x0=x0)
        fused = gcg_solve(op, None, GCGParams(**kw, **{name: ours}, fuse=2),
                          x0=x0)
        assert abs(phased.num_iter - jr.num_iter) <= 1
        _assert_parity(phased.eval, phased.nev_conv, None, jr.eval,
                       jr.nev_conv, None, 3)
        assert fused.num_iter == phased.num_iter
        np.testing.assert_array_equal(fused.eval, phased.eval)
    base = _laplacian_solve()
    assert base.nev_conv >= 3
    for value in runs:
        for fuse in (0, 2):
            got = _laplacian_solve(**{name: value}, fuse=fuse)
            ref = base if fuse == 0 else _laplacian_solve(fuse=fuse)
            assert got.nev_conv == ref.nev_conv
            np.testing.assert_array_equal(got.eval, ref.eval)
    for value, exc, match in raises:
        with pytest.raises(exc, match=match):
            _laplacian_solve(**{name: value})
        with pytest.raises(exc, match=match):
            gcge_tpu_torch.solve(sps.identity(40, format="csr"), nev=2,
                                 device="cpu", verbose=0, **{name: value})


@pytest.mark.parametrize("method", ["evp", "bgs", "mgs"])
def test_orth_method_variants_match_jax(method):
    """GCG with each in-block orthonormalization (``tests/test_gcg.py``'s
    orth-method case, n=600, nev=5, block 3) against ``gcge_tpu`` from the
    same starting block: converged, iterations within 2, eigenvalues 1e-10
    of its and 1e-8 of the closed form; the fused loop the phased loop's
    eigenvalues."""
    n = 600
    a = sps.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                  [-1, 0, 1], format="csr").tocoo() * (n + 1)
    x0 = np.random.default_rng(4).uniform(-1, 1, (n, 10))
    kw = dict(nev=5, block_size=3, verbose=0, orth_method=method)
    jr = j_gcg_solve(j_make_operator(a.row, a.col, a.data, (n, n)), None,
                     JParams(**kw), x0=jnp.asarray(x0))
    op = make_operator(a.row, a.col, a.data, (n, n), device="cpu")
    tr = gcg_solve(op, None, GCGParams(**kw), x0=x0)
    _assert_parity(tr.eval, tr.nev_conv, tr.num_iter, jr.eval, jr.nev_conv,
                   jr.num_iter, 5, equal_conv=False)
    exact = (n + 1) * (2 - 2 * np.cos(np.arange(1, 6) * np.pi / (n + 1)))
    np.testing.assert_allclose(tr.eval[:5], exact, rtol=1e-8)
    fused = gcg_solve(op, None, GCGParams(**kw, fuse=4), x0=x0)
    assert fused.num_iter == tr.num_iter
    np.testing.assert_array_equal(fused.eval, tr.eval)
