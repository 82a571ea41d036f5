"""The port's distribution, the row mesh and the 2-D grid, against
gcge_tpu's, on the CPU.

The port runs one process a rank on ``torch.distributed`` (gloo here, NCCL
on cards); ``gcge_tpu`` runs one process over its 8-device virtual CPU mesh.
The ranks (``tests/torch_dist_worker.py``: four, and two for the one-call
frontend and the per-rank ingestion) are started once for the module, in
spawned interpreters that never import ``jax``, and run every check while
this process computes ``gcge_tpu``'s results on ``row_mesh(4)`` from the
same numpy inputs (its ``grid_mesh(2, 2)`` references in a child
interpreter of their own, at the same time).  Each rank has a hard time
limit: a rank that waits in a collective fails the checks it did not finish
instead of hanging the suite.

Tolerances: the stitched sharded products equal ``gcge_tpu``'s to 1e-13 of
their largest entry (the same sums in another order); the solves, as in
``tests/test_torch_gcg.py``, have eigenvalues within 1e-10 relative, the
same converged count and iteration counts within 2; PAS, as in
``tests/test_torch_pas.py``, eigenvalues within 1e-9 relative, the same
converged count and the same sweeps by level; the f32 products of the
windowed path, and a solve on a one-rank mesh, equal the undistributed
port's bit for bit (the same operations on the same values).  The
replicated coarse levels of a sharded AMG hierarchy give every rank the
same bits.  On the (2, 2) grid every rank holds the same eigenvalues,
counts and gathered eigenvectors, bit for bit; a (4, 1) grid gives the row
mesh's bits, and ``pcg(mesh=)`` is within 1e-13 of the undistributed
``pcg``.  The partitioned ``eigh_newton`` (4-rank row mesh, (2, 2) grid, 2
ranks) has eigenvalues within 1e-12 of gcge_tpu's sharded one and of the
port's without a mesh, spans within 1e-10, the same bits on every rank;
on one rank the bits of ``mesh=None``.
"""

import os
import pickle
import subprocess
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import gcge_tpu
import torch_dist_worker as w
from gcge_tpu.ops.operators import DenseOperator as JDense
from gcge_tpu.ops.operators import DiagOperator as JDiag
from gcge_tpu.ops.operators import DiaOperator as JDia
from gcge_tpu.ops.operators import HybridOperator as JHybrid
from gcge_tpu.ops.operators import SparseOperator as JSparse
from gcge_tpu.ops.spmm_pallas import (_window_matvec_t, dia_spmm_pallas_t,
                                      dia_spmm_pallas_t_df64, split_df32)
from gcge_tpu.parallel import pad_problem as j_pad_problem
from gcge_tpu.parallel import row_mesh as j_row_mesh
from gcge_tpu.parallel import shard_operator as j_shard_operator
from gcge_tpu.parallel import shard_hierarchy as j_shard_hierarchy
from gcge_tpu.parallel import shard_rows as j_shard_rows
from gcge_tpu.solvers import multigrid as jmg
from gcge_tpu.solvers import pas as jpas
from gcge_tpu.solvers.gcg import GCGParams as JParams
from gcge_tpu.solvers.gcg import gcg_solve as j_gcg_solve
import gcge_tpu_torch
from gcge_tpu_torch import (CsrOperator, DiagOperator, DiaOperator,
                            HybridOperator)
from gcge_tpu_torch.ops import spmm
from gcge_tpu_torch.parallel import (check_host_major, grid_mesh,
                                     hybrid_row_mesh, pad_problem, row_mesh)
from gcge_tpu_torch.solvers.gcg import _f32_apply

torch.set_num_threads(2)

# seconds the ranks of one group may take in all (about 30 s alone)
RANK_LIMIT = 420


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_grid_child):
    """Both rank groups, started at once (after the child of
    :func:`jax_grid_child`); joined by :func:`joined`."""
    out = str(tmp_path_factory.mktemp("ranks"))
    procs = {group: w.launch(group, out) for group in w.WORLD}
    yield out, procs
    for group_procs in procs.values():
        w.finish(group_procs, 0)


def joined(ranks, group):
    out, procs = ranks
    codes = w.finish(procs[group], RANK_LIMIT)
    return out, codes


def _stitch(parts, n):
    return np.concatenate(parts)[:n]


def _pad_rows(x, n_pad):
    return np.concatenate([x, np.zeros((n_pad - x.shape[0],) + x.shape[1:])])


# ---------------------------------------------------------------------------
# the halo window of kernels 1 and 2: the plain version against gcge_tpu's
# ---------------------------------------------------------------------------

HALO_OFFSETS = (-5, -1, 0, 2, 7)


def _halo_case(dtype, halo, n=300, m=6):
    rng = np.random.default_rng(21)
    hl, hr = halo
    values = rng.standard_normal((len(HALO_OFFSETS), n)).astype(dtype)
    xt = rng.standard_normal((m, n + hl + hr)).astype(dtype)
    return values, xt


def _port_halo(values, xt, halo):
    offs = torch.tensor(HALO_OFFSETS, dtype=torch.int32)
    return spmm.dia_spmm_reference(torch.as_tensor(values), offs,
                                   torch.as_tensor(xt), True, halo).numpy()


@pytest.mark.parametrize("halo", [(5, 7), (9, 12)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dia_halo_reference_matches_window_matvec(ranks, dtype, halo):
    """``dia_spmm_reference(halo=)`` against ``_window_matvec_t``, the XLA
    form of the windowed product; the wrapper on a CPU tensor is the plain
    version, in both layouts."""
    values, xt = _halo_case(dtype, halo)
    ref = np.asarray(_window_matvec_t(jnp.asarray(values), HALO_OFFSETS,
                                      jnp.asarray(xt), halo[0]))
    got = _port_halo(values, xt, halo)
    tol = 1e-13 if dtype == np.float64 else 1e-5
    assert got.shape == (6, 300)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
    offs = torch.tensor(HALO_OFFSETS, dtype=torch.int32)
    wrapped = spmm.dia_spmm(torch.as_tensor(values), offs,
                            torch.as_tensor(xt).T.contiguous(), False, halo)
    assert np.array_equal(wrapped.numpy().T, got)


@pytest.mark.parametrize("kernel", ["f32", "df64"])
def test_dia_halo_reference_matches_pallas_interpret(kernel):
    """The same against the TPU kernels themselves, ``dia_spmm_pallas_t``
    (f32) and ``dia_spmm_pallas_t_df64`` (f64 from hi/lo planes), in
    interpret mode."""
    halo = (5, 7)
    dtype = np.float32 if kernel == "f32" else np.float64
    values, xt = _halo_case(dtype, halo)
    if kernel == "f32":
        ref = dia_spmm_pallas_t(jnp.asarray(values), HALO_OFFSETS,
                                jnp.asarray(xt), tn=512, interpret=True,
                                halo=halo)
        tol = 1e-5
    else:
        vhi, vlo = split_df32(jnp.asarray(values))
        ref = dia_spmm_pallas_t_df64(vhi, vlo, HALO_OFFSETS, jnp.asarray(xt),
                                     tn=512, interpret=True, halo=halo)
        tol = 1e-13
    ref = np.asarray(ref)
    got = _port_halo(values, xt, halo)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


# ---------------------------------------------------------------------------
# pad_problem, and what raises
# ---------------------------------------------------------------------------


def test_pad_problem_matches_jax():
    """The padded DIA, CSR, Hybrid and Diag operators equal gcge_tpu's
    padding of the same matrices (its ELL stands for the CSR)."""
    rows, cols, vals = w.banded(61, (1, 5), 2)
    d = np.random.default_rng(1).uniform(1, 2, 61)
    hyb = w.hybrid_coo(62)
    cases = [
        (DiaOperator.from_coo(rows, cols, vals, (61, 61), device="cpu"),
         JDia.from_coo(rows, cols, vals, (61, 61))),
        (CsrOperator.from_coo(rows, cols, vals, (61, 61), device="cpu"),
         JSparse.from_coo(rows, cols, vals, (61, 61))),
        (HybridOperator.from_coo(*hyb, (62, 62), device="cpu", max_diags=3),
         JHybrid.from_coo(*hyb, (62, 62), max_diags=3)),
    ]
    for t_op, j_op in cases:
        b_t = DiagOperator(torch.as_tensor(d[:t_op.shape[0]]))
        b_j = JDiag(jnp.asarray(d[:t_op.shape[0]]))
        ta, tb, tn = pad_problem(t_op, b_t, 4)
        ja, jb, jn = j_pad_problem(j_op, b_j, 4)
        assert tn == jn and ta.shape == ja.shape and ta.shape[0] % 4 == 0
        eye = np.eye(ta.shape[0])
        np.testing.assert_array_equal(ta.matvec(torch.as_tensor(eye)).numpy(),
                                      np.asarray(ja.matvec(jnp.asarray(eye))))
        np.testing.assert_array_equal(tb.d.numpy(), np.asarray(jb.d))


def test_distribution_needs_a_process_group():
    """No initialized group: ``row_mesh``, ``hybrid_row_mesh``,
    ``grid_mesh`` and ``solve(distribute=True)`` and ``"grid"``, with
    ``multigrid`` and ``method="pas"`` too, raise (nothing runs
    undistributed in silence)."""
    a = sps.identity(40, format="csr")
    for fn in (row_mesh, hybrid_row_mesh, lambda: grid_mesh(2, 2)):
        with pytest.raises(RuntimeError, match="process group"):
            fn()
    for kw in (dict(), dict(multigrid=3), dict(method="pas")):
        with pytest.raises(RuntimeError, match="process group"):
            gcge_tpu_torch.solve(a, nev=2, device="cpu", distribute=True,
                                 **kw)
    with pytest.raises(RuntimeError, match="process group"):
        gcge_tpu_torch.solve(a, nev=2, device="cpu", distribute="grid")


# ---------------------------------------------------------------------------
# the sharded operators over four ranks against gcge_tpu's RowShardedOperator
# ---------------------------------------------------------------------------


def _jax_operator(name, rows, cols, vals, n):
    if name.startswith("dia"):
        return JDia.from_coo(rows, cols, vals, (n, n))
    if name == "hybrid":
        return JHybrid.from_coo(rows, cols, vals, (n, n), max_diags=3)
    return JSparse.from_coo(rows, cols, vals, (n, n))


@pytest.fixture(scope="module")
def jax_matvecs():
    """gcge_tpu's sharded products on row_mesh(4), by case."""
    mesh = j_row_mesh(4)
    out = {}
    cases = {name: (build(), n, m) for name, (build, n, m)
             in w.MATVECS.items()}
    cases["dense"] = (None, 64, 3)
    cases["diag"] = (None, 64, 3)
    for name, (coo, n, m) in cases.items():
        if name == "dense":
            op = JDense(jnp.asarray(w.dense_sym()))
        elif name == "diag":
            op = JDiag(jnp.asarray(np.random.default_rng(5).uniform(1, 2, 64)))
        else:
            op = _jax_operator(name, *coo, n)
        op_pad, _, _ = j_pad_problem(op, None, 4)
        x = _pad_rows(w.block(n, m, 7), op_pad.shape[0])
        y = j_shard_operator(op_pad, mesh).matvec(
            j_shard_rows(mesh, jnp.asarray(x)))
        out[name] = np.asarray(y)[:n]
    return out


def _jax_solve(name):
    matrix, _, kw, k = w.SOLVES[name]
    rows, cols, vals, n, b = w.solve_problem(matrix)
    a = JSparse.from_coo(rows, cols, vals, (n, n)) if matrix == "delaunay" \
        else JDia.from_coo(rows, cols, vals, (n, n))
    b_op = None if b is None else JDiag(jnp.asarray(b))
    params = JParams(verbose=0, **dict(kw, fuse=0))
    if matrix == "delaunay" and kw.get("cg_mixed"):
        # gcge_tpu's sharded ELL operator has no f32 product under a mesh
        return j_gcg_solve(a, b_op, params, x0=jnp.asarray(w.x0_for(n, k)))
    a_pad, b_pad, _ = j_pad_problem(a, b_op, 4)
    mesh = j_row_mesh(4)
    x0 = _pad_rows(w.x0_for(n, k), a_pad.shape[0])
    # gcge_tpu's phased loop is the reference of both loops of the port
    return j_gcg_solve(j_shard_operator(a_pad, mesh),
                       j_shard_operator(b_pad, mesh), params,
                       x0=jnp.asarray(x0), mesh=mesh)


@pytest.fixture(scope="module")
def jax_solves():
    """gcge_tpu's distributed solve of each case on row_mesh(4), one a
    problem and inner solver (a fused case shares its phased case's)."""
    refs, out = {}, {}
    for name in w.SOLVES:
        key = name.rsplit("_", 1)[0]      # the case without its loop
        if key not in refs:
            refs[key] = _jax_solve(name)
        out[name] = refs[key]
    return out


def _jax_pas(run, composite=False):
    """``run()``, a call of gcge_tpu that reaches its ``pas_solve``: its
    return value, the ``PASResult`` and the sweeps by level (finest last).
    gcge_tpu's result does not count its sweeps, so the function that runs
    them is wrapped for the call: the fused loop of a level (its third
    output is the count) or, for the composite Rayleigh-Ritz, which it runs
    sweep by sweep, the sweep."""
    counts, results = [], []
    name = "_pas_sweep" if composite else "_pas_sweeps_fused"
    sweep, pas_solve = getattr(jpas, name), jpas.pas_solve

    def counted(*args, **kwargs):
        out = sweep(*args, **kwargs)
        n = args[1].shape[0]
        if not composite:
            counts.append([n, int(out[2])])
        elif counts and counts[-1][0] == n:
            counts[-1][1] += 1
        else:
            counts.append([n, 1])
        return out

    def recorded(*args, **kwargs):
        results.append(pas_solve(*args, **kwargs))
        return results[-1]

    setattr(jpas, name, counted)
    jpas.pas_solve = recorded
    try:
        out = run()
    finally:
        setattr(jpas, name, sweep)
        jpas.pas_solve = pas_solve
    return out, results[0], [c for _, c in counts]


@pytest.fixture(scope="module")
def jax_mg():
    """gcge_tpu's distributed multilevel results on the 1-D Laplacian of
    ``tests/test_dist.py``: on row_mesh(4) the transfers' products,
    bamg_solve's cycles, GCG with the V-cycle preconditioner and the
    composite PAS; the plain PAS through ``gcge_tpu.solve(distribute=True,
    method="pas")`` on its 8 devices, the same ``pas_solve`` call on the
    same hierarchy, which is also the reference of the two-rank
    ``lap_pas`` case."""
    mesh = j_row_mesh(4)
    n = w.MG_N
    rows, cols, vals = w.lap_coo(n)
    hier = jmg.build_hierarchy(rows, cols, vals, n, max_levels=w.MG_LEVELS)
    hd = j_shard_hierarchy(hier, mesh)
    lv0 = hd.levels[0]
    n_c = hier.levels[1].a_op.shape[0]
    a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    b = a @ w.block(n, 4, 42)
    out = {
        "prolong": np.asarray(lv0.p_op.matvec(jnp.asarray(w.block(n_c, 3,
                                                                  8)))),
        "restrict": np.asarray(lv0.r_op.matvec(j_shard_rows(
            mesh, jnp.asarray(w.block(n, 3, 9))))),
        "cg_cycles": jmg.bamg_solve(hd, j_shard_rows(mesh, jnp.asarray(b)),
                                    max_cycles=25, rtol=1e-10)[1],
        "x_true": w.block(n, 4, 42),
    }
    params = JParams(verbose=0, linear_precond=jmg.bamg_preconditioner(hd),
                     **w.MG_GCG)
    out["gcg"] = j_gcg_solve(
        j_shard_operator(JDia.from_coo(rows, cols, vals, (n, n)), mesh),
        None, params, x0=jnp.asarray(w.x0_for(n, w.MG_GCG_X0)), mesh=mesh)
    out["lap_pas"], *out["plain"] = _jax_pas(lambda: gcge_tpu.solve(
        a, None, distribute=True, verbose=0, **w.API_MG["lap_pas"][1]))
    _, *out["composite"] = _jax_pas(lambda: jpas.pas_solve(
        hd, w.PAS_NEV, verbose=0, **w.PAS_CASES["composite"]),
        composite=True)
    return out


def _jax_grid_refs(path):
    """gcge_tpu on ``grid_mesh(2, 2)`` (``tests/test_dist.py``'s grid
    cases): the sharded DIA and ELL products of ``block(512, 6, 7)`` and
    GCG on the sharded ELL operator (its phased loop, the reference of both
    loops of the port); ``gcge_tpu.solve(distribute="grid")`` of the cube
    FEM pair's plain case on its 8 devices, a (4, 2) grid; and
    :func:`_jax_newton_refs`.  Pickled to ``path`` as numpy values."""
    from gcge_tpu.parallel import grid_mesh as j_grid_mesh
    from gcge_tpu.parallel import shard_mv as j_shard_mv

    mesh = j_grid_mesh(2, 2)
    n = w.GRID_N
    rows, cols, vals, _ = w.laplacian_1d(n)
    x = j_shard_mv(mesh, jnp.asarray(w.block(n, w.GRID_M, 7)))
    out = {}
    for kind, cls in (("dia", JDia), ("csr", JSparse)):
        op = j_shard_operator(cls.from_coo(rows, cols, vals, (n, n)), mesh)
        out[kind] = np.asarray(op.matvec(x))
    ell = j_shard_operator(JSparse.from_coo(rows, cols, vals, (n, n)), mesh)
    res = j_gcg_solve(ell, None, JParams(verbose=0, fuse=0, **w.GRID_GCG),
                      x0=jnp.asarray(w.x0_for(n, w.GRID_X0)), mesh=mesh)
    out["gcg"] = SimpleNamespace(eval=np.asarray(res.eval),
                                 nev_conv=int(res.nev_conv),
                                 num_iter=int(res.num_iter))
    a, b = w.api_matrices("fem9")
    kw, k = w.API_GRID["fem_plain"]
    ev, _, conv = gcge_tpu.solve(a, b, distribute="grid", verbose=0,
                                 x0=jnp.asarray(w.x0_for(a.shape[0], k)),
                                 **kw)
    out["fem_plain"] = (np.asarray(ev), None, int(conv))
    out["newton"] = _jax_newton_refs()
    with open(path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def jax_grid_child(tmp_path_factory):
    """An interpreter of its own (this module's test set-up, ``conftest``)
    that computes :func:`_jax_grid_refs` while this process computes
    gcge_tpu's other references: started before the ranks."""
    path = str(tmp_path_factory.mktemp("jax_grid") / "refs.pkl")
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path[:0] = [{here!r}, {os.path.dirname(here)!r}]"
            f"; import conftest, test_torch_dist; "
            f"test_torch_dist._jax_grid_refs({path!r})")
    with open(path + ".log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", code], stdout=log,
                                stderr=subprocess.STDOUT)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_grid(jax_grid_child):
    """The child's references (:func:`_jax_grid_refs`)."""
    proc, path = jax_grid_child
    if proc.wait(timeout=RANK_LIMIT) != 0:
        with open(path + ".log") as log:
            raise AssertionError(f"gcge_tpu's grid references failed:\n"
                                 f"{log.read()[-4000:]}")
    with open(path, "rb") as f:
        return pickle.load(f)


def _jax_newton_refs():
    """gcge_tpu's sharded ``eigh_newton`` of each case of ``NEWTON_CASES``
    on row_mesh(4) (``tests/test_dist.py``'s call, the same warm start):
    its eigenvalues; and its distributed GCG with the 'newton'
    Rayleigh-Ritz of each case of ``NEWTON_SOLVES`` on row_mesh(4) (its
    phased loop, the reference of both loops)."""
    from gcge_tpu.ops.eighs import eigh_newton as j_eigh_newton

    mesh = j_row_mesh(4)
    out = {}
    for name, (m, nblk) in w.NEWTON_CASES.items():
        h, w0, u0 = w.newton_case(m)
        wj, _ = j_eigh_newton(jnp.asarray(h), nblk=nblk, mesh=mesh,
                              warm=(jnp.asarray(w0), jnp.asarray(u0)))
        out[name] = np.asarray(wj)
    rows, cols, vals, _ = w.laplacian_1d(w.GRID_N)
    op = j_shard_operator(JDia.from_coo(rows, cols, vals,
                                        (w.GRID_N, w.GRID_N)), mesh)
    for name, (warm, _) in w.NEWTON_SOLVES.items():
        res = j_gcg_solve(op, None, JParams(verbose=0, rr_warm=warm, fuse=0,
                                            **w.NEWTON_GCG),
                          x0=jnp.asarray(w.x0_for(w.GRID_N,
                                                  w.NEWTON_GCG_X0)),
                          mesh=mesh)
        out[name] = SimpleNamespace(eval=np.asarray(res.eval),
                                    nev_conv=int(res.nev_conv),
                                    num_iter=int(res.num_iter))
    return out


@pytest.fixture(scope="module")
def jax_newton(jax_grid):
    """The child's gcge_tpu references of the partitioned eigh and the
    'newton' GCG (:func:`_jax_newton_refs`), and the port's
    ``eigh_newton`` of each case of ``NEWTON_CASES`` without a mesh."""
    out = dict(jax_grid["newton"])
    for name, (m, nblk) in w.NEWTON_CASES.items():
        out[name] = {"jax": out[name], "port": w.newton_eigh(None, m, nblk)}
    return out


@pytest.fixture(scope="module")
def four(ranks, jax_matvecs, jax_solves, jax_mg, jax_grid, jax_api,
         jax_newton):
    """The four-rank group's results (joined after gcge_tpu's products and
    solves, all of which this process computes while the ranks run)."""
    return joined(ranks, "four")


@pytest.mark.parametrize("name", ["dia_halo", "dia_gather", "csr", "hybrid",
                                  "dense", "diag"])
def test_sharded_matvec_matches_jax(jax_matvecs, four, name):
    out, _ = four
    parts = w.result(out, "four", "matvecs")
    ref = jax_matvecs[name]
    got = _stitch([p[name] for p in parts], ref.shape[0])
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()
    if name in w.MATVECS:
        kind, gather, hl, hr = parts[0][name + "_path"]
        assert kind == name.split("_")[0]
        # the halo exchange where the band fits a rank's block, else the
        # all_gather window (gcge_tpu's halo_ok)
        assert gather == (name == "dia_gather")
    if name == "diag":
        assert parts[0]["diag_type"] == "DiagOperator"


@pytest.mark.parametrize("name", ["dia_halo", "dia_gather", "csr"])
def test_sharded_f32_transposed_matches_port_bits(four, name):
    """The f32 product of the mixed inner CG, ``(m, ln)`` in the ``(ln, m)``
    memory order, through the window: the undistributed port's bits."""
    out, _ = four
    parts = w.result(out, "four", "matvecs")
    build, n, m = w.MATVECS[name]
    rows, cols, vals = build()
    op = w._port_operator(name.split("_")[0], rows, cols, vals, n)
    apply32, transposed = _f32_apply(op)
    assert transposed
    x = torch.as_tensor(w.block(n, m, 7))
    ref = apply32(x.T.float()).T.numpy()
    got = _stitch([p[name + "_t32"] for p in parts], n)
    assert np.array_equal(got, ref)
    assert parts[0][name + "_t32_strides"] == (1, m)


# ---------------------------------------------------------------------------
# distributed GCG over four ranks against gcge_tpu's distributed GCG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(w.SOLVES))
def test_distributed_gcg_matches_jax(jax_solves, four, name):
    out, _ = four
    ranks_res = w.result(out, "four", "solves")
    nev = w.SOLVES[name][2]["nev"]
    res = ranks_res[0][name]
    # every rank holds the same projected problem, hence the same answer
    for other in ranks_res[1:]:
        assert np.array_equal(other[name]["eval"], res["eval"])
        assert other[name]["num_iter"] == res["num_iter"]
    jr = jax_solves[name]
    assert res["nev_conv"] >= nev and res["nev_conv"] == jr.nev_conv
    ev_t, ev_j = res["eval"][:nev], np.asarray(jr.eval)[:nev]
    assert np.max(np.abs(ev_t - ev_j) / np.abs(ev_j)) <= 1e-10
    assert abs(res["num_iter"] - jr.num_iter) <= 2
    # each rank holds its rows of the Ritz vectors
    n_pad = -(-w.solve_problem(w.SOLVES[name][0])[3] // 4) * 4
    assert res["evec_rows"] == n_pad // 4


@pytest.mark.parametrize("name", ["dia_std_mixed_fused",
                                  "csr_std_mixed_phased", "eigh_newton",
                                  "gcg_newton"])
def test_one_rank_mesh_equals_no_mesh_bit_for_bit(four, name):
    """A mesh of one rank (a subgroup of rank 0) gives the solve without a
    mesh bit for bit: eigenvalues, eigenvectors, iterations, count; so
    does ``eigh_newton`` (m=190, both outputs; its products ran on all m
    columns, its gathers copies) and GCG with the 'newton' Rayleigh-Ritz
    (the structural warm start, the fused loop)."""
    out, _ = four
    got = w.result(out, "four", "one_rank")[0]
    assert got["world"] == 1
    assert got[name] is True


def test_cli_mesh_matches_undistributed_driver(four, tmp_path, capsys):
    """``utils.cli.main(... -mesh 1)`` on four ranks (the 27-point stencil
    from a ``.mtx``, a starting block from ``-resume``) gives the
    undistributed driver's count and eigenvalues within 1e-12, every
    rank the full eigenvectors; only rank 0 prints, the undistributed
    driver's lines and the rank count."""
    from gcge_tpu_torch.utils import cli

    out, _ = four
    parts = w.result(out, "four", "cli")
    plain = cli.main(w.cli_inputs(str(tmp_path), "plain"))
    printed = capsys.readouterr().out.splitlines()
    ev = plain.eval[:w.CLI_NEV]
    for p in parts:
        assert p["nev_conv"] == plain.nev_conv >= w.CLI_NEV
        assert np.max(np.abs(p["eval"][:w.CLI_NEV] - ev) / np.abs(ev)) \
            <= 1e-12
        assert p["evec"].shape == tuple(plain.evec.shape)
    lines = parts[0]["stdout"].splitlines()
    lines.remove("distributed over 4 ranks")

    def heads(text):
        return [line.split()[0] for line in text if line.strip()]

    assert heads(lines) == heads(printed)
    assert all(p["stdout"] == "" for p in parts[1:])


# ---------------------------------------------------------------------------
# two ranks: the one-call frontend and per-rank ingestion
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two(ranks):
    return joined(ranks, "two")


def test_solve_distribute_two_ranks(two):
    """``solve(distribute=True, rcm=True)`` on two ranks (n=729 padded to
    730): the undistributed solve's eigenvalues, the full eigenvectors in
    the caller's order on both ranks."""
    out, _ = two
    parts = w.result(out, "two", "api_solve")
    from gcge_tpu_torch.io.fem import assemble_p1, random_delaunay_mesh

    rows, cols, vals, _, n = assemble_p1(*random_delaunay_mesh(10 ** 3,
                                                                seed=1))
    a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    ev, _, conv = gcge_tpu_torch.solve(
        a, None, nev=6, device="cpu", rcm=True, block_size=3, max_iter=150,
        verbose=0, x0=w.x0_for(n, 12))
    # the padded row moves the count past nev on its own schedule
    assert conv >= 6
    for p in parts:
        assert p["nev_conv"] >= 6
        assert np.max(np.abs(p["eval"] - ev) / np.abs(ev)) <= 1e-10
        assert p["evec"].shape == (n, 12)
    np.testing.assert_array_equal(parts[0]["evec"], parts[1]["evec"])
    x = parts[0]["evec"][:, :6]
    res = np.linalg.norm(a @ x - x * parts[0]["eval"][None, :], axis=0)
    assert res.max() <= 2e-8 * np.abs(parts[0]["eval"]).max()


def test_bootstrap_and_host_blocks_two_ranks(two):
    """``bootstrap`` + ``dia_from_host_blocks`` (each rank builds only its
    rows) solve the 1-D Laplacian to its closed-form spectrum, as
    ``tests/test_multiproc.py`` holds gcge_tpu; ``csr_from_host_blocks`` and
    ``mv_from_host_blocks`` give the same product."""
    out, codes = two
    parts = w.result(out, "two", "host_blocks")
    n = 256
    h = 1.0 / (n + 1)
    exact = (2.0 / h) * (1.0 - np.cos(np.arange(1, 5) * np.pi * h))
    for p in parts:
        assert p["nev_conv"] >= 4
        np.testing.assert_allclose(p["eval"][:4], exact, rtol=1e-8)
    rows, cols, vals, _ = w.laplacian_1d(n)
    y = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)) @ w.block(n, 3, 7)
    for key in ("y_dia", "y_csr"):
        got = _stitch([p[key] for p in parts], n)
        assert np.abs(got - y).max() <= 1e-13 * np.abs(y).max()
    assert parts[0]["csr_halo"] == (1, 1, False)
    assert codes == [0, 0]


# ---------------------------------------------------------------------------
# the distributed multilevel path over four ranks against gcge_tpu's
# ---------------------------------------------------------------------------


def test_sharded_transfers_match_jax(jax_mg, four):
    """``ProlongOperator`` (the rank's rows of P against the replicated
    coarse block, stitched) and ``RestrictOperator`` (the rank's columns of
    P^T, then one psum: the same in every rank) against gcge_tpu's
    products on the same blocks; level 0 alone carries the mesh."""
    out, _ = four
    parts = w.result(out, "four", "mg_transfers")
    p_ref, r_ref = jax_mg["prolong"], jax_mg["restrict"]
    got = _stitch([p["prolong"] for p in parts], w.MG_N)
    assert np.abs(got - p_ref).max() <= 1e-13 * np.abs(p_ref).max()
    for p in parts:
        assert np.abs(p["restrict"] - r_ref).max() <= \
            1e-13 * np.abs(r_ref).max()
        np.testing.assert_array_equal(p["restrict"], parts[0]["restrict"])
    n_c = r_ref.shape[0]
    assert parts[0]["types"] == ("ProlongOperator", "RestrictOperator")
    assert parts[0]["shapes"] == ((w.MG_N, n_c), (n_c, w.MG_N),
                                  (w.MG_N // 4, n_c), (n_c, w.MG_N // 4))
    assert parts[0]["mesh_levels"] == [True] + [False] * (w.MG_LEVELS - 1)


def test_coarse_correction_same_bits_on_every_rank(four):
    """The replicated coarse levels' V-cycle from one restricted residual:
    every rank computes the same bits, with no collective."""
    out, _ = four
    parts = w.result(out, "four", "mg_transfers")
    for p in parts[1:]:
        np.testing.assert_array_equal(p["coarse_correction"],
                                      parts[0]["coarse_correction"])
    assert np.abs(parts[0]["coarse_correction"]).max() > 0


@pytest.mark.parametrize("smoother", ["cg", "chebyshev"])
def test_distributed_bamg_solve_matches_jax(jax_mg, four, smoother):
    """``bamg_solve`` on the sharded hierarchy (``tests/test_dist.py``'s
    case): relative residual below 1e-10, x within 1e-7 (CG smoother) or
    1e-6 (Chebyshev) of x_true; with the CG smoother, the cycles of
    gcge_tpu's distributed solve and of the port's undistributed one."""
    out, _ = four
    parts = w.result(out, "four", "mg_transfers")
    runs = [p[smoother] for p in parts]
    x = _stitch([r["x"] for r in runs], w.MG_N)
    for r in runs:
        assert r["rel"] < 1e-10
        assert r["cycles"] == runs[0]["cycles"]
    atol = 1e-7 if smoother == "cg" else 1e-6
    np.testing.assert_allclose(x, jax_mg["x_true"], atol=atol)
    if smoother == "cg":
        assert runs[0]["cycles"] == jax_mg["cg_cycles"] == \
            parts[0]["cg_undistributed_cycles"]


def test_distributed_gcg_with_bamg_preconditioner_matches_jax(jax_mg, four):
    """GCG on the sharded DIA operator with ``bamg_preconditioner`` of the
    sharded hierarchy (``tests/test_dist.py``'s case, nev=5, block 3,
    ``cg_max_iter=8``) against gcge_tpu's on its mesh: eigenvalues 1e-10,
    the same converged count, iterations within 2."""
    out, _ = four
    parts = w.result(out, "four", "mg_gcg")
    jr = jax_mg["gcg"]
    nev = w.MG_GCG["nev"]
    for p in parts:
        np.testing.assert_array_equal(p["eval"], parts[0]["eval"])
        assert p["kind"] == "dia"
    res = parts[0]
    assert res["nev_conv"] >= nev and res["nev_conv"] == jr.nev_conv
    ev_j = np.asarray(jr.eval)[:nev]
    assert np.max(np.abs(res["eval"][:nev] - ev_j) / np.abs(ev_j)) <= 1e-10
    assert abs(res["num_iter"] - jr.num_iter) <= 2


@pytest.mark.parametrize("name", list(w.PAS_CASES))
def test_distributed_pas_matches_jax(jax_mg, four, name):
    """``pas_solve`` on the sharded hierarchy, explicit span and composite
    Rayleigh-Ritz, against gcge_tpu's on its mesh: the same sweeps by level
    and converged count, eigenvalues within 1e-9; every rank holds the same
    eigenvalues and levels' histories, bit for bit, and its rows of the
    eigenvectors."""
    out, _ = four
    parts = [p[name] for p in w.result(out, "four", "pas")]
    jres, j_sweeps = jax_mg[name]
    res = parts[0]
    for p in parts[1:]:
        np.testing.assert_array_equal(p["eval"], res["eval"])
        assert p["sweeps"] == res["sweeps"]
        for (lv, lam), (lv0, lam0) in zip(p["history"], res["history"]):
            assert lv == lv0
            np.testing.assert_array_equal(lam, lam0)
    assert res["sweeps"] == j_sweeps
    assert res["nev_conv"] == jres.nev_conv >= w.PAS_NEV
    np.testing.assert_allclose(res["eval"], np.asarray(jres.eval), rtol=1e-9)
    assert [lv for lv, _ in res["history"]] == \
        [lv for lv, _ in jres.level_history]
    assert res["evec"].shape == (w.MG_N // 4, w.PAS_NEV)


@pytest.mark.parametrize("name", ["amg", "plain", "composite"])
def test_one_rank_hierarchy_equals_no_mesh_bit_for_bit(four, name):
    """On a one-rank mesh the sharded hierarchy is the undistributed one:
    its P rows and P^T columns are the whole transfers and its collectives
    are copies, so GCG with the V-cycle and PAS give the same bits."""
    out, _ = four
    got = w.result(out, "four", "mg_one_rank")[0]
    assert got[name] is True


def test_hybrid_row_mesh_four_ranks(four):
    """``hybrid_row_mesh`` on four ranks of one host is ``row_mesh``: the
    same rank, world and peers."""
    out, _ = four
    for rank, p in enumerate(w.result(out, "four", "hybrid_mesh")):
        assert p["hybrid"] == p["row"] == (rank, 4, (0, 1, 2, 3))


def test_check_host_major():
    """The host-order check accepts host-major rank orders and names one
    that is not."""
    for hosts in (["a"], ["a", "a", "b", "b"], ["b", "a", "a", "c"]):
        check_host_major(hosts)
    for hosts in (["a", "b", "a"], ["a", "a", "b", "b", "a"]):
        with pytest.raises(ValueError, match="host-major"):
            check_host_major(hosts)


# ---------------------------------------------------------------------------
# two ranks: the distributed multilevel frontend
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_api(jax_mg):
    """``gcge_tpu.solve(distribute=True)`` of each one-call case on its
    8-device mesh (``lap_pas``: :func:`jax_mg`'s)."""
    out = {"lap_pas": jax_mg["lap_pas"]}
    for name, (matrix, kw, k) in w.API_MG.items():
        if name in out:
            continue
        a, b = w.api_matrices(matrix)
        x0 = None if k is None else jnp.asarray(w.x0_for(a.shape[0], k))
        out[name] = gcge_tpu.solve(a, b, distribute=True, verbose=0, x0=x0,
                                   **kw)
    return out


@pytest.mark.parametrize("name", list(w.API_MG))
def test_solve_distributed_multilevel_matches_jax(jax_api, two, name):
    """``solve(distribute=True)`` on two ranks with ``multigrid=3`` (GCG
    preconditioned by the sharded V-cycle) and ``method="pas"`` (two
    levels), on the cube FEM pair at nx=9 (n=512, with B), and PAS on the
    1-D Laplacian at n=512
    (``tests/test_api.py``'s distributed PAS case), against
    ``gcge_tpu.solve`` with the same arguments: eigenvalues within 1e-10
    (GCG) or 1e-9 (PAS), the same converged count; both ranks hold the same
    full eigenvectors."""
    out, _ = two
    parts = [p[name] for p in w.result(out, "two", "mg_api")]
    ev_j, _, conv_j = jax_api[name]
    matrix, kw, _ = w.API_MG[name]
    nev = kw["nev"]
    res = parts[0]
    np.testing.assert_array_equal(parts[1]["eval"], res["eval"])
    np.testing.assert_array_equal(parts[1]["evec"], res["evec"])
    assert res["nev_conv"] == conv_j
    assert res["nev_conv"] >= (2 if name == "fem_pas" else nev)
    ev_j = np.asarray(ev_j)[:nev]
    tol = 1e-9 if kw.get("method") == "pas" else 1e-10
    assert np.max(np.abs(res["eval"][:nev] - ev_j) / np.abs(ev_j)) <= tol
    assert res["evec"].shape[0] == 512


def test_distributed_hierarchy_needs_divisible_rows(two):
    """n=511 on two ranks: ``solve(distribute=True)`` with ``multigrid``
    and with ``method="pas"`` raises ``ValueError``, since the hierarchy's
    finest level is not padded.  gcge_tpu shards its hierarchy only where
    the rows divide its devices (``gcge_tpu/api.py:266-275``): otherwise
    its GCG gets an unsharded preconditioner of n rows for residuals of the
    padded n, a shape error, and its PAS runs the unsharded hierarchy
    undistributed, in silence."""
    out, _ = two
    for p in w.result(out, "two", "divisibility"):
        for name in ("multigrid", "pas"):
            assert p[name] is not None and "multiple of the rank count" in \
                p[name]


# ---------------------------------------------------------------------------
# the 2-D grid over four ranks against gcge_tpu's grid_mesh(2, 2), and on
# two ranks
# ---------------------------------------------------------------------------


def test_grid_mesh_coordinates_and_groups(four):
    """Global rank g of the (2, 2) grid sits at (g // 2, g % 2); its row
    group holds the ranks of its grid column, its column group those of its
    grid row; a (4, 1) grid is the row mesh's layout."""
    out, _ = four
    for g, p in enumerate(w.result(out, "four", "grid")):
        r, c = divmod(g, 2)
        assert p["coords"] == (r, c, 2, 2)
        assert p["row_group"] == (c, 2 + c)
        assert p["col_group"] == (2 * r, 2 * r + 1)
        assert p["tall_coords"] == (g, 0, (0, 1, 2, 3))


@pytest.mark.parametrize("kind", ["dia", "csr"])
def test_grid_matvec_matches_jax(jax_grid, four, kind):
    """The sharded DIA and CSR products on the (2, 2) grid, each rank on its
    rows and its 3 of the 6 columns, gathered whole, against gcge_tpu's
    ``grid_mesh(2, 2)`` products (its ELL stands for the CSR)."""
    out, _ = four
    ref = jax_grid[kind]
    for p in w.result(out, "four", "grid"):
        assert p[kind + "_local"] == (w.GRID_N // 2, w.GRID_M // 2)
        assert np.abs(p[kind] - ref).max() <= 1e-13 * np.abs(ref).max()


def _grid_reference(name, jax_grid, jax_solves):
    """The reference solve of a grid case: gcge_tpu's on ``grid_mesh(2,
    2)``, its ``row_mesh(4)`` solve of a case of ``SOLVES``, or for the mgs
    and ``cg_order=2`` case the port's undistributed solve."""
    from gcge_tpu_torch import GCGParams, gcg_solve

    if name in w.SOLVES:
        return jax_solves[name]
    kind, kw = w.GRID_SOLVES[name]
    if "orth_method" not in kw:
        return jax_grid["gcg"]
    return gcg_solve(w.grid_operator(kind), None,
                     GCGParams(verbose=0, **w.GRID_GCG, **kw),
                     x0=w.x0_for(w.GRID_N, w.GRID_X0))


@pytest.mark.parametrize("name", w.GRID_CASES)
def test_grid_gcg_matches_jax(jax_grid, jax_solves, four, name):
    """GCG on the (2, 2) grid, phased and fused, DIA and CSR, against
    gcge_tpu's solve on ``grid_mesh(2, 2)``; the mixed fused case (the f32
    CG stage on the grid, the banded matrix of ``dia_std_mixed_fused``)
    against gcge_tpu's solve of that case on ``row_mesh(4)``; the mgs and
    ``cg_order=2`` case against the port's undistributed solve:
    eigenvalues within 1e-10 relative, the same converged count,
    iterations within 2.
    Every rank of the grid holds the same eigenvalues, counts and gathered
    eigenvectors, bit for bit, and between iterations its n/2 rows and
    m_V/2 columns of V (m_V = nev_max + 2 block = 24)."""
    out, _ = four
    parts = [p[name] for p in w.result(out, "four", "grid")]
    res = parts[0]
    for p in parts[1:]:
        np.testing.assert_array_equal(p["eval"], res["eval"])
        np.testing.assert_array_equal(p["evec"], res["evec"])
        assert (p["num_iter"], p["nev_conv"]) == (res["num_iter"],
                                                  res["nev_conv"])
    ref = _grid_reference(name, jax_grid, jax_solves)
    nev = w.GRID_GCG["nev"]
    assert res["nev_conv"] >= nev and res["nev_conv"] == ref.nev_conv
    ev_ref = np.asarray(ref.eval)[:nev]
    assert np.max(np.abs(res["eval"][:nev] - ev_ref) / ev_ref) <= 1e-10
    assert abs(res["num_iter"] - ref.num_iter) <= 2
    for p in parts:
        assert p["held"] == (w.GRID_N // 2, 12)
        assert p["evec_local"] == (w.GRID_N // 2, 8)


def test_grid_products_run_on_half_the_columns(four):
    """The counter of the sharded products' widths: on the (2, 2) grid each
    rank ran every product of the mixed fused case (X at the start, the
    residual window, the W block's f64 and f32 products) on half the
    columns of the block the row mesh (the ``solves`` task) runs it on,
    and held half of V's columns."""
    out, _ = four
    name = w.GRID_TALL_CASE
    rows = w.result(out, "four", "solves")
    for p, r in zip(w.result(out, "four", "grid"), rows):
        row, grid = r[name]["widths"], p[name]["widths"]
        assert sorted(row) == [4, 8, 16]
        assert sorted(grid) == sorted(k // 2 for k in row)
        assert p[name]["held"] == (w.GRID_N // 2, 12)


def test_tall_grid_equals_row_mesh_bit_for_bit(four):
    """A (4, 1) grid is the row mesh at four ranks: the same eigenvalues,
    eigenvector rows, iterations and count as the ``solves`` task's
    row-mesh solve of the same case, bit for bit."""
    out, _ = four
    name = w.GRID_TALL_CASE
    rows = w.result(out, "four", "solves")
    for p, r in zip(w.result(out, "four", "grid"), rows):
        tall, row = p["tall"], r[name]
        np.testing.assert_array_equal(tall["eval"], row["eval"])
        np.testing.assert_array_equal(tall["evec"], row["evec"])
        assert (tall["num_iter"], tall["nev_conv"]) == (row["num_iter"],
                                                        row["nev_conv"])


def test_pcg_mesh_matches_undistributed(four):
    """``pcg(mesh=)`` on the four-rank row mesh (the sharded 1-D
    Laplacian): within 1e-13 of the undistributed ``pcg``, the same
    iterations, on every rank."""
    from gcge_tpu_torch.solvers.bpcg import pcg

    out, _ = four
    a_op = w.grid_operator("dia")
    b = torch.as_tensor(w.block(w.GRID_N, 1, 42))[:, 0]
    ref, info = pcg(a_op.matvec, b, torch.zeros_like(b), **w.PCG_KW)
    ref = ref.numpy()
    for p in w.result(out, "four", "grid"):
        assert np.abs(p["pcg"] - ref).max() <= 1e-13 * np.abs(ref).max()
        assert p["pcg_iters"] == info.niters


def test_grid_pas_matches_row_mesh(four):
    """``pas_solve`` on a hierarchy sharded over the (2, 2) grid: both grid
    columns give the same bits (eigenvalues, sweeps, each row block of the
    eigenvectors), and the result is the row mesh's (the four-rank
    ``pas`` task) to 1e-9, with the same sweeps and count."""
    out, _ = four
    grid = w.result(out, "four", "grid_pas")
    rows = [p["plain"] for p in w.result(out, "four", "pas")]
    for p in grid:
        np.testing.assert_array_equal(p["eval"], grid[0]["eval"])
        assert (p["sweeps"], p["nev_conv"]) == (grid[0]["sweeps"],
                                                grid[0]["nev_conv"])
    for r in range(2):
        np.testing.assert_array_equal(grid[2 * r]["evec"],
                                      grid[2 * r + 1]["evec"])
        assert grid[2 * r]["evec"].shape == (w.MG_N // 2, w.PAS_NEV)
    assert grid[0]["sweeps"] == rows[0]["sweeps"]
    assert grid[0]["nev_conv"] == rows[0]["nev_conv"] >= w.PAS_NEV
    np.testing.assert_allclose(grid[0]["eval"], rows[0]["eval"], rtol=1e-9)


@pytest.mark.parametrize("name", list(w.API_GRID))
def test_solve_distribute_grid_matches_jax(jax_grid, jax_api, four, name):
    """``solve(distribute="grid")`` on four ranks (a (2, 2) grid) of the
    cube FEM pair at nx=9 with B, plain and with ``multigrid=3``, against
    gcge_tpu's ``solve(distribute="grid")`` (the plain case) and its
    distributed solve of the same ``multigrid=3`` case (``jax_api``'s):
    eigenvalues within 1e-10, the same count; every rank holds the same
    whole eigenvectors."""
    out, _ = four
    parts = [p[name] for p in w.result(out, "four", "grid_api")]
    ev_j, _, conv_j = jax_grid["fem_plain"] if name == "fem_plain" else \
        jax_api["fem_amg"]
    res = parts[0]
    for p in parts[1:]:
        np.testing.assert_array_equal(p["eval"], res["eval"])
        np.testing.assert_array_equal(p["evec"], res["evec"])
    nev = w.API_GRID[name][0]["nev"]
    assert res["nev_conv"] == conv_j >= nev
    ev_j = np.asarray(ev_j)[:nev]
    assert np.max(np.abs(res["eval"][:nev] - ev_j) / np.abs(ev_j)) <= 1e-10
    assert res["evec"].shape == (512, 8)


def test_solve_grid_on_two_ranks_is_the_row_mesh(two):
    """On two ranks ``solve(distribute="grid")`` runs the row mesh, as
    gcge_tpu falls back to it: ``distribute=True``'s bits."""
    out, _ = two
    for p in w.result(out, "two", "grid_two"):
        assert p["grid_is_rows"] is True


def test_pcg_one_rank_mesh_equals_no_mesh_bit_for_bit(two):
    """``pcg`` on a one-rank subgroup: the undistributed ``pcg``'s bits."""
    out, _ = two
    assert w.result(out, "two", "grid_two")[0]["pcg_one_rank"] is True


# ---------------------------------------------------------------------------
# the partitioned eigh_newton over four and two ranks against gcge_tpu's
# sharded eigh_newton, and the distributed 'newton' GCG
# ---------------------------------------------------------------------------


def _sin_angle(a, b):
    """Sine of the largest principal angle between the spans of the
    orthonormal columns ``a`` and ``b``."""
    return np.linalg.norm(b - a @ (a.T @ b), 2)


@pytest.mark.parametrize("case", list(w.NEWTON_CASES))
@pytest.mark.parametrize("name", ["four_rows", "four_grid", "two_rows"])
def test_partitioned_eigh_newton_matches_jax(jax_newton, request, name,
                                             case):
    """``eigh_newton(mesh=)`` on the 4-rank row mesh, the (2, 2) grid and
    the 2-rank row mesh, on tests/test_dist.py's sharded case (m=192, a
    degenerate cluster at 40-43, a warm start 3e-7 off) and at m=190 with
    63 blocks (neither divides by the ranks): eigenvalues within 1e-12 of
    gcge_tpu's sharded eigh_newton and of the port's without a mesh, the
    residual below 1e-9 of max|lambda|, the cluster's span and that of the
    44 lowest pairs within 1e-10 of the port's without a mesh; every rank
    the same bits; the ``out='cols'`` blocks, stitched, the replicated u
    bit for bit; each product on the rank's ``|J_r|`` columns and each
    block eigh on its slice of the blocks (the counters), one broadcast."""
    from gcge_tpu_torch.ops.eighs import column_ranges

    group, kind = name.split("_")
    out, _ = request.getfixturevalue(group)
    parts = [p[kind, case] for p in w.result(out, group, "newton")]
    m, nblk = w.NEWTON_CASES[case]
    world = len(parts)
    ref = jax_newton[case]
    h, _, _ = w.newton_case(m)
    res = parts[0]
    for p in parts[1:]:
        np.testing.assert_array_equal(p["w"], res["w"])
        np.testing.assert_array_equal(p["u"], res["u"])
    stitched = np.concatenate([p["u_cols"] for p in parts], axis=1)
    np.testing.assert_array_equal(stitched, res["u"])
    wr, ur = res["w"], res["u"]
    for other in (ref["jax"], ref["port"]["w"]):
        assert np.max(np.abs(wr - other) / np.abs(other)) <= 1e-12
    lam_max = np.abs(wr).max()
    assert np.linalg.norm(h @ ur - ur * wr, axis=0).max() <= 1e-9 * lam_max
    u_plain = ref["port"]["u"]
    for cols in (slice(40, 44), slice(0, 44)):
        assert _sin_angle(ur[:, cols], u_plain[:, cols]) <= 1e-10
    nblk = nblk or min(m // 2, 64)
    for rank, p in enumerate(parts):
        j0, j1 = column_ranges(m, world)[rank]
        assert p["u_cols"].shape == (m, j1 - j0)
        assert set(p["cols"]) == {j1 - j0}
        assert -(-nblk // world) in p["blocks"]
        assert set(p["blocks"]) <= {-(-nblk // world), -(-min(8, m // 2)
                                                        // world)}
        assert p["broadcasts"] == 1 and p["gathers"] == res["gathers"] > 0


def test_newton_column_ranges_cover_every_column():
    """The partition's ranges: contiguous, in rank order, ceil(m / world)
    wide but the last ones, covering [0, m) once, also where the rank count
    does not divide m or exceeds it."""
    from gcge_tpu_torch.ops.eighs import column_ranges

    for m, world in ((192, 4), (190, 4), (11, 4), (5, 4), (3, 4), (7, 1)):
        ranges = column_ranges(m, world)
        assert len(ranges) == world and ranges[0][0] == 0
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert ranges[-1][1] == m
        assert max(j1 - j0 for j0, j1 in ranges) == -(-m // world)
    assert column_ranges(190, 4) == [(0, 48), (48, 96), (96, 144),
                                     (144, 190)]


@pytest.mark.parametrize("name", list(w.NEWTON_SOLVES))
def test_distributed_newton_gcg_matches_jax(jax_newton, four, name):
    """GCG with ``rr_backend='newton'`` on the 4-rank row mesh
    (tests/test_dist.py's case: the 1-D Laplacian at n=512, nev=5, block 3,
    rel-tol 1e-8), cold by the phased loop and with the structural warm
    start by the fused loop, against gcge_tpu's distributed 'newton' GCG on
    row_mesh(4): the same converged count, eigenvalues within 1e-10; every
    rank the same eigenvalues and iterations; the Newton eighs' products
    on the rank's columns of m = size_x + 2 block = 16; with the warm
    start, every rank took it in the same steps, at least one (the mesh
    path that carries ``warm_h1`` ran)."""
    out, _ = four
    parts = [p[name] for p in w.result(out, "four", "newton_gcg")]
    res, ref = parts[0], jax_newton[name]
    for p in parts[1:]:
        np.testing.assert_array_equal(p["eval"], res["eval"])
        assert (p["num_iter"], p["nev_conv"]) == (res["num_iter"],
                                                  res["nev_conv"])
    nev = w.NEWTON_GCG["nev"]
    assert res["nev_conv"] == ref.nev_conv >= nev
    ev_ref = ref.eval[:nev]
    assert np.max(np.abs(res["eval"][:nev] - ev_ref) / ev_ref) <= 1e-10
    for p in parts:
        assert p["cols"].get(4, 0) > 0 and p["evec"].shape[0] == w.GRID_N // 4
        assert p["warm_taken"] == res["warm_taken"]
    taken = res["warm_taken"]
    if name == "struct_fused":
        assert 0 < sum(taken) < len(taken)
    else:
        assert taken == []


def test_struct_warm_premise_is_rank_zeros(four):
    """``_rr_struct_warm`` under a mesh takes rank 0's premise: on a matrix
    whose premise holds on rank 0 and fails on the others (their X-W
    coupling is large), every rank of the row mesh and of the (2, 2) grid
    takes the warm branch, and the Newton eigh after it ends with the same
    bits on every rank (the warm and the cold branch run different
    collectives: ranks that split would hang or mix)."""
    out, _ = four
    parts = w.result(out, "four", "struct_warm_flag")
    assert [p["alone"] for p in parts] == [True, False, False, False]
    for kind in ("rows", "grid"):
        assert all(p[kind]["ok"] is True for p in parts)
        for p in parts[1:]:
            np.testing.assert_array_equal(p[kind]["w"], parts[0][kind]["w"])
            np.testing.assert_array_equal(p[kind]["u"], parts[0][kind]["u"])
