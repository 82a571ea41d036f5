"""The port's row-sharded distribution against gcge_tpu's, on the CPU.

The port runs one process a rank on ``torch.distributed`` (gloo here, NCCL
on cards); ``gcge_tpu`` runs one process over its 8-device virtual CPU mesh.
The ranks (``tests/torch_dist_worker.py``: four, and two for the one-call
frontend and the per-rank ingestion) are started once for the module, in
spawned interpreters that never import ``jax``, and run every check while
this process computes ``gcge_tpu``'s results on ``row_mesh(4)`` from the
same numpy inputs.  Each rank has a hard time limit: a rank that waits in a
collective fails the checks it did not finish instead of hanging the suite.

Tolerances: the stitched sharded products equal ``gcge_tpu``'s to 1e-13 of
their largest entry (the same sums in another order); the solves, as in
``tests/test_torch_gcg.py``, have eigenvalues within 1e-10 relative, the
same converged count and iteration counts within 2; the f32 products of the
windowed path, and a solve on a one-rank mesh, equal the undistributed
port's bit for bit (the same operations on the same values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

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
from gcge_tpu.parallel import shard_rows as j_shard_rows
from gcge_tpu.solvers.gcg import GCGParams as JParams
from gcge_tpu.solvers.gcg import gcg_solve as j_gcg_solve
import gcge_tpu_torch
from gcge_tpu_torch import (CsrOperator, DiagOperator, DiaOperator,
                            HybridOperator)
from gcge_tpu_torch.ops import spmm
from gcge_tpu_torch.parallel import (grid_mesh, hybrid_row_mesh, pad_problem,
                                     row_mesh)
from gcge_tpu_torch.solvers.gcg import _f32_apply

torch.set_num_threads(2)

# seconds the ranks of one group may take in all (about 30 s alone)
RANK_LIMIT = 420


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both rank groups, started at once; joined by :func:`joined`."""
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
    """No initialized group: ``row_mesh`` and ``solve(distribute=True)``
    raise (nothing runs undistributed in silence); what waits for item 12b
    names it."""
    a = sps.identity(40, format="csr")
    with pytest.raises(RuntimeError, match="process group"):
        row_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        gcge_tpu_torch.solve(a, nev=2, device="cpu", distribute=True)
    for kw in (dict(distribute="grid"), dict(distribute=True, multigrid=3),
               dict(distribute=True, method="pas")):
        with pytest.raises(NotImplementedError, match="item 12b"):
            gcge_tpu_torch.solve(a, nev=2, device="cpu", **kw)
    for fn in (grid_mesh, hybrid_row_mesh):
        with pytest.raises(NotImplementedError, match="item 12b"):
            fn()


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


@pytest.fixture(scope="module")
def four(ranks, jax_matvecs, jax_solves):
    """The four-rank group's results (joined after gcge_tpu's products and
    solves, which this process computes while the ranks run)."""
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
                                  "csr_std_mixed_phased"])
def test_one_rank_mesh_equals_no_mesh_bit_for_bit(four, name):
    """A mesh of one rank (a subgroup of rank 0) gives the solve without a
    mesh bit for bit: eigenvalues, eigenvectors, iterations, count."""
    out, _ = four
    got = w.result(out, "four", "one_rank")[0]
    assert got["world"] == 1
    assert got[name] is True


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
