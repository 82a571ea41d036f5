"""Ranks of the port's distributed tests (``tests/test_torch_dist.py``):
gloo process groups on the CPU, one process a rank, started by
:func:`launch` with the ``spawn`` method.

This module imports numpy, scipy and ``gcge_tpu_torch`` only, never ``jax``
or ``gcge_tpu``: a rank is a process of the port alone.  Each rank runs every
task of its group in order (``TASKS``) and writes each task's result to
``<outdir>/<group>_<task>_<rank>.pkl``; a task that raises writes its
traceback instead and ends the rank, whose peers then fail in their next
collective.  The problem constructors are shared with the test process, which
hands the same inputs to ``gcge_tpu``.
"""

from __future__ import annotations

import functools
import os
import pickle
import socket
import time
import traceback
from types import SimpleNamespace

import numpy as np

# ---------------------------------------------------------------------------
# inputs (numpy and scipy only), shared with the test process
# ---------------------------------------------------------------------------

WORLD = {"four": 4, "two": 2}


def banded(n: int, offsets, seed: int):
    """COO of a symmetric, diagonally dominant matrix on the diagonal and
    the offsets ``±o`` of ``offsets``."""
    rng = np.random.default_rng(seed)
    r = np.arange(n)
    rows, cols = [r], [r]
    vals = [rng.uniform(1.0, 2.0, n) + 2.0 * len(offsets)]
    for o in offsets:
        v = rng.uniform(-1.0, 0.0, n - o)
        rows += [r[:n - o], r[o:]]
        cols += [r[o:], r[:n - o]]
        vals += [v, v]
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def laplacian_1d(n: int):
    """COO of the 1-D Laplacian ``tridiag(-1, 2, -1) / h``, h = 1/(n+1), and
    h: its eigenvalues are ``(2/h)(1 - cos(k pi h))``."""
    h = 1.0 / (n + 1)
    r = np.arange(n)
    rows = np.concatenate([r, r[:-1], r[1:]])
    cols = np.concatenate([r, r[1:], r[:-1]])
    vals = np.concatenate([np.full(n, 2.0 / h), np.full(2 * (n - 1), -1.0 / h)])
    return rows, cols, vals, h


def delaunay_rcm():
    """COO of the P1 stiffness matrix on a 10^3-point Delaunay mesh (n=729),
    RCM-ordered: an irregular pattern with a narrow band."""
    import scipy.sparse as sps
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from gcge_tpu_torch.io.fem import assemble_p1, random_delaunay_mesh

    rows, cols, vals, _, n = assemble_p1(*random_delaunay_mesh(10 ** 3,
                                                                seed=1))
    a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    perm = reverse_cuthill_mckee(a, symmetric_mode=True)
    c = a[perm][:, perm].tocoo()
    return c.row, c.col, c.data


def hybrid_coo(n: int = 512, seed: int = 3):
    """COO of a 1-D Laplacian with 40 symmetric outliers a third of the
    matrix away: three diagonals and a scatter (``tests/test_dist.py``'s
    Hybrid case)."""
    rng = np.random.default_rng(seed)
    a = 2.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    oi = rng.integers(0, n // 2, size=40)
    oj = oi + n // 3
    a[oi, oj] += 0.5
    a[oj, oi] += 0.5
    rows, cols = np.nonzero(a)
    return rows, cols, a[rows, cols]


def dense_sym(n: int = 64, seed: int = 4):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return a + a.T


def block(n: int, m: int, seed: int):
    return np.random.default_rng(seed).standard_normal((n, m))


# the matvec cases: name -> (matrix function, n, columns); the x is block(n,
# columns, 7)
MATVECS = {
    "dia_halo": (lambda: banded(512, (1, 17), 0), 512, 5),
    "dia_gather": (lambda: banded(64, (20,), 1), 64, 3),
    "csr": (delaunay_rcm, 729, 4),
    "hybrid": (hybrid_coo, 512, 4),
}

# the solve cases: name -> (matrix, B, params, x0 columns); the JAX
# reference of a fused case is the phased solve of the same problem
_MIXED = dict(cg_mixed=True, cg_refine=2, cg_auto_shift=True)
SOLVES = {
    "dia_std_mixed_phased": ("banded", None, dict(
        nev=8, block_size=4, max_iter=120, cg_max_iter=20, fuse=0, **_MIXED),
        16),
    "dia_std_mixed_fused": ("banded", None, dict(
        nev=8, block_size=4, max_iter=120, cg_max_iter=20, fuse=4, **_MIXED),
        16),
    "dia_gen_padded_plain_phased": ("lap403", "h", dict(
        nev=6, block_size=3, max_iter=120, fuse=0), 12),
    "dia_gen_padded_plain_fused": ("lap403", "h", dict(
        nev=6, block_size=3, max_iter=120, fuse=5), 12),
    # gcge_tpu's mixed inner CG under a mesh takes no B (its sharded B is
    # not a DiagOperator), so the mixed padded case is a standard one
    "dia_std_padded_mixed_phased": ("lap403s", None, dict(
        nev=6, block_size=3, max_iter=120, cg_max_iter=30, fuse=0, **_MIXED),
        12),
    "csr_std_plain_fused": ("delaunay", None, dict(
        nev=6, block_size=3, max_iter=150, cg_max_iter=30, fuse=5), 12),
    # gcge_tpu's sharded ELL operator has no f32 product: its reference is
    # the undistributed solve
    "csr_std_mixed_phased": ("delaunay", None, dict(
        nev=6, block_size=3, max_iter=150, cg_max_iter=30, fuse=0, **_MIXED),
        12),
}


def solve_problem(name: str):
    """``(rows, cols, vals, n, b_diag or None)`` of a solve case's matrix."""
    if name == "banded":
        return (*banded(512, (1, 17), 0), 512, None)
    if name.startswith("lap403"):
        rows, cols, vals, h = laplacian_1d(403)
        return rows, cols, vals, 403, np.full(403, h) \
            if name == "lap403" else None
    rows, cols, vals = delaunay_rcm()
    return rows, cols, vals, 729, None


def x0_for(n: int, cols: int) -> np.ndarray:
    return np.random.default_rng(11).uniform(-1, 1, (n, cols))


# the distributed multilevel cases: the 1-D Laplacian with three levels
# (``tests/test_dist.py``'s), its coarse and fine blocks for the transfers,
# the right-hand side of bamg_solve (A x_true, x_true of the rng(42) of
# ``tests/conftest.py``), the PAS cases and the GCG case
MG_N, MG_LEVELS = 512, 3
MG_GCG = dict(nev=5, block_size=3, cg_max_iter=8, tol_rel=1e-9)
MG_GCG_X0 = 10
PAS_CASES = {
    "plain": dict(final_sweeps=10, bamg_cycles=6, tol_rel=1e-7),
    "composite": dict(final_sweeps=10, bamg_cycles=6, tol_rel=1e-7,
                      composite_rr=True),
}
PAS_NEV = 4
# the one-call cases on two ranks: (matrix, solve keywords, x0 columns);
# lap_pas runs the "plain" case of PAS_CASES
API_MG = {
    "fem_amg": ("fem9", dict(nev=4, block_size=2, multigrid=3), 8),
    "fem_pas": ("fem9", dict(nev=4, multigrid=2, method="pas",
                             pas_final_sweeps=10, pas_cycles=6,
                             tol_rel=1e-7), None),
    "lap_pas": ("lap512", dict(nev=PAS_NEV, multigrid=MG_LEVELS,
                               method="pas", pas_final_sweeps=10,
                               pas_cycles=6, tol_rel=1e-7), None),
}


def lap_coo(n: int):
    """The 1-D Laplacian of :func:`laplacian_1d` in row-major order, as
    ``np.nonzero`` of the dense matrix gives it."""
    import scipy.sparse as sps

    rows, cols, vals, _ = laplacian_1d(n)
    c = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr().tocoo()
    return c.row, c.col, c.data


def api_matrices(name: str):
    """``(A, B or None)`` of a one-call case, scipy CSR."""
    import scipy.sparse as sps

    if name == "fem9":
        from gcge_tpu_torch.io.fem import cube_fem_laplacian

        rows, cols, av, bv, n = cube_fem_laplacian(9)
        return (sps.coo_matrix((av, (rows, cols)), shape=(n, n)).tocsr(),
                sps.coo_matrix((bv, (rows, cols)), shape=(n, n)).tocsr())
    rows, cols, vals = lap_coo(MG_N)
    return sps.coo_matrix((vals, (rows, cols)), shape=(MG_N, MG_N)).tocsr(), \
        None


# ---------------------------------------------------------------------------
# tasks (run in the ranks)
# ---------------------------------------------------------------------------


def _port_operator(kind, rows, cols, vals, n, dtype=None):
    import torch

    from gcge_tpu_torch import CsrOperator, HybridOperator, make_operator

    dtype = dtype or torch.float64
    if kind == "csr":
        return CsrOperator.from_coo(rows, cols, vals, (n, n), dtype=dtype,
                                    device="cpu")
    if kind == "hybrid":
        return HybridOperator.from_coo(rows, cols, vals, (n, n), dtype=dtype,
                                       device="cpu", max_diags=3)
    return make_operator(rows, cols, vals, (n, n), dtype=dtype, device="cpu")


def task_matvecs(mesh):
    """Each matvec case's rows of ``A x`` (f64), and of the f32 product in
    the transposed layout of the mixed inner CG where the operator has one;
    the Dense and Diag cases; the path each sharded operator took."""
    import torch

    from gcge_tpu_torch import DenseOperator, DiagOperator
    from gcge_tpu_torch.parallel import (pad_problem, shard_operator,
                                         shard_rows)
    from gcge_tpu_torch.solvers.gcg import _f32_apply

    out = {}
    for name, (build, n, m) in MATVECS.items():
        rows, cols, vals = build()
        a_pad, _, _ = pad_problem(_port_operator(name.split("_")[0], rows,
                                                 cols, vals, n), None,
                                  mesh.world)
        op = shard_operator(a_pad, mesh)
        x = np.zeros((a_pad.shape[0], m))
        x[:n] = block(n, m, 7)
        x = shard_rows(mesh, torch.as_tensor(x))
        out[name] = op.matvec(x).numpy()
        out[name + "_path"] = (op.kind, op.gather, op.hl, op.hr)
        apply32, transposed = _f32_apply(op)
        if transposed:
            yt = apply32(x.T.float())
            out[name + "_t32"] = yt.T.numpy()
            out[name + "_t32_strides"] = tuple(yt.stride())
    a = dense_sym()
    x = block(64, 3, 7)
    out["dense"] = shard_operator(DenseOperator(torch.as_tensor(a)), mesh) \
        .matvec(shard_rows(mesh, torch.as_tensor(x))).numpy()
    d = np.random.default_rng(5).uniform(1, 2, 64)
    diag = shard_operator(DiagOperator(torch.as_tensor(d)), mesh)
    out["diag"] = diag.matvec(shard_rows(mesh, torch.as_tensor(x))).numpy()
    out["diag_type"] = type(diag).__name__
    return out


def _solve(mesh, name):
    import torch

    from gcge_tpu_torch import DiagOperator, GCGParams, gcg_solve
    from gcge_tpu_torch.parallel import dist_ops, pad_problem, shard_operator

    matrix, _, kw, k = SOLVES[name]
    rows, cols, vals, n, b = solve_problem(matrix)
    kind = "csr" if matrix == "delaunay" else "dia"
    a_op = _port_operator(kind, rows, cols, vals, n)
    b_op = None if b is None else DiagOperator(torch.as_tensor(b))
    a_pad, b_pad, _ = pad_problem(a_op, b_op, mesh.world)
    x0 = np.zeros((a_pad.shape[0], k))
    x0[:n] = x0_for(n, k)
    dist_ops.WIDTHS.clear()
    res = gcg_solve(shard_operator(a_pad, mesh), shard_operator(b_pad, mesh),
                    GCGParams(verbose=0, **kw), x0=x0, mesh=mesh)
    return {"eval": res.eval, "nev_conv": res.nev_conv,
            "num_iter": res.num_iter, "evec_rows": res.evec.shape[0],
            "evec": res.evec.numpy(), "widths": dict(dist_ops.WIDTHS)}


def task_solves(mesh):
    return {name: _solve(mesh, name) for name in SOLVES}


def task_one_rank(mesh):
    """On a one-rank subgroup of rank 0: a distributed solve equals the
    solve without a mesh bit for bit (the fused mixed DIA case and the
    phased mixed CSR case)."""
    import torch
    import torch.distributed as dist

    from gcge_tpu_torch import GCGParams, gcg_solve
    from gcge_tpu_torch.parallel import row_mesh, shard_operator

    sub = dist.new_group([0])     # every rank takes part in new_group
    if mesh.rank != 0:
        return {}
    one = row_mesh(sub, device="cpu")
    out = {"world": one.world}
    for name in ("dia_std_mixed_fused", "csr_std_mixed_phased"):
        matrix, _, kw, k = SOLVES[name]
        rows, cols, vals, n, _ = solve_problem(matrix)
        op = _port_operator("csr" if matrix == "delaunay" else "dia", rows,
                            cols, vals, n)
        x0 = x0_for(n, k)
        p = GCGParams(verbose=0, **kw)
        plain = gcg_solve(op, None, p, x0=x0)
        dist_ = gcg_solve(shard_operator(op, one), None, p, x0=x0, mesh=one)
        out[name] = (np.array_equal(plain.eval, dist_.eval)
                     and torch.equal(plain.evec, dist_.evec)
                     and plain.num_iter == dist_.num_iter
                     and plain.nev_conv == dist_.nev_conv)
    # eigh_newton (both outputs) and GCG with its Rayleigh-Ritz
    m, nblk = NEWTON_CASES["m190_nblk63"]
    plain = newton_eigh(None, m, nblk)
    runs = [newton_eigh(one, m, nblk, out) for out in ("replicated", "cols")]
    out["eigh_newton"] = (all(np.array_equal(plain[k], r[k]) for k in "wu"
                              for r in runs)
                          and runs[0]["gathers"] > 0
                          and runs[0]["cols"].keys() == {m})
    plain, dist_ = (newton_gcg(msh, "struct_fused")[0] for msh in (None, one))
    out["gcg_newton"] = (np.array_equal(plain.eval, dist_.eval)
                         and torch.equal(plain.evec, dist_.evec)
                         and plain.num_iter == dist_.num_iter
                         and plain.nev_conv == dist_.nev_conv)
    return out


def task_api_solve(mesh):
    """``solve(distribute=True, rcm=True)`` of the Delaunay matrix in its
    mesh order (every rank gets the full eigenvectors)."""
    import scipy.sparse as sps
    import torch

    import gcge_tpu_torch
    from gcge_tpu_torch.io.fem import assemble_p1, random_delaunay_mesh

    rows, cols, vals, _, n = assemble_p1(*random_delaunay_mesh(10 ** 3,
                                                                seed=1))
    a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    ev, evec, conv = gcge_tpu_torch.solve(
        a, None, nev=6, device="cpu", rcm=True, distribute=True,
        block_size=3, max_iter=150, verbose=0, x0=x0_for(n, 12))
    assert isinstance(evec, torch.Tensor)
    return {"eval": ev, "evec": evec.numpy(), "nev_conv": conv}


def task_host_blocks(mesh):
    """``dia_from_host_blocks``, ``csr_from_host_blocks`` and
    ``mv_from_host_blocks``: each rank builds only its rows; a solve on the
    DIA operator (the 1-D Laplacian, n=256, ``tests/test_multiproc.py``'s
    problem) and the rows of both operators' products."""
    import torch

    from gcge_tpu_torch import GCGParams, gcg_solve
    from gcge_tpu_torch.ops.onehot import pack_csr
    from gcge_tpu_torch.parallel import (csr_from_host_blocks,
                                         dia_from_host_blocks,
                                         mv_from_host_blocks)

    n = 256
    rows, cols, vals, _ = laplacian_1d(n)
    r0, ln = mesh.block(n)
    # this rank's rows only: no rank holds the global matrix.  The DIA
    # value rows: the global offsets, values by local row
    mine = (rows >= r0) & (rows < r0 + ln)
    offs = (-1, 0, 1)
    local_vals = np.zeros((3, ln))
    for d, off in enumerate(offs):
        sel = mine & (cols - rows == off)
        local_vals[d, rows[sel] - r0] = vals[sel]
    dia_op = dia_from_host_blocks(mesh, local_vals, offs, n)
    rowptr, colidx, cvals = pack_csr(rows[mine] - r0, cols[mine],
                                     vals[mine], (ln, n))
    csr_op = csr_from_host_blocks(mesh, rowptr, colidx, cvals, n)
    x = mv_from_host_blocks(mesh, block(n, 3, 7)[r0:r0 + ln], n)
    res = gcg_solve(dia_op, None, GCGParams(nev=4, block_size=2,
                                            tol_rel=1e-9, verbose=0),
                    mesh=mesh)
    return {"eval": res.eval, "nev_conv": res.nev_conv,
            "y_dia": dia_op.matvec(x).numpy(),
            "y_csr": csr_op.matvec(x).numpy(),
            "csr_halo": (csr_op.hl, csr_op.hr, csr_op.gather),
            "x_type": type(x).__name__}


def _mg_hierarchy(mesh):
    """The 1-D Laplacian's hierarchy, undistributed and sharded."""
    from gcge_tpu_torch.parallel import shard_hierarchy
    from gcge_tpu_torch.solvers.multigrid import build_hierarchy

    rows, cols, vals = lap_coo(MG_N)
    hier = build_hierarchy(rows, cols, vals, MG_N, max_levels=MG_LEVELS,
                           device="cpu")
    return hier, shard_hierarchy(hier, mesh)


def task_mg_transfers(mesh):
    """The sharded transfers' products on fixed blocks, the coarse
    correction of one restricted residual (replicated levels only), and
    ``bamg_solve`` with the CG and the Chebyshev smoother on the sharded
    hierarchy, beside the undistributed cycle count."""
    import scipy.sparse as sps
    import torch

    from gcge_tpu_torch.parallel import shard_rows
    from gcge_tpu_torch.solvers.multigrid import _vcycle, bamg_solve

    hier, hd = _mg_hierarchy(mesh)
    lv0 = hd.levels[0]
    n_c = lv0.p_op.shape[1]
    out = {"types": (type(lv0.p_op).__name__, type(lv0.r_op).__name__),
           "shapes": (lv0.p_op.shape, lv0.r_op.shape,
                      lv0.p_op.local.shape, lv0.r_op.local.shape),
           "mesh_levels": [hd.mesh_at(i) is not None
                           for i in range(hd.num_levels)]}
    out["prolong"] = lv0.p_op.matvec(torch.as_tensor(block(n_c, 3, 8))) \
        .numpy()
    fine = shard_rows(mesh, torch.as_tensor(block(MG_N, 3, 9)))
    r_c = lv0.r_op.matvec(fine)
    out["restrict"] = r_c.numpy()
    e_c = _vcycle(hd.sub(1), 0, r_c, torch.zeros_like(r_c), (4, 4, 4, 4),
                  100, 1e-16, 1e-13)
    out["coarse_correction"] = e_c.numpy()
    rows, cols, vals = lap_coo(MG_N)
    a = sps.coo_matrix((vals, (rows, cols)), shape=(MG_N, MG_N)).tocsr()
    b = torch.as_tensor(a @ block(MG_N, 4, 42))
    for smoother, cycles in (("cg", 25), ("chebyshev", 30)):
        x, it, rel = bamg_solve(hd, shard_rows(mesh, b), max_cycles=cycles,
                                rtol=1e-10, smoother=smoother)
        out[smoother] = {"x": x.numpy(), "cycles": it,
                         "rel": float(rel.max())}
    _, it0, _ = bamg_solve(hier, b, max_cycles=25, rtol=1e-10)
    out["cg_undistributed_cycles"] = it0
    return out


def task_mg_gcg(mesh):
    """GCG on the sharded DIA operator with ``bamg_preconditioner`` of the
    sharded hierarchy as ``linear_precond``."""
    from gcge_tpu_torch import GCGParams, gcg_solve, make_operator
    from gcge_tpu_torch.parallel import shard_operator
    from gcge_tpu_torch.solvers.multigrid import bamg_preconditioner

    _, hd = _mg_hierarchy(mesh)
    rows, cols, vals = lap_coo(MG_N)
    op = make_operator(rows, cols, vals, (MG_N, MG_N), device="cpu")
    params = GCGParams(verbose=0, linear_precond=bamg_preconditioner(hd),
                       **MG_GCG)
    res = gcg_solve(shard_operator(op, mesh), None, params,
                    x0=x0_for(MG_N, MG_GCG_X0), mesh=mesh)
    return {"eval": res.eval, "nev_conv": res.nev_conv,
            "num_iter": res.num_iter, "kind": shard_operator(op, mesh).kind}


def task_pas(mesh):
    """``pas_solve`` on the sharded hierarchy, plain and composite: each
    rank's eigenvalues, levels' histories, sweeps, count and rows."""
    from gcge_tpu_torch.solvers.pas import pas_solve

    _, hd = _mg_hierarchy(mesh)
    out = {}
    for name, kw in PAS_CASES.items():
        res = pas_solve(hd, PAS_NEV, verbose=0, **kw)
        out[name] = {"eval": res.eval, "nev_conv": res.nev_conv,
                     "sweeps": res.sweeps, "history": res.level_history,
                     "evec": res.evec.numpy()}
    return out


def task_mg_one_rank(mesh):
    """On a one-rank subgroup of rank 0: the sharded hierarchy gives the
    undistributed one's bits, in GCG with the V-cycle preconditioner and in
    ``pas_solve`` (plain and composite)."""
    import torch
    import torch.distributed as dist

    from gcge_tpu_torch import GCGParams, gcg_solve, make_operator
    from gcge_tpu_torch.parallel import (row_mesh, shard_hierarchy,
                                         shard_operator)
    from gcge_tpu_torch.solvers.multigrid import (bamg_preconditioner,
                                                  build_hierarchy)
    from gcge_tpu_torch.solvers.pas import pas_solve

    sub = dist.new_group([0])     # every rank takes part in new_group
    if mesh.rank != 0:
        return {}
    one = row_mesh(sub, device="cpu")
    rows, cols, vals = lap_coo(MG_N)
    hier = build_hierarchy(rows, cols, vals, MG_N, max_levels=MG_LEVELS,
                           device="cpu")
    hd = shard_hierarchy(hier, one)
    op = make_operator(rows, cols, vals, (MG_N, MG_N), device="cpu")
    x0 = x0_for(MG_N, MG_GCG_X0)
    runs = [gcg_solve(op, None, GCGParams(
        verbose=0, linear_precond=bamg_preconditioner(hier), **MG_GCG),
        x0=x0),
        gcg_solve(shard_operator(op, one), None, GCGParams(
            verbose=0, linear_precond=bamg_preconditioner(hd), **MG_GCG),
            x0=x0, mesh=one)]
    out = {"amg": (np.array_equal(runs[0].eval, runs[1].eval)
                   and torch.equal(runs[0].evec, runs[1].evec)
                   and runs[0].num_iter == runs[1].num_iter
                   and runs[0].nev_conv == runs[1].nev_conv)}
    for name, kw in PAS_CASES.items():
        plain, sharded = (pas_solve(h, PAS_NEV, verbose=0, **kw)
                          for h in (hier, hd))
        out[name] = (np.array_equal(plain.eval, sharded.eval)
                     and torch.equal(plain.evec, sharded.evec)
                     and plain.sweeps == sharded.sweeps
                     and plain.nev_conv == sharded.nev_conv)
    return out


def task_hybrid_mesh(mesh):
    """``hybrid_row_mesh`` against ``row_mesh``: rank, world, peers."""
    from gcge_tpu_torch.parallel import hybrid_row_mesh, row_mesh

    hm, rm = hybrid_row_mesh(device="cpu"), row_mesh(device="cpu")
    return {"hybrid": (hm.rank, hm.world, hm.peers),
            "row": (rm.rank, rm.world, rm.peers)}


def task_mg_api(mesh):
    """``solve(distribute=True)`` with ``multigrid`` and ``method="pas"``
    (:data:`API_MG`): eigenvalues, count and the full eigenvectors."""
    import gcge_tpu_torch

    out = {}
    for name, (matrix, kw, k) in API_MG.items():
        a, b = api_matrices(matrix)
        x0 = None if k is None else x0_for(a.shape[0], k)
        ev, evec, conv = gcge_tpu_torch.solve(
            a, b, device="cpu", distribute=True, verbose=0, x0=x0, **kw)
        out[name] = {"eval": ev, "nev_conv": conv, "evec": evec.numpy()}
    return out


def task_divisibility(mesh):
    """``solve(distribute=True)`` of the 1-D Laplacian at n=511 on two
    ranks, with ``multigrid`` and with ``method="pas"``: the messages of the
    errors raised (None where nothing raised)."""
    import scipy.sparse as sps

    import gcge_tpu_torch

    rows, cols, vals = lap_coo(511)
    a = sps.coo_matrix((vals, (rows, cols)), shape=(511, 511)).tocsr()
    out = {}
    for name, kw in (("multigrid", dict(multigrid=3)),
                     ("pas", dict(method="pas"))):
        try:
            gcge_tpu_torch.solve(a, None, nev=2, device="cpu",
                                 distribute=True, verbose=0, **kw)
            out[name] = None
        except ValueError as exc:
            out[name] = str(exc)
    return out


# the 2-D grid: the 1-D Laplacian of tests/test_dist.py's grid cases (n=512,
# products on block(512, 6, 7), GCG with nev=8, block 4, tol_rel 1e-9, from
# x0_for(512, GRID_X0)), by operator and loop; and the mixed fused case of
# SOLVES, which runs the f32 CG stage on a grid
GRID_N, GRID_M = 512, 6
GRID_GCG = dict(nev=8, block_size=4, tol_rel=1e-9)
GRID_X0 = 16
GRID_SOLVES = {
    "dia_phased": ("dia", dict(fuse=0)),
    "csr_fused": ("csr", dict(fuse=4)),
    # column-wise Gram-Schmidt on the whole W block, and cg_order=2, whose
    # second stage continues the first stage's columns (the grid solves for
    # the whole W block there)
    "dia_mgs_order2_phased": ("dia", dict(fuse=0, orth_method="mgs",
                                          cg_order=2)),
}
GRID_CASES = tuple(GRID_SOLVES) + ("dia_std_mixed_fused",)
# the case of SOLVES that also runs on a (4, 1) grid, against the row mesh's
# solve of the "solves" task
GRID_TALL_CASE = "dia_std_mixed_fused"
# the one-call grid cases (the cube FEM pair at nx=9): solve keywords, x0
# columns
API_GRID = {
    "fem_plain": (dict(nev=4, block_size=2), 8),
    "fem_amg": (dict(nev=4, block_size=2, multigrid=3), 8),
}
# pcg's case: the 1-D Laplacian at n=512 against the right-hand side
# block(512, 1, 42)
PCG_KW = dict(max_iter=200, rate=1e-12, tol=1e-10)


def grid_operator(kind: str):
    rows, cols, vals, _ = laplacian_1d(GRID_N)
    return _port_operator(kind, rows, cols, vals, GRID_N)


def _grid_solve(mesh, name):
    """The GCG case ``name`` of :data:`GRID_CASES` on ``mesh`` (a grid or a
    row mesh): eigenvalues, counts, the whole eigenvectors, the widths of
    the sharded products and the shape of the rank's part of V."""
    from gcge_tpu_torch import GCGParams, gcg_solve
    from gcge_tpu_torch.ops.multivec import gather_cols
    from gcge_tpu_torch.parallel import dist_ops, gather_rows, shard_operator

    if name in SOLVES:
        matrix, _, kw, k = SOLVES[name]
        rows, cols, vals, n, _ = solve_problem(matrix)
        op = _port_operator("dia", rows, cols, vals, n)
    else:
        kind, kw = GRID_SOLVES[name]
        op, kw, n, k = grid_operator(kind), dict(GRID_GCG, **kw), GRID_N, \
            GRID_X0
    dist_ops.WIDTHS.clear()
    res = gcg_solve(shard_operator(op, mesh), None,
                    GCGParams(verbose=0, **kw), x0=x0_for(n, k), mesh=mesh)
    whole = gather_rows(mesh, gather_cols(res.evec, mesh))
    return {"eval": res.eval, "nev_conv": res.nev_conv,
            "num_iter": res.num_iter, "evec": whole.numpy(),
            "evec_local": tuple(res.evec.shape),
            "widths": dict(dist_ops.WIDTHS),
            "held": dist_ops.HELD["basis"], "evec_t": whole}


def task_grid(mesh):
    """The (2, 2) grid: each rank's coordinates and groups; the sharded DIA
    and CSR products on the rank's columns, gathered whole; GCG on both
    loops (:data:`GRID_CASES`); :data:`GRID_TALL_CASE` on a (4, 1) grid;
    ``pcg(mesh=)`` on the row mesh."""
    import torch
    import torch.distributed as dist

    from gcge_tpu_torch.ops.multivec import gather_cols, own_cols
    from gcge_tpu_torch.parallel import (gather_rows, grid_mesh,
                                         shard_operator, shard_rows)
    from gcge_tpu_torch.solvers.bpcg import pcg

    grid = grid_mesh(2, 2, device="cpu")
    tall = grid_mesh(4, 1, device="cpu")
    out = {"coords": (grid.rank, grid.col, grid.n_rows, grid.n_cols),
           "row_group": grid.peers,
           "col_group": tuple(dist.get_process_group_ranks(grid.cols)),
           "tall_coords": (tall.rank, tall.col, tall.peers)}
    x = torch.as_tensor(block(GRID_N, GRID_M, 7))
    for kind in ("dia", "csr"):
        op = shard_operator(grid_operator(kind), grid)
        xl = own_cols(shard_rows(grid, x), grid)
        y = op.matvec(xl)
        out[f"{kind}_local"] = tuple(y.shape)
        out[kind] = gather_rows(grid, gather_cols(y, grid)).numpy()
    for name in GRID_CASES:
        out[name] = _grid_solve(grid, name)
        out[name].pop("evec_t")
    out["tall"] = _solve(tall, GRID_TALL_CASE)
    a_op = grid_operator("dia")
    b = torch.as_tensor(block(GRID_N, 1, 42))[:, 0]
    op = shard_operator(a_op, mesh)
    xr, info = pcg(op.matvec, shard_rows(mesh, b),
                   torch.zeros(GRID_N // mesh.world, dtype=b.dtype),
                   mesh=mesh, **PCG_KW)
    out["pcg"] = gather_rows(mesh, xr).numpy()
    out["pcg_iters"] = info.niters
    return out


def task_grid_pas(mesh):
    """``pas_solve`` (the "plain" case of :data:`PAS_CASES`) on the
    hierarchy sharded over a (2, 2) grid: eigenvalues, sweeps, count and the
    rank's rows of the eigenvectors."""
    from gcge_tpu_torch.parallel import grid_mesh, shard_hierarchy
    from gcge_tpu_torch.solvers.multigrid import build_hierarchy
    from gcge_tpu_torch.solvers.pas import pas_solve

    grid = grid_mesh(2, 2, device="cpu")
    rows, cols, vals = lap_coo(MG_N)
    hier = build_hierarchy(rows, cols, vals, MG_N, max_levels=MG_LEVELS,
                           device="cpu")
    res = pas_solve(shard_hierarchy(hier, grid), PAS_NEV, verbose=0,
                    **PAS_CASES["plain"])
    return {"eval": res.eval, "nev_conv": res.nev_conv, "sweeps": res.sweeps,
            "evec": res.evec.numpy(), "coords": (grid.rank, grid.col)}


def task_grid_api(mesh):
    """``solve(distribute="grid")`` of the cube FEM pair at nx=9
    (:data:`API_GRID`): on four ranks a (2, 2) grid."""
    import gcge_tpu_torch

    a, b = api_matrices("fem9")
    out = {}
    for name, (kw, k) in API_GRID.items():
        ev, evec, conv = gcge_tpu_torch.solve(
            a, b, device="cpu", distribute="grid", verbose=0,
            x0=x0_for(a.shape[0], k), **kw)
        out[name] = {"eval": ev, "nev_conv": conv, "evec": evec.numpy()}
    return out


def task_grid_two(mesh):
    """Two ranks: ``solve(distribute="grid")`` is ``distribute=True`` there
    (gcge_tpu falls back to the row mesh), bit for bit; ``pcg`` on a
    one-rank subgroup of rank 0 is the undistributed ``pcg``, bit for
    bit."""
    import torch
    import torch.distributed as dist

    import gcge_tpu_torch
    from gcge_tpu_torch.parallel import row_mesh
    from gcge_tpu_torch.solvers.bpcg import pcg

    a, b = api_matrices("fem9")
    kw, k = API_GRID["fem_plain"]
    runs = [gcge_tpu_torch.solve(a, b, device="cpu", distribute=how,
                                 verbose=0, x0=x0_for(a.shape[0], k), **kw)
            for how in ("grid", True)]
    out = {"grid_is_rows": (np.array_equal(runs[0][0], runs[1][0])
                            and torch.equal(runs[0][1], runs[1][1])
                            and runs[0][2] == runs[1][2])}
    sub = dist.new_group([0])     # every rank takes part in new_group
    if mesh.rank == 0:
        one = row_mesh(sub, device="cpu")
        a_op = grid_operator("dia")
        b_vec = torch.as_tensor(block(GRID_N, 1, 42))[:, 0]
        x0 = torch.zeros(GRID_N, dtype=b_vec.dtype)
        plain = pcg(a_op.matvec, b_vec, x0, **PCG_KW)
        from gcge_tpu_torch.parallel import shard_operator

        sharded = pcg(shard_operator(a_op, one).matvec, b_vec, x0, mesh=one,
                      **PCG_KW)
        out["pcg_one_rank"] = (torch.equal(plain[0], sharded[0])
                               and plain[1].niters == sharded[1].niters)
    return out


# the partitioned eigh_newton: tests/test_dist.py's sharded case (m=192, a
# degenerate cluster at 40-43, a warm start 3e-7 off) and the same at an m
# and a block count (nblk) that four ranks do not divide: name -> (m, nblk)
NEWTON_CASES = {"m192": (192, None), "m190_nblk63": (190, 63)}
# GCG with the 'newton' Rayleigh-Ritz (tests/test_dist.py's case): the 1-D
# Laplacian at n=512 from x0_for(512, NEWTON_GCG_X0); name -> (rr_warm,
# fuse)
NEWTON_GCG = dict(nev=5, block_size=3, tol_rel=1e-8, rr_backend="newton")
NEWTON_GCG_X0 = 10
NEWTON_SOLVES = {"cold_phased": ("off", 0), "struct_fused": ("struct", 5)}


@functools.lru_cache(maxsize=None)
def newton_case(m: int):
    """``(h, w0, u0)``: ``tests/test_dist.py``'s sharded eigh case at order
    ``m`` (its ``rng`` is ``default_rng(42)``): eigenvalues uniform in [0.5,
    50] with 40-43 equal, and the warm start's eigenvectors 3e-7 off."""
    rng = np.random.default_rng(42)
    lam = np.sort(rng.uniform(0.5, 50.0, m))
    lam[40:44] = lam[40]
    q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    h = q * lam[None, :] @ q.T
    h = 0.5 * (h + h.T)
    w0, u0 = np.linalg.eigh(h)
    u0 = u0 + 3e-7 * rng.standard_normal((m, m)) * np.abs(lam).max() ** 0.5
    return h, w0, u0


def newton_eigh(mesh, m: int, nblk, out: str = "replicated"):
    """``eigh_newton`` of :func:`newton_case` on ``mesh`` (None: without
    one): ``(w, u)`` as numpy, the collectives and the widths it ran on."""
    import torch

    from gcge_tpu_torch.ops import eighs

    h, w0, u0 = (torch.as_tensor(a) for a in newton_case(m))
    eighs.NEWTON.update(gathers=0, broadcasts=0)
    for widths in eighs.SPLIT.values():
        widths.clear()
    w, u = eighs.eigh_newton(h, warm=(w0, u0), nblk=nblk, mesh=mesh,
                             out=out)
    return {"w": w.numpy(), "u": u.numpy(),
            "gathers": eighs.NEWTON["gathers"],
            "broadcasts": eighs.NEWTON["broadcasts"],
            "cols": dict(eighs.SPLIT["cols"]),
            "blocks": dict(eighs.SPLIT["blocks"])}


def newton_gcg(mesh, name: str):
    """GCG with the 'newton' Rayleigh-Ritz (:data:`NEWTON_SOLVES`) of the
    1-D Laplacian on ``mesh`` (None: without one): the result, the widths
    its Newton eighs ran on and, for each Rayleigh-Ritz step that offered
    the structural warm start, whether it was taken (its premise)."""
    from gcge_tpu_torch import GCGParams, gcg_solve
    from gcge_tpu_torch.ops import eighs
    from gcge_tpu_torch.parallel import shard_operator
    from gcge_tpu_torch.solvers import gcg

    warm, fuse = NEWTON_SOLVES[name]
    op = grid_operator("dia")
    for widths in eighs.SPLIT.values():
        widths.clear()
    taken, struct_warm = [], gcg._rr_struct_warm

    def counted(*args):
        got = struct_warm(*args)
        taken.append(bool(got[3]))
        return got

    gcg._rr_struct_warm = counted
    try:
        res = gcg_solve(op if mesh is None else shard_operator(op, mesh),
                        None, GCGParams(verbose=0, rr_warm=warm, fuse=fuse,
                                        **NEWTON_GCG),
                        x0=x0_for(GRID_N, NEWTON_GCG_X0), mesh=mesh)
    finally:
        gcg._rr_struct_warm = struct_warm
    return res, dict(eighs.SPLIT["cols"]), taken


def task_newton(mesh):
    """The partitioned ``eigh_newton`` of each :data:`NEWTON_CASES` case on
    the row mesh of the group and, on four ranks, the (2, 2) grid:
    ``out='replicated'`` with its counters, and ``out='cols'``."""
    from gcge_tpu_torch.parallel import grid_mesh

    meshes = {"rows": mesh}
    if mesh.world == 4:
        meshes["grid"] = grid_mesh(2, 2, device="cpu")
    out = {}
    for kind, msh in meshes.items():
        for name, (m, nblk) in NEWTON_CASES.items():
            got = newton_eigh(msh, m, nblk)
            got["u_cols"] = newton_eigh(msh, m, nblk, out="cols")["u"]
            out[kind, name] = got
    return out


def task_newton_gcg(mesh):
    """GCG with the 'newton' Rayleigh-Ritz on the row mesh, cold (phased)
    and with the structural warm start (fused): eigenvalues, counts, the
    rank's rows of the eigenvectors and the widths of the Newton eighs'
    products."""
    out = {}
    for name in NEWTON_SOLVES:
        res, cols, taken = newton_gcg(mesh, name)
        out[name] = {"eval": res.eval, "nev_conv": res.nev_conv,
                     "num_iter": res.num_iter, "evec": res.evec.numpy(),
                     "cols": cols, "warm_taken": taken}
    return out


def struct_warm_case(size_x: int, bs: int, coupling: float):
    """A projected matrix of the Rayleigh-Ritz step's shape, ``size_x + 2
    bs`` square: the X block diag(1..6), a symmetric trailing block with
    eigenvalues in [7, 12] and an X-trailing coupling of entries
    ``coupling`` times normal; the structural warm start's premise holds at
    1e-6 and fails at 1."""
    rng = np.random.default_rng(11)
    k = 2 * bs
    q, _ = np.linalg.qr(rng.standard_normal((k, k)))
    h = np.zeros((size_x + k, size_x + k))
    h[:size_x, :size_x] = np.diag(np.linspace(1.0, 6.0, size_x))
    h[size_x:, size_x:] = q * np.linspace(7.0, 12.0, k) @ q.T
    c = coupling * rng.standard_normal((size_x, k))
    h[:size_x, size_x:], h[size_x:, :size_x] = c, c.T
    return 0.5 * (h + h.T)


def task_struct_warm_flag(mesh):
    """``_rr_struct_warm`` on a projected matrix whose premise holds on
    rank 0 only (the other ranks' X-W coupling is large), on the row mesh
    and the (2, 2) grid: each rank's premise without a mesh and under it,
    then the Newton eigh of the branch each rank takes (the warm one under
    a mesh, whose collectives the cold one does not run)."""
    import torch

    from gcge_tpu_torch.ops.eighs import eigh
    from gcge_tpu_torch.parallel import grid_mesh
    from gcge_tpu_torch.solvers import gcg

    size_x, bs = 6, 3
    h = torch.as_tensor(struct_warm_case(size_x, bs,
                                         1e-6 if mesh.rank == 0 else 1.0))
    out = {"alone": bool(gcg._rr_struct_warm(h, size_x, bs)[3])}
    for kind, msh in (("rows", mesh), ("grid", grid_mesh(2, 2,
                                                         device="cpu"))):
        d0, u0, h1, ok = gcg._rr_struct_warm(h, size_x, bs, msh)
        if ok:
            w, u = eigh(h, "newton", msh, warm=(d0, u0), warm_h1=h1,
                        cluster_first=False)
        else:
            w, u = eigh(h, "newton", msh)
        out[kind] = {"ok": bool(ok), "w": w.numpy(), "u": u.numpy()}
    return out


CLI_NX, CLI_NEV = 8, 6      # n = 512: four blocks of 128 rows


def cli_inputs(outdir: str, tag: str):
    """The command line's input files in ``outdir``: the 27-point stencil
    at ``CLI_NX`` as MatrixMarket and a seeded starting block of
    ``2 CLI_NEV`` vectors as a checkpoint; and the flags of the driver
    runs, without ``-mesh``."""
    import scipy.io
    import scipy.sparse as sps

    from gcge_tpu_torch.io.stencil import build_3d27
    from gcge_tpu_torch.utils.checkpoint import save_checkpoint

    rows, cols, vals, n = build_3d27(CLI_NX)
    mtx = os.path.join(outdir, f"cli_{tag}.mtx")
    ck = os.path.join(outdir, f"cli_x0_{tag}.npz")
    scipy.io.mmwrite(mtx, sps.coo_matrix((vals, (rows, cols)), shape=(n, n)))
    x0 = np.random.default_rng(7).standard_normal((n, 2 * CLI_NEV))
    save_checkpoint(ck, SimpleNamespace(eval=np.zeros(2 * CLI_NEV), evec=x0,
                                        nev_conv=0, num_iter=0))
    return ["-filename_matA", mtx, "-resume", ck, "-device", "cpu",
            "-nevConv", str(CLI_NEV), "-blockSize", "3",
            "-gcge_print_conv", "0", "-gcge_print_evec", "1"]


def task_cli(mesh):
    """``gcge_tpu_torch.utils.cli.main(... -mesh 1)`` on every rank: the
    result and what the rank printed."""
    import contextlib
    import io
    import tempfile

    from gcge_tpu_torch.utils import cli

    printed = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(printed):
        res = cli.main(cli_inputs(tmp, f"rank{mesh.rank}") + ["-mesh", "1"])
    return {"eval": res.eval, "nev_conv": res.nev_conv,
            "num_iter": res.num_iter, "evec": res.evec.numpy(),
            "stdout": printed.getvalue()}


TASKS = {
    "four": {"matvecs": task_matvecs, "solves": task_solves,
             "one_rank": task_one_rank, "mg_transfers": task_mg_transfers,
             "mg_gcg": task_mg_gcg, "pas": task_pas,
             "mg_one_rank": task_mg_one_rank,
             "hybrid_mesh": task_hybrid_mesh, "grid": task_grid,
             "grid_pas": task_grid_pas, "grid_api": task_grid_api,
             "cli": task_cli, "newton": task_newton,
             "newton_gcg": task_newton_gcg,
             "struct_warm_flag": task_struct_warm_flag},
    "two": {"api_solve": task_api_solve, "host_blocks": task_host_blocks,
            "divisibility": task_divisibility, "mg_api": task_mg_api,
            "grid_two": task_grid_two, "newton": task_newton},
}


# ---------------------------------------------------------------------------
# the ranks and their launcher
# ---------------------------------------------------------------------------


def run(rank: int, group: str, port: int, outdir: str) -> None:
    """One rank: join the gloo group through ``multihost.bootstrap``, run
    the group's tasks in order, write each result."""
    import torch

    torch.set_num_threads(1)
    from gcge_tpu_torch.parallel import bootstrap, row_mesh

    world = WORLD[group]
    bootstrap(f"tcp://127.0.0.1:{port}", world, rank, "cpu")
    mesh = row_mesh(device="cpu")
    for name, fn in TASKS[group].items():
        path = os.path.join(outdir, f"{group}_{name}_{rank}.pkl")
        t0 = time.perf_counter()
        try:
            result = {"ok": fn(mesh)}
        except Exception:                 # reported by the test, rank ends
            with open(path, "wb") as f:
                pickle.dump({"error": traceback.format_exc()}, f)
            os._exit(1)
        result["seconds"] = time.perf_counter() - t0
        with open(path, "wb") as f:
            pickle.dump(result, f)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(group: str, outdir: str):
    """Start the ranks of ``group`` (``spawn``: fresh interpreters that
    import this module and the port only)."""
    import torch.multiprocessing as tmp

    ctx = tmp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=run, args=(r, group, port, outdir))
             for r in range(WORLD[group])]
    # one OpenBLAS thread a rank (read when a rank imports numpy): the ranks
    # share the cores, and numpy's threads would spin against each other
    blas = os.environ.get("OPENBLAS_NUM_THREADS")
    os.environ["OPENBLAS_NUM_THREADS"] = "1"
    try:
        for p in procs:
            p.start()
    finally:
        if blas is None:
            del os.environ["OPENBLAS_NUM_THREADS"]
        else:
            os.environ["OPENBLAS_NUM_THREADS"] = blas
    return procs


def finish(procs, timeout: float) -> list[int]:
    """Wait for the ranks at most ``timeout`` seconds in all, kill those
    still running (a rank stuck in a collective) and return the exit
    codes (``None``: killed)."""
    deadline = time.monotonic() + timeout
    codes = []
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes


def result(outdir: str, group: str, task: str) -> list[dict]:
    """The results of ``task`` by rank; raises with the first rank's
    traceback where a rank failed or wrote nothing."""
    out = []
    for rank in range(WORLD[group]):
        path = os.path.join(outdir, f"{group}_{task}_{rank}.pkl")
        if not os.path.exists(path):
            raise AssertionError(f"rank {rank} wrote no result for {task} "
                                 f"(it died or hung in an earlier task)")
        with open(path, "rb") as f:
            got = pickle.load(f)
        if "error" in got:
            raise AssertionError(f"rank {rank}, task {task}:\n"
                                 f"{got['error']}")
        out.append(got["ok"])
    return out
