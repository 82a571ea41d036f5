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

import os
import pickle
import socket
import time
import traceback

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
    from gcge_tpu_torch.parallel import pad_problem, shard_operator

    matrix, _, kw, k = SOLVES[name]
    rows, cols, vals, n, b = solve_problem(matrix)
    kind = "csr" if matrix == "delaunay" else "dia"
    a_op = _port_operator(kind, rows, cols, vals, n)
    b_op = None if b is None else DiagOperator(torch.as_tensor(b))
    a_pad, b_pad, _ = pad_problem(a_op, b_op, mesh.world)
    x0 = np.zeros((a_pad.shape[0], k))
    x0[:n] = x0_for(n, k)
    res = gcg_solve(shard_operator(a_pad, mesh), shard_operator(b_pad, mesh),
                    GCGParams(verbose=0, **kw), x0=x0, mesh=mesh)
    return {"eval": res.eval, "nev_conv": res.nev_conv,
            "num_iter": res.num_iter, "evec_rows": res.evec.shape[0]}


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


TASKS = {
    "four": {"matvecs": task_matvecs, "solves": task_solves,
             "one_rank": task_one_rank},
    "two": {"api_solve": task_api_solve, "host_blocks": task_host_blocks},
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
    for p in procs:
        p.start()
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
