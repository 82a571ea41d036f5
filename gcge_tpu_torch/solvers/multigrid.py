"""Multigrid: smoothed-aggregation hierarchy, inter-level transfers, block
AMG V-cycles — the counterpart of ``gcge_tpu/solvers/multigrid.py``.

The set-up runs on the host in numpy/scipy, as ``gcge_tpu``'s does (a copy
of its scipy half): greedy strength-based aggregation, a tentative
piecewise-constant prolongator smoothed by one damped-Jacobi pass, Galerkin
coarse operators ``A_c = P^T A P`` (and ``B_c = P^T B P``), and a power
iteration per level for the Chebyshev smoother.  Each level's A and B are
then placed on ``device`` by :func:`~gcge_tpu_torch.ops.operators.make_operator`
(DIA, Hybrid or CSR), and the transfers P and R as
:class:`~gcge_tpu_torch.ops.onehot.CsrOperator`: ``make_operator`` places a
rectangular matrix as ELL, whose product is a Python loop of launches per
ELL column; the CSR product of a rectangular matrix is one launch of
kernel 6 on the card.  The product is the same.

The cycle runs eagerly on tensors.  Every CG inside it (the coarsest
level's solve and the CG smoother) runs its whole step budget
(``block_pcg(fixed=True)``): it gives the early-exit form's ``x`` and reads
nothing back to the host, so a V-cycle can be captured in a CUDA graph with
the f32 CG stage of GCG's mixed inner solve.

A hierarchy sharded over a row mesh (``parallel.dist_mg.shard_hierarchy``)
carries the mesh: level 0, and only level 0, holds the rank's rows, so its
smoother CG, its coarsest-level CG where it is the coarsest, and
:func:`bamg_solve`'s residual norms sum their column dots over the ranks.
The replicated coarse levels run no collective.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional, Sequence

import numpy as np
import scipy.sparse as sps
import torch

from gcge_tpu_torch.ops.multivec import col_dots
from gcge_tpu_torch.ops.onehot import CsrOperator
from gcge_tpu_torch.ops.operators import make_operator
from gcge_tpu_torch.solvers.bpcg import BlockPCGParams, block_pcg

if TYPE_CHECKING:
    from gcge_tpu_torch.parallel.mesh import RowMesh


@dataclass
class MGLevel:
    a_op: object                      # operator on this level
    p_op: Optional[object] = None     # prolongation to the FINER level (n_f x n_c)
    r_op: Optional[object] = None     # restriction = P^T  (n_c x n_f)
    b_op: Optional[object] = None     # projected mass matrix (generalized problems)
    dinv: Optional[torch.Tensor] = None   # 1/diag(A): Chebyshev scaling
    lam_max: Optional[float] = None   # upper bound on spec(D^-1 A)


@dataclass
class MGHierarchy:
    """``levels[0]`` is the finest (the original operator), ``levels[-1]``
    the coarsest.  ``setup``: host seconds of each level's set-up, as dicts
    (``aggregate``, ``galerkin``, ``place``), level 0 first.  ``mesh``: the
    row mesh over which level 0 is sharded (None: nothing is sharded)."""

    levels: list[MGLevel] = field(default_factory=list)
    setup: list[dict] = field(default_factory=list)
    mesh: Optional["RowMesh"] = None

    def mesh_at(self, level: int):
        """The mesh of ``level``'s vectors: ``mesh`` on level 0, else None
        (the coarser levels are replicated)."""
        return self.mesh if level == 0 else None

    def sub(self, level: int) -> "MGHierarchy":
        """The hierarchy from ``level`` down, with the mesh where it starts
        at level 0."""
        return MGHierarchy(levels=self.levels[level:],
                           mesh=self.mesh_at(level))

    @property
    def num_levels(self):
        return len(self.levels)


def _aggregate(a: sps.csr_matrix, theta: float) -> np.ndarray:
    """Greedy strength-of-connection aggregation; returns aggregate id/node."""
    n = a.shape[0]
    d = np.sqrt(np.abs(a.diagonal())) + 1e-300
    agg = -np.ones(n, dtype=np.int64)
    indptr, indices, data = a.indptr, a.indices, a.data
    n_agg = 0
    # pass 1: roots with all-unaggregated strong neighborhoods
    for i in range(n):
        if agg[i] >= 0:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        nbr = indices[sl]
        strong = nbr[np.abs(data[sl]) > theta * d[i] * d[nbr]]
        if (agg[strong] >= 0).any():
            continue
        agg[strong] = n_agg
        agg[i] = n_agg
        n_agg += 1
    # pass 2: attach leftovers to a strong aggregated neighbor (or own agg)
    for i in range(n):
        if agg[i] >= 0:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        nbr = indices[sl]
        cand = nbr[agg[nbr] >= 0]
        if len(cand):
            order = np.argsort(-np.abs(data[sl][agg[nbr] >= 0]))
            agg[i] = agg[cand[order[0]]]
        else:
            agg[i] = n_agg
            n_agg += 1
    return agg


def build_hierarchy(rows, cols, vals, n: int, b_vals=None,
                    max_levels: int = 4, min_coarse: int = 64,
                    theta: float = 0.08, omega: float = 2.0 / 3.0,
                    dtype=torch.float64, *, device="cuda") -> MGHierarchy:
    """Smoothed-aggregation set-up on the host; returns the hierarchy with
    every operator on ``device``.

    ``b_vals`` (on A's pattern) coarsens the mass matrix by the same Galerkin
    product.  Coarsening stops at ``max_levels``, at ``min_coarse`` rows, or
    when aggregation leaves every node its own aggregate."""
    device = torch.device(device)
    a = sps.coo_matrix((np.asarray(vals, np.float64),
                        (np.asarray(rows), np.asarray(cols))),
                       shape=(n, n)).tocsr()
    b = None
    if b_vals is not None:
        b = sps.coo_matrix((np.asarray(b_vals, np.float64),
                            (np.asarray(rows), np.asarray(cols))),
                           shape=(n, n)).tocsr()

    def dev(mat):
        coo = mat.tocoo()
        return make_operator(coo.row, coo.col, coo.data, mat.shape,
                             dtype=dtype, device=device)

    def transfer(row, col, data, shape):
        return CsrOperator.from_coo(row, col, data, shape, dtype=dtype,
                                    device=device)

    def cheb_data(mat):
        """1/diag and a power-iteration bound on spec(D^-1 A)."""
        dinv = 1.0 / np.maximum(np.abs(mat.diagonal()), 1e-300)
        v = np.random.default_rng(0).standard_normal(mat.shape[0])
        lam = 1.0
        for _ in range(20):
            v = dinv * (mat @ v)
            lam = np.linalg.norm(v)
            v /= max(lam, 1e-300)
        return torch.as_tensor(dinv, dtype=dtype, device=device), \
            float(1.1 * lam)

    def level(mat, b_mat):
        d, lam = cheb_data(mat)
        return MGLevel(a_op=dev(mat), b_op=None if b_mat is None
                       else dev(b_mat), dinv=d, lam_max=lam)

    hier = MGHierarchy()
    t0 = time.perf_counter()
    hier.levels.append(level(a, b))
    hier.setup.append({"aggregate": 0.0, "galerkin": 0.0,
                       "place": time.perf_counter() - t0})

    while hier.num_levels < max_levels and a.shape[0] > min_coarse:
        t0 = time.perf_counter()
        agg = _aggregate(a, theta)
        n_c = int(agg.max()) + 1
        if n_c >= a.shape[0]:  # aggregation stalled
            break
        t1 = time.perf_counter()
        p_tent = sps.csr_matrix(
            (np.ones(a.shape[0]), (np.arange(a.shape[0]), agg)),
            shape=(a.shape[0], n_c))
        colnorm = np.sqrt(np.asarray(p_tent.multiply(p_tent).sum(axis=0))
                          .ravel())
        p_tent = p_tent @ sps.diags(1.0 / np.maximum(colnorm, 1e-300))
        # one damped-Jacobi smoothing pass: P = (I - omega D^-1 A) P_tent
        dinv = sps.diags(1.0 / np.maximum(np.abs(a.diagonal()), 1e-300))
        p = ((sps.eye(a.shape[0]) - omega * (dinv @ a)) @ p_tent).tocsr()
        a_c = (p.T @ a @ p).tocsr()
        a_c.eliminate_zeros()
        if b is not None:
            b = (p.T @ b @ p).tocsr()
            b.eliminate_zeros()
        t2 = time.perf_counter()
        pc = p.tocoo()
        # the transfer lives on the FINER level's entry
        hier.levels[-1].p_op = transfer(pc.row, pc.col, pc.data, p.shape)
        hier.levels[-1].r_op = transfer(pc.col, pc.row, pc.data,
                                        (p.shape[1], p.shape[0]))
        a = a_c
        hier.levels.append(level(a, b))
        hier.setup.append({"aggregate": t1 - t0, "galerkin": t2 - t1,
                           "place": time.perf_counter() - t2})
    return hier


def multivec_from_i_to_j(hier: MGHierarchy, x: torch.Tensor, i: int,
                         j: int) -> torch.Tensor:
    """Move a multivector from level ``i`` to level ``j`` (0 = finest) by
    chained restrictions (to coarser levels) or prolongations (to finer
    ones)."""
    if i < j:
        for lvl in range(i, j):
            x = hier.levels[lvl].r_op.matvec(x)
    else:
        for lvl in range(i - 1, j - 1, -1):
            x = hier.levels[lvl].p_op.matvec(x)
    return x


def chebyshev_smooth(a_matvec, dinv, b, x, lam_max: float, k: int,
                     alpha: float = 4.0):
    """``k`` steps of Jacobi-preconditioned Chebyshev smoothing on
    ``A x = b``, aimed at the upper spectrum ``[lam_max/alpha, lam_max]`` of
    ``D^-1 A``.  No inner products: only products and elementwise work."""
    lmax = lam_max
    lmin = lam_max / alpha
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = b - a_matvec(x)
    d = (dinv[:, None] * r) / theta
    for _ in range(k - 1):
        x = x + d
        r = r - a_matvec(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (dinv[:, None] * r)
        rho = rho_new
    return x + d


def _smooth(lv, b, x, iters, rate, tol, smoother, mesh=None):
    if smoother == "chebyshev" and lv.dinv is not None and lv.lam_max:
        return chebyshev_smooth(lv.a_op.matvec, lv.dinv, b, x, lv.lam_max,
                                iters)
    params = BlockPCGParams(max_iter=iters, rate=rate, tol=tol, tol_type="abs")
    x, _ = block_pcg(lv.a_op.matvec, b, x, params, fixed=True, mesh=mesh)
    return x


def _vcycle(hier, level, b, x, smooth_iters, coarse_iters, rate, tol,
            smoother: str = "cg"):
    """One V-cycle from ``level`` down: smooth, restrict the residual,
    recurse, prolong the correction, smooth; the coarsest level solves by
    ``coarse_iters`` CG steps."""
    lv = hier.levels[level]
    mesh = hier.mesh_at(level)
    if level + 1 == hier.num_levels:
        params = BlockPCGParams(max_iter=coarse_iters, rate=rate, tol=tol,
                                tol_type="abs")
        x, _ = block_pcg(lv.a_op.matvec, b, x, params, fixed=True, mesh=mesh)
        return x
    iters = smooth_iters[min(level, len(smooth_iters) - 1)]
    x = _smooth(lv, b, x, iters, rate, tol, smoother, mesh)
    r = b - lv.a_op.matvec(x)
    r_c = lv.r_op.matvec(r)
    e_c = torch.zeros((r_c.shape[0], r_c.shape[1]), dtype=r_c.dtype,
                      device=r_c.device)
    e_c = _vcycle(hier, level + 1, r_c, e_c, smooth_iters, coarse_iters, rate,
                  tol, smoother)
    x = x + lv.p_op.matvec(e_c)
    return _smooth(lv, b, x, iters, rate, tol, smoother, mesh)


def bamg_solve(hier: MGHierarchy, b: torch.Tensor,
               x0: Optional[torch.Tensor] = None, max_cycles: int = 20,
               smooth_iters: Sequence[int] = (4, 4, 4, 4),
               coarse_iters: int = 100, rate: float = 1e-16,
               tol: float = 1e-13, rtol: float = 1e-8, level: int = 0,
               smoother: str = "cg"):
    """Block AMG: V-cycles until the largest column's relative residual is
    below ``rtol``, reading it back to the host once a cycle.
    ``smoother``: ``'cg'`` (block-CG smoothing) or ``'chebyshev'``.  On a
    sharded hierarchy ``b``, ``x0`` and ``x`` are the rank's rows.  Returns
    ``(x, cycles, rel_res)``."""
    a_op = hier.levels[level].a_op
    mesh = hier.mesh_at(level)
    x = torch.zeros_like(b) if x0 is None else x0
    nb = torch.clamp(torch.sqrt(col_dots(b, b, mesh)), min=1e-300)
    sub = hier.sub(level)
    si = tuple(smooth_iters)
    it, rel = 0, None
    for it in range(1, max_cycles + 1):
        x = _vcycle(sub, 0, b, x, si, coarse_iters, rate, tol, smoother)
        r = b - a_op.matvec(x)
        rel = torch.sqrt(col_dots(r, r, mesh)) / nb
        if float(rel.max()) < rtol:
            break
    return x, it, rel


def bamg_preconditioner(hier: MGHierarchy, cycles: int = 1,
                        smooth_iters: Sequence[int] = (2, 2, 2, 2),
                        coarse_iters: int = 30, smoother: str = "chebyshev"):
    """A V-cycle preconditioner ``R -> M^{-1} R`` for
    ``GCGParams(linear_precond=...)`` (the reference's flag-2 mode, an
    external solver preconditioning the block CG).  Chebyshev smoothing and
    the fixed-count coarse CG: an application is products and elementwise
    work that read nothing back, so it can be captured in a CUDA graph."""
    si = tuple(smooth_iters)

    def precond(r):
        e = torch.zeros_like(r)
        for _ in range(cycles):
            e = _vcycle(hier, 0, r, e, si, coarse_iters, 1e-16, 1e-13,
                        smoother)
        return e

    return precond
