"""Distributed multigrid: the finest level row-sharded, the coarser levels
replicated — the counterpart of ``gcge_tpu/parallel/dist_mg.py``.

The reference redistributes its coarse grids onto subsets of the MPI ranks
(``app_slepc.c:648-809``), because a tiny coarse level costs less to solve
than to reduce over every rank.  ``gcge_tpu`` keeps the finest level sharded
and replicates every coarser level on every device; the port does the same
with one process a rank.  Every rank computes the same coarse work from the
same values (kernel 6 sums in a fixed order), so the coarse levels need no
communication.  Only level 0 communicates: its smoother products (the
sharded operator's halo window) and its two transfers:

* prolong (replicated coarse -> the rank's fine rows): the rank's rows of P,
  ``(ln x n_c)`` in CSR, against the whole coarse block — one kernel-6
  launch, no collective;
* restrict (the rank's fine rows -> replicated coarse): the rank's columns
  of ``P^T``, ``(n_c x ln)`` in CSR, then one :meth:`RowMesh.psum`.
  ``gcge_tpu`` scatter-adds its P rows instead; a CSR of ``P^T`` makes the
  product one kernel-6 launch.  It is cut from the undistributed ``r_op``'s
  own CSR arrays, so on one rank it is that operator and gives its bits.

A sharded hierarchy (:func:`shard_hierarchy`) carries its mesh
(``MGHierarchy.mesh``) and drops into ``bamg_solve``,
``bamg_preconditioner`` and ``pas_solve`` unchanged: level 0 passes the mesh
to its block CGs and column dots, the replicated levels pass none.
"""

from __future__ import annotations

import numpy as np
import torch

from gcge_tpu_torch.ops.onehot import CsrOperator
from gcge_tpu_torch.ops.operators import HybridOperator, LinearOperator
from gcge_tpu_torch.parallel.dist_ops import TRANSFERS, shard_operator
from gcge_tpu_torch.parallel.mesh import GridMesh, RowMesh, shard_rows
from gcge_tpu_torch.solvers.multigrid import MGHierarchy, MGLevel

__all__ = ["TRANSFERS", "ProlongOperator", "RestrictOperator",
           "shard_hierarchy"]


class ProlongOperator(LinearOperator):
    """``P @ x``: a replicated coarse multivector ``(n_c, m)`` to the rank's
    rows ``(ln, m)`` of the fine one.  ``local`` holds the rank's rows of P
    as a ``(ln x n_c)`` CSR; no collective."""

    def __init__(self, local: CsrOperator, mesh: RowMesh, n: int):
        self.local, self.mesh, self.n = local, mesh, int(n)

    @property
    def shape(self):
        return (self.n, self.local.n_cols)

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.mesh.device

    def matvec(self, x):
        if self.mesh.device.type == "cuda":
            TRANSFERS["prolong"] += 1
        return self.local.matvec(x)


class RestrictOperator(LinearOperator):
    """``P^T @ r``: the rank's rows ``(ln, m)`` of a fine multivector to the
    replicated coarse one ``(n_c, m)``.  ``local`` holds the rank's columns
    of ``P^T`` as an ``(n_c x ln)`` CSR; its product is summed over the
    ranks by one ``all_reduce``."""

    def __init__(self, local: CsrOperator, mesh: RowMesh, n: int):
        self.local, self.mesh, self.n = local, mesh, int(n)

    @property
    def shape(self):
        return (self.local.shape[0], self.n)

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.mesh.device

    def matvec(self, r):
        if self.mesh.device.type == "cuda":
            TRANSFERS["restrict"] += 1
        return self.mesh.psum(self.local.matvec(r))


def _as_csr(op, what: str) -> CsrOperator:
    """The hierarchy's transfers are CSR (``build_hierarchy``); ``gcge_tpu``
    asserts its ELL the same way."""
    if not isinstance(op, CsrOperator):
        raise TypeError(f"the {what} of level 0 must be a CsrOperator, got "
                        f"{type(op).__name__}")
    return op


def _csr_on(mesh: RowMesh, rowptr, colidx, values, n_cols, like):
    """A CSR operator on the mesh's device from host arrays, with the index
    types of ``like``."""
    dev = mesh.device
    return CsrOperator(
        torch.as_tensor(rowptr, device=dev).to(like.rowptr.dtype),
        torch.as_tensor(colidx, device=dev).to(like.colidx.dtype),
        values.to(dev), n_cols)


def _local_prolong(p_op: CsrOperator, mesh: RowMesh) -> ProlongOperator:
    """The rank's rows of P: a slice of P's CSR arrays."""
    n, n_c = p_op.shape
    r0, ln = mesh.block(n)
    rowptr = p_op.rowptr.cpu().numpy().astype(np.int64)
    lo, hi = int(rowptr[r0]), int(rowptr[r0 + ln])
    local = _csr_on(mesh, rowptr[r0:r0 + ln + 1] - lo,
                    p_op.colidx.cpu().numpy()[lo:hi], p_op.values[lo:hi],
                    n_c, p_op)
    return ProlongOperator(local, mesh, n)


def _local_restrict(r_op: CsrOperator, mesh: RowMesh) -> RestrictOperator:
    """The rank's columns ``[r0, r0 + ln)`` of ``P^T``: the entries of
    ``r_op`` in those columns, in their order within each row, the columns
    renumbered from 0."""
    n_c, n = r_op.shape
    r0, ln = mesh.block(n)
    rowptr = r_op.rowptr.cpu().numpy().astype(np.int64)
    colidx = r_op.colidx.cpu().numpy().astype(np.int64)
    keep = (colidx >= r0) & (colidx < r0 + ln)
    rows = np.repeat(np.arange(n_c), np.diff(rowptr))
    counts = np.bincount(rows[keep], minlength=n_c)
    local_ptr = np.concatenate([[0], np.cumsum(counts)])
    values = r_op.values[torch.as_tensor(keep, device=r_op.values.device)]
    local = _csr_on(mesh, local_ptr, colidx[keep] - r0, values, ln, r_op)
    return RestrictOperator(local, mesh, n)


def _stored(op) -> int:
    """Nonzeros an operator stores (explicit zeros of DIA storage not
    counted)."""
    if isinstance(op, HybridOperator):
        return _stored(op.dia) + (0 if op.rest is None else _stored(op.rest))
    values = getattr(op, "values", None)
    return 0 if values is None else int(torch.count_nonzero(values))


def check_replicated(hier: MGHierarchy, mesh: RowMesh) -> None:
    """Raise ``ValueError`` unless every rank holds the same hierarchy, by
    each level's ``(n, nonzeros, lam_max)``: their minimum and maximum over
    the ranks (two small ``all_reduce``: the level count, then the
    levels).  Every rank builds the hierarchy on its own from the same
    input (numpy and a seeded power iteration), so they agree unless the
    ranks were given different matrices."""
    count = torch.tensor([hier.num_levels, -hier.num_levels],
                         dtype=torch.float64, device=mesh.device)
    count = mesh.pmax(count).cpu()
    if int(count[0]) != -int(count[1]):
        raise ValueError(f"the ranks built hierarchies of {-int(count[1])} "
                         f"to {int(count[0])} levels")
    sig = torch.tensor([[lv.a_op.shape[0], _stored(lv.a_op),
                         lv.lam_max or 0.0] for lv in hier.levels],
                       dtype=torch.float64, device=mesh.device)
    both = mesh.pmax(torch.cat([sig, -sig])).cpu()
    hi, lo = both[:len(sig)], -both[len(sig):]
    if not torch.equal(hi, lo):
        bad = [i for i in range(len(sig)) if not torch.equal(hi[i], lo[i])]
        raise ValueError(f"the ranks built different hierarchies: levels "
                         f"{bad} differ in (n, nonzeros, lam_max)")


def shard_hierarchy(hier: MGHierarchy, mesh: RowMesh) -> MGHierarchy:
    """The hierarchy with level 0 row-sharded over ``mesh`` and the coarser
    levels kept as they are (replicated); every rank calls it with its own,
    identical, hierarchy (:func:`check_replicated`).

    Level 0's A and B go through :func:`shard_operator`, its ``dinv``
    through :func:`shard_rows`, its transfers become
    :class:`ProlongOperator` and :class:`RestrictOperator`.  Level 0's row
    count must split into equal blocks over the ranks: ``ValueError``
    otherwise (``gcge_tpu`` asserts).  The result carries ``mesh``.

    On a grid (:class:`~gcge_tpu_torch.parallel.GridMesh`) level 0 is
    sharded over the rank's row group, as ``gcge_tpu``'s specs name its row
    axis only, and the hierarchy carries the grid with every column on every
    rank of a row (``replicated()``): the V-cycle works on whatever columns
    it is given, and ``pas_solve`` runs in every grid column alike, its
    replicated values broadcast from the grid's rank 0."""
    if hier.num_levels < 1:
        raise ValueError("an empty hierarchy")
    if hier.mesh is not None:
        raise ValueError("the hierarchy is sharded already")
    lv0 = hier.levels[0]
    n0 = lv0.a_op.shape[0]
    if n0 % mesh.world:
        raise ValueError(f"the hierarchy's finest level has {n0} rows, which "
                         f"do not split over {mesh.world} ranks: its rows "
                         f"must be a multiple of the rank count")
    check_replicated(hier, mesh.everyone() if isinstance(mesh, GridMesh)
                     else mesh)
    if isinstance(mesh, GridMesh):
        mesh = mesh.replicated()
    new0 = MGLevel(
        a_op=shard_operator(lv0.a_op, mesh),
        b_op=shard_operator(lv0.b_op, mesh),
        dinv=None if lv0.dinv is None else shard_rows(mesh, lv0.dinv),
        lam_max=lv0.lam_max)
    if lv0.p_op is not None:
        new0.p_op = _local_prolong(_as_csr(lv0.p_op, "prolongation"), mesh)
        new0.r_op = _local_restrict(_as_csr(lv0.r_op, "restriction"), mesh)
    return MGHierarchy(levels=[new0] + list(hier.levels[1:]),
                       setup=list(hier.setup), mesh=mesh)
