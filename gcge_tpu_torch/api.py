"""One-call eigensolver frontend — the counterpart of ``gcge_tpu/api.py``.

:func:`solve` takes a scipy sparse matrix, a dense or 1-D numpy array, or a
prebuilt operator, packs it for the given ``device`` (DIA when the pattern is
banded — optionally after RCM reordering — Hybrid or CSR otherwise), runs GCG
(optionally preconditioned by an AMG V-cycle) or the multilevel PAS solver,
and returns ``(eval, evec, nev_conv)`` in the caller's row order.  The device
is always the caller's choice: there is no silent move to the CPU.  With
``distribute=True`` every rank of the default process group calls it and
the solve is row-sharded over them (:mod:`gcge_tpu_torch.parallel`); with
``distribute="grid"`` on an even number of ranks, at least 4, it runs on a
``(ranks / 2, 2)`` grid whose columns split the basis.  The AMG hierarchy of
``multigrid`` and ``method="pas"`` has its finest level sharded and its
coarser levels replicated
(:func:`~gcge_tpu_torch.parallel.shard_hierarchy`).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any

import numpy as np
import scipy.sparse as sps
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

from gcge_tpu_torch.ops.onehot import CsrOperator
from gcge_tpu_torch.ops.operators import (DenseOperator, DiagOperator,
                                          DiaOperator, HybridOperator,
                                          IdentityOperator, LinearOperator,
                                          SparseOperator, make_operator)
from gcge_tpu_torch.ops.multivec import gather_cols
from gcge_tpu_torch.parallel import (gather_rows, grid_mesh, pad_problem,
                                     row_mesh, shard_hierarchy,
                                     shard_operator)
from gcge_tpu_torch.solvers import multigrid as mg
from gcge_tpu_torch.solvers.gcg import GCGParams, gcg_solve
from gcge_tpu_torch.solvers.pas import pas_solve


def _as_operator(mat, dtype, device, perm=None):
    """Coerce a user matrix to an operator on ``device`` (host packing),
    symmetrically permuted by ``perm`` (``perm[new] = old``) when given."""
    if mat is None:
        return None
    if isinstance(mat, LinearOperator):
        if perm is not None:
            raise ValueError("rcm cannot reorder a prebuilt operator")
        return mat
    if sps.issparse(mat):
        coo = mat.tocoo()
        rows, cols = coo.row, coo.col
        if perm is not None:
            inv = np.empty_like(perm)
            inv[perm] = np.arange(len(perm))
            rows, cols = inv[rows], inv[cols]
        return make_operator(rows, cols, coo.data, coo.shape, dtype=dtype,
                             device=device)
    arr = np.asarray(mat)
    if arr.ndim == 1:
        if perm is not None:
            arr = arr[perm]
        return DiagOperator(torch.as_tensor(arr, dtype=dtype, device=device))
    if perm is not None:
        arr = arr[np.ix_(perm, perm)]
    return DenseOperator(torch.as_tensor(arr, dtype=dtype, device=device))


def _mixed_capable_a(a) -> bool:
    """Whether A lands on an operator with an f32 inner-CG path (sparse
    input, or a DIA / CSR / Hybrid / ELL operator)."""
    return sps.issparse(a) or isinstance(
        a, (DiaOperator, CsrOperator, HybridOperator, SparseOperator))


# the fused loop's chunk length on a card (see :func:`_tuned_defaults`)
CUDA_FUSE = 5


def _tuned_defaults(device: torch.device, method: str, a, b) -> dict:
    """Defaults that :func:`solve` applies on CUDA (explicit kwargs win):
    the fused loop in chunks of 5 iterations, auto shift, and the
    mixed-precision inner CG on the f32 SpMM kernels where A is sparse and B
    is None or diagonal.  The chunk length is the measured one (one H100,
    walls in PERF.md): chunks of 5 were no slower than the phased loop and
    than chunks of 20 on the banded, the irregular and a short (nev=10)
    solve, and a chunk's end discards at most 4 iterations of device work,
    where 20 discards up to 19.  The fused loop costs memory: about 2.6
    times the phased loop's peak on the banded problem (1.51 against 0.58
    GiB at n=157,464, nev=50), since a step's new state and the one it may
    keep are alive together; pass ``fuse=0`` where that does not fit.
    ``gcge_tpu``'s rule ``fuse = 20 if nev < 250 else 0`` prices the TPU
    compiler and is not carried over.  Elsewhere, as ``gcge_tpu`` does off
    the TPU, no tuning."""
    if device.type != "cuda" or method != "gcg":
        return {}
    tuned = {"fuse": CUDA_FUSE, "cg_auto_shift": True, "cg_refine": 2}
    b_diag = b is None or (isinstance(b, np.ndarray) and b.ndim == 1) or \
        isinstance(b, (DiagOperator, IdentityOperator))
    if b_diag and _mixed_capable_a(a):
        tuned["cg_mixed"] = True
    return tuned


def _hierarchy(a, b, perm, max_levels: int, method: str, dtype, device):
    """The AMG hierarchy of a scipy sparse ``a`` (and ``b``, projected onto
    A's pattern), in the RCM order ``perm`` where given."""
    if not sps.issparse(a):
        raise ValueError("multigrid/pas need a scipy sparse A")
    coo = a.tocoo()
    rows, cols = coo.row, coo.col
    if perm is not None:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        rows, cols = inv[rows], inv[cols]
    b_vals = None
    if b is not None and sps.issparse(b):
        # the hierarchy takes B on A's pattern: B's entries outside it would
        # be dropped, so they are refused
        bcsr = sps.csr_matrix(b)
        pattern = sps.csr_matrix((np.ones(coo.nnz), (coo.row, coo.col)),
                                 shape=coo.shape)
        outside = (abs(bcsr) - abs(bcsr).multiply(pattern)).count_nonzero()
        if outside:
            raise ValueError("multigrid/pas: B has nonzeros outside A's "
                             "pattern")
        b_vals = np.asarray(bcsr[coo.row, coo.col]).ravel()
    elif b is not None and method == "pas":
        raise ValueError("method='pas' with B needs a scipy sparse B on A's "
                         "sparsity pattern")
    return mg.build_hierarchy(rows, cols, coo.data, coo.shape[0],
                              b_vals=b_vals, max_levels=max_levels,
                              dtype=dtype, device=device)


def _distribution(distribute, device):
    """The mesh of ``solve(distribute=...)`` over the default process
    group: the row mesh, or for ``"grid"`` on an even number of ranks, at
    least 4, the ``(ranks / 2, 2)`` grid (``gcge_tpu``'s rule; the row mesh
    otherwise); None where the group has one rank (``gcge_tpu`` runs its
    plain path on one device).  No initialized group raises: a distributed
    call never goes on undistributed in silence."""
    if distribute not in (True, "rows", "grid"):
        raise ValueError(f"unknown distribute {distribute!r}")
    mesh = row_mesh(device=device)
    if mesh.world == 1:
        return None
    if distribute == "grid" and mesh.world % 2 == 0 and mesh.world >= 4:
        return grid_mesh(mesh.world // 2, 2, device=device)
    return mesh


def solve(a, b=None, nev: int = 30, *, device="cuda", rcm: bool = False,
          distribute: bool = False, multigrid: bool | int = False,
          method: str = "gcg", x0=None, params=None, pas_sweeps: int = 2,
          pas_final_sweeps: int = 16, pas_cycles: int = 8,
          pas_composite_rr: bool = False, **kwargs: Any):
    """Compute the ``nev`` smallest eigenpairs of ``A x = lambda B x``.

    ``a``, ``b``: scipy sparse matrix, dense ndarray, 1-D ndarray (diagonal),
    a :class:`~gcge_tpu_torch.ops.operators.LinearOperator`, or ``None`` for
    B = I.  ``device``: where the solve runs (``"cuda"`` by default).
    ``rcm``: reorder a scipy sparse ``a`` by reverse Cuthill-McKee first
    (scipy, on the host), which concentrates irregular patterns onto fewer
    diagonals; ``b`` and ``x0`` follow the same permutation and the
    eigenvectors come back in the caller's ordering.
    ``multigrid``: build a smoothed-aggregation AMG hierarchy of the scipy
    sparse ``a`` (and ``b``, on A's pattern) on the host and precondition
    GCG's inner block CG by one Chebyshev-smoothed V-cycle; an int above 1
    caps the levels (default 4).  ``method``: ``'gcg'`` or ``'pas'``, the
    multilevel PAS solver on the same hierarchy, with ``pas_sweeps`` sweeps
    a level, ``pas_final_sweeps`` on the finest, ``pas_cycles`` V-cycles a
    correction, and ``pas_composite_rr`` for the composite Rayleigh-Ritz.
    ``params``: a prebuilt :class:`GCGParams`; otherwise one is assembled
    from ``nev`` and ``**kwargs``.
    ``distribute``: ``True`` or ``'rows'`` row-shards the solve over the
    ranks of the default process group (``torchrun``, or
    :func:`gcge_tpu_torch.parallel.multihost.bootstrap`; NCCL with a card a
    rank, gloo on the CPU); every rank calls ``solve`` with the same
    arguments, the problem is padded to a multiple of the rank count
    (:func:`~gcge_tpu_torch.parallel.pad_problem`) and every rank gets the
    full eigenvectors.  ``'grid'``: on an even number of ranks, at least 4,
    the ``(ranks / 2, 2)`` grid (:func:`~gcge_tpu_torch.parallel.grid_mesh`),
    rows padded to a multiple of ``ranks / 2``; elsewhere as ``True``.
    With ``multigrid`` or ``method="pas"`` every rank
    builds the hierarchy of the unpadded matrix and shards its finest
    level, whose rows must then be a multiple of the rank count
    (``ValueError`` otherwise: the hierarchy is not padded).  Without an
    initialized group it raises; with one rank it runs the plain path.

    Returns ``(eval, evec, nev_conv)``: numpy eigenvalues (ascending), the
    Ritz vectors as a ``(n, size_x)`` tensor on ``device``, and the
    converged count."""
    if method not in ("gcg", "pas"):
        raise ValueError(f"unknown method {method!r}")
    device = torch.device(device)
    mesh = _distribution(distribute, device) if distribute else None
    if params is None:
        for k, v in _tuned_defaults(device, method, a, b).items():
            kwargs.setdefault(k, v)
        params = GCGParams(nev=nev, **kwargs)
    perm = None
    if rcm:
        if not sps.issparse(a):
            raise ValueError("rcm=True needs a scipy sparse A")
        # scipy hands back a reversed view: make it a contiguous int64 array
        perm = np.ascontiguousarray(
            reverse_cuthill_mckee(a.tocsr(), symmetric_mode=True),
            dtype=np.int64)
        if x0 is not None:
            x0 = torch.as_tensor(x0)[torch.from_numpy(perm)]
    hier = None
    if multigrid or method == "pas":
        if mesh is not None and sps.issparse(a) and a.shape[0] % mesh.world:
            raise ValueError(f"the hierarchy's finest level has {a.shape[0]}"
                             f" rows, which do not split over {mesh.world} "
                             f"ranks: with multigrid or method='pas' the "
                             f"rows must be a multiple of the rank count")
        max_levels = multigrid if isinstance(multigrid, int) and \
            multigrid > 1 else 4
        hier = _hierarchy(a, b, perm, max_levels, method, params.dtype,
                          device)
        if mesh is not None:
            hier = shard_hierarchy(hier, mesh)
    if method == "pas":
        res = pas_solve(hier, params.nev, tol_rel=params.tol_rel,
                        verbose=params.verbose, sweeps_per_level=pas_sweeps,
                        final_sweeps=pas_final_sweeps,
                        bamg_cycles=pas_cycles,
                        composite_rr=pas_composite_rr)
        n = hier.levels[0].a_op.shape[0]
    else:
        if hier is not None:
            params = replace(params,
                             linear_precond=mg.bamg_preconditioner(hier))
        a_op = _as_operator(a, params.dtype, device, perm)
        b_op = _as_operator(b, params.dtype, device, perm)
        n = a_op.shape[0]
        if mesh is not None:
            a_op, b_op, _ = pad_problem(a_op, b_op, mesh.world)
            a_op, b_op = shard_operator(a_op, mesh), shard_operator(b_op, mesh)
            if x0 is not None:
                x0 = torch.as_tensor(x0)
                x0 = torch.nn.functional.pad(
                    x0, (0, 0, 0, a_op.shape[0] - x0.shape[0]))
        res = gcg_solve(a_op, b_op, params, x0=x0, mesh=mesh)
    evec = res.evec
    if mesh is not None:
        if evec.shape[1] != len(res.eval):   # a grid split the columns
            evec = gather_cols(evec, mesh)
        evec = gather_rows(mesh, evec, n)
    if perm is not None:
        scattered = torch.empty_like(evec)
        scattered[torch.from_numpy(perm).to(evec.device)] = evec
        evec = scattered
    return res.eval[:params.resolved(n).nev], evec, res.nev_conv


def eigsh(a, k: int = 6, M=None, which: str = "SM", v0=None,
          tol: float = 0.0, maxiter: int | None = None, **kwargs: Any):
    """``scipy.sparse.linalg.eigsh``-style front end for the smallest pairs:
    returns numpy ``(w, v)`` with ``v`` of shape ``(n, k)``.  ``tol`` maps to
    the relative residual tolerance (0: the default 1e-8); ``**kwargs`` pass
    to :func:`solve` (``device`` among them)."""
    if which not in ("SM", "SA"):
        raise ValueError(f"which={which!r} unsupported: GCG targets the "
                         "smallest eigenpairs (use which='SM' or 'SA')")
    if v0 is not None and np.asarray(v0).ndim == 1:
        v0 = np.asarray(v0)[:, None]
    if tol:
        kwargs["tol_rel"] = tol
    if maxiter:
        kwargs["max_iter"] = maxiter
    ev, evec, _ = solve(a, M, nev=k, x0=v0, **kwargs)
    return np.asarray(ev[:k]), evec[:, :k].cpu().numpy()
