"""One-call eigensolver frontend — the counterpart of ``gcge_tpu/api.py``.

:func:`solve` takes a scipy sparse matrix, a dense or 1-D numpy array, or a
prebuilt operator, packs it for the given ``device`` (DIA when the pattern is
banded — optionally after RCM reordering — Hybrid or CSR otherwise), runs GCG
and returns ``(eval, evec, nev_conv)`` in the caller's row order.  The device
is always the caller's choice: there is no silent move to the CPU.
"""

from __future__ import annotations

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
from gcge_tpu_torch.solvers.gcg import GCGParams, gcg_solve


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
    tuned = {"fuse": 5, "cg_auto_shift": True, "cg_refine": 2}
    b_diag = b is None or (isinstance(b, np.ndarray) and b.ndim == 1) or \
        isinstance(b, (DiagOperator, IdentityOperator))
    if b_diag and _mixed_capable_a(a):
        tuned["cg_mixed"] = True
    return tuned


def solve(a, b=None, nev: int = 30, *, device="cuda", rcm: bool = False,
          distribute: bool = False, multigrid: bool | int = False,
          method: str = "gcg", x0=None, params=None, **kwargs: Any):
    """Compute the ``nev`` smallest eigenpairs of ``A x = lambda B x``.

    ``a``, ``b``: scipy sparse matrix, dense ndarray, 1-D ndarray (diagonal),
    a :class:`~gcge_tpu_torch.ops.operators.LinearOperator`, or ``None`` for
    B = I.  ``device``: where the solve runs (``"cuda"`` by default).
    ``rcm``: reorder a scipy sparse ``a`` by reverse Cuthill-McKee first
    (scipy, on the host), which concentrates irregular patterns onto fewer
    diagonals; ``b`` and ``x0`` follow the same permutation and the
    eigenvectors come back in the caller's ordering.
    ``params``: a prebuilt :class:`GCGParams`; otherwise one is assembled
    from ``nev`` and ``**kwargs``.

    Returns ``(eval, evec, nev_conv)``: numpy eigenvalues (ascending), the
    Ritz vectors as a ``(n, size_x)`` tensor on ``device``, and the
    converged count."""
    if distribute:
        raise NotImplementedError("distribute is not ported yet "
                                  "(ROADMAP Queue 1 item 12)")
    if multigrid:
        raise NotImplementedError("multigrid is not ported yet "
                                  "(ROADMAP Queue 1 item 10)")
    if method != "gcg":
        raise NotImplementedError(f"method={method!r} is not ported yet "
                                  f"(ROADMAP Queue 1 item 10)")
    device = torch.device(device)
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
    a_op = _as_operator(a, params.dtype, device, perm)
    b_op = _as_operator(b, params.dtype, device, perm)
    res = gcg_solve(a_op, b_op, params, x0=x0)
    evec = res.evec
    if perm is not None:
        scattered = torch.empty_like(evec)
        scattered[torch.from_numpy(perm).to(evec.device)] = evec
        evec = scattered
    n = a_op.shape[0]
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
