"""GCG — block damping inverse-power eigensolver, phased and fused paths —
the counterpart of ``gcge_tpu/solvers/gcg.py``.

Computes the ``nev`` smallest eigenpairs of ``A x = lambda B x`` (A, B
symmetric, B SPD or None) on the subspace ``V = [X | P | W]``: X the current
Ritz vectors, P the previous search directions, W inexact inverse-power
corrections from a block-CG solve of ``(A + sigma B) W = (lambda + sigma) B X``.

The layout of state is ``gcge_tpu``'s: a fixed-width basis
``V : (n, size_x + 2*bs)`` whose P/W occupancy is tracked by counts (invalid
columns are exact zeros), the full ``m x m`` projected matrix with invalid
slots padded by a Gershgorin-large diagonal, the ``cP^T H cP`` recurrence for
the P block, and the convergence and window logic.  Each phase is a plain
function of tensors that runs eagerly.  Where ``gcge_tpu`` donates ``v`` to a
jitted phase, the port updates ``v`` in place.

Two loops drive the phases.  The phased loop (``fuse=0``) reads a few scalars
back to the host each iteration and stops its inner CG as soon as no column is
active.  The fused loop (``fuse=k``) runs chunks of up to ``k`` iterations in
which the port's own code reads nothing back: convergence test, active
window, shift and counts stay tensors on the device, the inner CG runs its
whole step budget, and an iteration that comes after the chunk's stopping
condition is computed and then discarded by a select on the state.  The host
reads four scalars and the residual window once per chunk.  On a card the
f32 CG stage of the mixed inner solve is captured once per solve as a CUDA
graph and replayed for every stage.  The one wait that remains inside a chunk
is ``torch.linalg.eigh``'s own (see :func:`gcge_tpu_torch.ops.eighs.safe_eigh`).

The tall products of the phases run through the CUDA kernels on the card:
every f64 application of a DIA operator (kernel 1) or a CSR operator
(kernel 6), the f32 inner CG of the mixed branch (kernels 2 and 5), the tall
Grams (kernel 3) and the tall recombinations (kernel 4).  A Hybrid operator
runs both SpMM pairs.

Under a row mesh (``mesh``, :class:`gcge_tpu_torch.parallel.RowMesh`; the
operators from :func:`gcge_tpu_torch.parallel.shard_operator`) every rank
holds its rows of the basis, the Ritz vectors and the CG's vectors.  Each
contraction over rows (the Grams of the Rayleigh-Ritz steps and of the
orthonormalizations, the column dots of the residual check and of the CG) is
the local product followed by one ``all_reduce``, so the projected problem
is the same on every rank; its eigenpairs are rank 0's, broadcast
(:func:`gcge_tpu_torch.ops.eighs.eigh`), and every host decision (converged
count, restart, stop, the inner CG's early exit) is taken from reduced or
broadcast values, the fused loop's one read a chunk included.  The random
start is the rank's rows of one global draw, so a distributed solve starts
where the undistributed one does.

On a grid (:class:`gcge_tpu_torch.parallel.GridMesh`) the operators hold the
rows of the rank's row group and every rank of a grid row holds the same
rows.  Where every width of the solve (the initial and the largest X, the
block, the residual window) splits over the grid's ``n_cols`` columns, each
rank also holds only its columns of V, of the Ritz vectors and of each
block (:mod:`gcge_tpu_torch.ops.multivec`: column ``j`` on grid column ``j
% n_cols``, so that V's local columns are its blocks' local columns in
order), and the solve decides at each call site:

* an operator product runs on the rank's columns only (the initial X, the
  residual window, the W block's inner CG, W in the Rayleigh-Ritz step);
* a Gram ``V^T (A W)`` gathers the narrow factor over the grid row and
  multiplies the rank's columns of the wide one (:func:`~gcge_tpu_torch.ops.
  multivec.gram_cols`), a recombination ``V c`` sums the ranks' partial
  products (:func:`~gcge_tpu_torch.ops.multivec.expand_cols`);
* a selection of columns at indices (the active window, the residual
  window) is summed over the grid row from the ranks that hold them
  (:func:`~gcge_tpu_torch.ops.multivec.select_cols`), then each rank keeps
  its columns;
* the W block's orthonormalization runs on the whole block, which every
  rank of a grid row holds for it (``orth.orth_block_against``), and the
  random start is drawn and orthonormalized whole, then split;
* ``cg_order=2`` solves for the whole W block on every rank of a row (its
  second stage continues the first stage's columns, which another rank may
  hold).

Otherwise every column lies on every rank of a row (``GridMesh.replicated``)
and the solve is the row mesh's, in every grid column.  Either way the
projected problem, the eigenpairs (the grid's rank 0's, broadcast over the
grid), the counts and the fused loop's read have the same bits on every
rank of the grid.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field, replace
from typing import Any, Optional

import numpy as np
import torch

from gcge_tpu_torch.ops import onehot, spmm
from gcge_tpu_torch.ops.eighs import (check_backend, eigh, jacobi_polish,
                                      safe_eigh)
from gcge_tpu_torch.ops.multivec import (col_dots, col_split, expand_cols,
                                         gather_cols, gram_cols, own_cols,
                                         select_cols, set_random,
                                         whole_matvec)
from gcge_tpu_torch.ops.onehot import CsrOperator
from gcge_tpu_torch.ops.operators import (DiagOperator, DiaOperator,
                                          HybridOperator, SparseOperator)
from gcge_tpu_torch.ops.osgemm import tall_expand, tall_gram
from gcge_tpu_torch.parallel import dist_ops
from gcge_tpu_torch.parallel.dist_ops import RowShardedOperator
from gcge_tpu_torch.parallel.mesh import RowMesh, gather_rows
from gcge_tpu_torch.solvers.bpcg import (BlockPCGParams, block_pcg,
                                         block_pcg_t)
from gcge_tpu_torch.solvers.orth import orth_block_against, orth_within


# --------------------------------------------------------------------------
# parameters / results
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class GCGParams:
    """GCG knobs; names and defaults follow ``gcge_tpu.GCGParams``."""

    nev: int = 30                     # wanted eigenpairs (nevConv)
    block_size: int = 0               # 0 -> auto (nev//5, at least 1)
    nev_max: int = 0                  # 0 -> auto (2*nev)
    nev_init: int = 0                 # 0 -> nev_max
    max_iter: int = 500               # numIterMax
    gap_min: float = 0.01             # multiplicity-cluster backoff
    multi_max: int = 0                # backoff cap; 0 -> block_size
    tol_abs: float = 1e-1
    tol_rel: float = 1e-8
    # W inner solve
    cg_max_iter: int = 30
    cg_rate: float = 1e-2
    cg_tol: float = 1e-14
    cg_tol_type: str = "abs"
    cg_auto_shift: bool = False
    cg_shift: float = 0.0
    cg_order: int = 1          # 2 -> two Krylov stages per solved column
    # mixed-precision inner solve: f32 CG stages (the f32 DIA and CSR
    # kernels on the card) with f64 residual refreshes between them; needs
    # B = None or diagonal.  cg_max_iter stays the TOTAL matvec budget and is
    # split evenly over the cg_refine stages.
    cg_mixed: bool = False
    cg_refine: int = 2
    # a user inner solver ``(shifted, rhs, x0, colmask) -> w`` that replaces
    # the block CG, and a preconditioner ``R -> M^{-1} R`` of the block CG
    # (f64, (n, m) layout; composed with the f32 stages of the mixed branch)
    linear_solver: Any = None
    linear_precond: Any = None
    check_max: int = 0                # residual window; 0 -> 2*block_size
    orth_zero_tol: float = 1e-13
    orth_passes: int = 2
    orth_method: str = "evp"
    # precision of the W block's projection and of the Rayleigh-Ritz tall
    # products: 'auto' and 'f64' both mean f64 off the TPU ('osgemm' and
    # 'mixed' are the TPU's emulated-f64 GEMMs and raise)
    orth_proj_precision: str = "auto"
    rr_gemm_precision: str = "auto"
    verbose: int = 1
    dtype: Any = torch.float64
    # > 0: chunks of up to this many iterations without a host read of
    # solver state (the fused loop); 0: the phased loop
    fuse: int = 0
    # 'auto', 'on', 'off': accepted and ignored (the hot swap works around
    # the TPU's compile time)
    fuse_hotswap: str = "auto"
    # save the Ritz pairs to checkpoint_path every checkpoint_every completed
    # iterations (the fused loop: after a chunk that completes them); resume
    # by passing the saved evec as x0 (utils.checkpoint)
    checkpoint_path: Any = None
    checkpoint_every: int = 0
    # write a torch.profiler Chrome trace of the solve into this directory
    profile_dir: Any = None
    # backend of the projected eigensolve (ops.eighs.eigh): 'auto' (=
    # 'device' off the TPU, as in gcge_tpu), 'device', 'jacobi', 'newton'
    # or 'host'
    rr_backend: str = "auto"
    # 'auto' and 'struct': under rr_backend='newton' every Rayleigh-Ritz
    # step after the first seeds its Newton eigh with the structural warm
    # start (_rr_struct_warm) where the X-W coupling is small enough; 'off',
    # and every other backend: a cold eigh in every step
    rr_warm: str = "auto"

    def resolved(self, n: int) -> "GCGParams":
        """Fill auto defaults as the reference test program does: bs = nev/5,
        nevMax = 2*nev, nevInit = nevMax."""
        nev = self.nev
        bs = self.block_size or max(nev // 5, 1)
        nev_max = max(self.nev_max or 2 * nev, nev + bs)
        nev_init = self.nev_init or nev_max
        nev_init = max(min(nev_init, nev_max), min(3 * bs, nev_max))
        if nev_max + 2 * bs > n:
            raise ValueError(f"subspace {nev_max}+2*{bs} exceeds problem "
                             f"size {n}")
        multi_max = self.multi_max or bs
        if multi_max > bs:
            raise ValueError(f"multi_max {multi_max} > block_size {bs}")
        return GCGParams(**{**self.__dict__, "nev": nev, "block_size": bs,
                            "nev_max": nev_max, "nev_init": nev_init,
                            "multi_max": multi_max})


@dataclass
class GCGResult:
    eval: np.ndarray            # (size_x,) Ritz values, ascending
    evec: torch.Tensor          # (n, size_x) Ritz vectors (under a mesh:
                                # the rank's rows; on a grid that splits
                                # columns, its columns of them)
    nev_conv: int
    num_iter: int
    res_norms: np.ndarray       # last residual window (diagnostic)
    timers: dict
    history: list = field(default_factory=list)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def _matvec(op, x):
    return x if op is None else op.matvec(x)


def _initial_rr(a_op, v, size_x: int, bs: int, rr_backend: str = "auto",
                mesh=None):
    """First Rayleigh-Ritz on V = [X]: H = X^T A X, eigh, Ritz vectors
    written into the X slots of ``v``."""
    m = size_x + 2 * bs
    x = v[:, :size_x // col_split(mesh)]
    h_xx = gram_cols(x, gather_cols(a_op.matvec(x), mesh), mesh, tall_gram)
    h_xx = 0.5 * (h_xx + h_xx.T)
    w, c = eigh(h_xx, rr_backend, mesh)
    ss_eval = torch.cat([w, w[-1:].expand(m - size_x)])
    ss_evec = torch.eye(m, dtype=v.dtype, device=v.device)
    ss_evec[:size_x, :size_x] = c
    h = torch.zeros((m, m), dtype=v.dtype, device=v.device)
    h[:size_x, :size_x] = h_xx
    ritz = expand_cols(x, c, mesh, tall_expand)
    v[:, :x.shape[1]] = ritz
    return ss_eval, ss_evec, h, ritz, v


def _residual_norms(a_op, b_op, ritz, ss_eval, c0, cw: int, mesh=None):
    """Residual 2-norms of the Ritz window ``[c0, c0+cw)``.  ``c0`` is an int
    (the window is a view) or a 0-d tensor on the device (a gather).  On a
    grid that splits columns each rank runs its columns of the window."""
    if col_split(mesh) > 1:
        idx = c0 + torch.arange(cw, device=ritz.device)
        cols = own_cols(select_cols(ritz, idx, mesh), mesh)
        lam = own_cols(ss_eval.index_select(0, idx), mesh)
    elif torch.is_tensor(c0):
        idx = c0 + torch.arange(cw, device=ritz.device)
        cols = ritz.index_select(1, idx)
        lam = ss_eval.index_select(0, idx)
    else:
        cols = ritz[:, c0:c0 + cw]
        lam = ss_eval[c0:c0 + cw]
    r = a_op.matvec(cols) - lam[None, :] * _matvec(b_op, cols)
    return gather_cols(torch.sqrt(col_dots(r, r, mesh)), mesh)


def _compute_p(v, ss_evec, h, act_idx, act_cnt, size_x: int, bs: int,
               zero_tol: float, passes: int, orth_method: str = "evp",
               mesh=None):
    """The P block: the active window's subspace eigenvectors with their
    X components zeroed, orthonormalized against the X coefficients and
    within (ref scale 1: converged columns' leftovers must deflate), then
    ``P = V cP``.  ``act_cnt`` is an int or a 0-d tensor.  Returns the block
    ``(n, bs)``, its rank and ``P^T A P = cP^T H cP``; the caller writes the
    block into the P slots."""
    colmask = (torch.arange(bs, device=v.device) < act_cnt).to(v.dtype)
    c_p = ss_evec[:, act_idx] * colmask[None, :]
    # not ``c_p[act_idx, :] = 0.0``: that makes a tensor of the 0.0 on the
    # host and copies it over, which waits for the device
    c_p.index_fill_(0, act_idx, 0.0)
    c_x = ss_evec[:, :size_x]
    c_p, p_cnt = orth_block_against(c_p, c_x, None, zero_tol=zero_tol,
                                    passes=passes, ref_scale2=1.0,
                                    method=orth_method, precision="f64")
    h_pp = c_p.T @ (h @ c_p)
    return expand_cols(v, c_p, mesh, tall_expand), p_cnt, h_pp


def _f32_apply(a_op):
    """The f32 form of ``a_op`` for the mixed inner CG, as ``(apply,
    transposed)``: DIA and CSR run the transposed ``(m, n)`` layout (kernels
    2 and 5 on the card) on ``(n, m)`` memory, the order of ``r.T.float()``,
    and return their products in it; Hybrid and ELL run the ``(n, m)``
    layout.  ``(None, False)`` for an operator without an f32 form.  A
    row-sharded operator runs its f32 form on its window in the same
    layouts."""
    if isinstance(a_op, RowShardedOperator):
        if a_op.kind in ("dia", "csr"):
            return a_op.astype(torch.float32).matvec_t, True
        if a_op.kind in ("hybrid", "ell"):
            return a_op.astype(torch.float32).matvec, False
        return None, False
    if isinstance(a_op, CsrOperator):     # dispatches on the dtype of x
        return a_op.matvec_t, True
    if isinstance(a_op, DiaOperator):
        return DiaOperator(a_op.values.float(), a_op.offsets,
                           a_op.n_cols).matvec_t, True
    if isinstance(a_op, HybridOperator):
        dia = a_op.dia
        return HybridOperator(
            DiaOperator(dia.values.float(), dia.offsets, dia.n_cols),
            a_op.rest).matvec, False
    if isinstance(a_op, SparseOperator):
        return SparseOperator(a_op.values.float(), a_op.indices,
                              a_op.n_cols).matvec, False
    return None, False


# replays of the captured CG stage since the last reset.  A replay launches
# the stage's kernels without passing through their wrappers, so it adds the
# calls each wrapper got during capture to that wrapper's launch count (and
# a sharded operator's windowed products to dist_ops.WINDOWED, a sharded
# hierarchy's transfers to dist_ops.TRANSFERS)
GRAPH_REPLAYS = {"cg_stage": 0}
_STAGE_COUNTERS = (spmm.LAUNCHES, onehot.LAUNCHES, dist_ops.WINDOWED,
                   dist_ops.TRANSFERS, dist_ops.WIDTHS)


def _stage_counts():
    return [dict(counters) for counters in _STAGE_COUNTERS]


def _held(v, mesh) -> None:
    """Under a mesh, record the shape of the rank's part of V
    (``dist_ops.HELD``) at the end of an iteration (the fused loop: of a
    chunk)."""
    if mesh is not None:
        dist_ops.HELD["basis"] = tuple(v.shape)


class _MixedStage:
    """One f32 CG stage of the mixed inner solve: ``(A + sigma B) d = r`` in
    f32 from ``d = 0``, for a residual ``r (n, bs)`` in f64.

    Built once per solve: the f32 form of the operator, the stage's step
    budget, whether the CG runs its whole budget (``fixed``), and the
    preconditioner ``precond`` (f64, ``(n, m)`` layout, or None), which the
    stage applies as ``precond(r.T.double()).float().T`` in the transposed
    layout and ``precond(r.double()).float()`` in the other.  With
    ``capture`` the stage is recorded once as a CUDA graph on static buffers
    (residual, column mask and ``sigma`` in; correction and step count out)
    and every call is three small copies and one replay: shapes ``(bs, n)``
    do not change when the basis grows.  A capture that fails raises; there
    is no eager retreat on a card, except under a row mesh: there the stage
    also holds the CG's ``all_reduce`` and the window's point-to-point
    exchange, and whether NCCL lets a capture hold them depends on its
    version, so a refused capture leaves the stage eager (``capture_error``
    says why).  The same kernels run either way."""

    def __init__(self, a_op, b_op, cg: BlockPCGParams, bs: int, fixed: bool,
                 capture: bool, precond=None, mesh=None):
        self.apply32, self.transposed = _f32_apply(a_op)
        self.cg, self.fixed, self.mesh = cg, fixed, mesh
        self.precond, self.dtype = precond, a_op.dtype
        self.capture_error = None
        self.b32 = None
        if b_op is not None:
            b32 = b_op.d.float()
            self.b32 = b32[None, :] if self.transposed else b32[:, None]
        self.graph = None
        if capture and self.apply32 is not None:
            n = a_op.shape[0] if mesh is None else mesh.block(a_op.shape[0])[1]
            try:
                self._capture(n, bs, a_op.device)
            except RuntimeError as exc:
                if mesh is None:
                    raise
                torch.cuda.synchronize(a_op.device)
                self.graph, self.capture_error = None, str(exc)

    def _pcg(self, r32, colmask, sigma):
        b32 = self.b32

        def mv32(y):
            return self.apply32(y) + sigma * (y if b32 is None else b32 * y)

        precond32 = None
        if self.precond is not None:
            if self.transposed:
                def precond32(rt):
                    return self.precond(rt.T.to(self.dtype)).float().T
            else:
                def precond32(r):
                    return self.precond(r.to(self.dtype)).float()
        pcg = block_pcg_t if self.transposed else block_pcg
        d, info = pcg(mv32, r32, torch.zeros_like(r32), self.cg,
                      active0=colmask, precond=precond32, fixed=self.fixed,
                      mesh=self.mesh)
        return d, info.niters

    def _capture(self, n: int, bs: int, device):
        # the residual buffer has the strides the eager stage's operand has
        # (``r.T.float()`` keeps the (n, bs) memory order), and the SpMM
        # wrappers return their products in the order of their operand, so
        # every tensor of the captured stage has the eager stage's strides:
        # both run the same kernels on the same layout.  A CSR operator's
        # row tiles were planned when it was built: nothing is copied to the
        # card under capture.  A preconditioner is captured with the stage:
        # it must read nothing back (bamg_preconditioner's coarse CG runs its
        # whole budget)
        if self.mesh is not None:
            self.mesh.warm()
        r32 = torch.zeros((n, bs), dtype=torch.float32, device=device)
        self._r32 = r32.T if self.transposed else r32
        self._mask = torch.zeros(bs, dtype=torch.bool, device=device)
        self._sigma = torch.zeros((), dtype=torch.float32, device=device)
        with torch.cuda.device(device):     # capture on the operator's card
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):   # loads every kernel before capture
                self._pcg(self._r32, self._mask, self._sigma)
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            before = _stage_counts()
            with torch.cuda.graph(self.graph):
                self._d, self._niters = self._pcg(self._r32, self._mask,
                                                  self._sigma)
            # a wrapper called under capture records its kernel and launches
            # nothing: its count moves from the capture to the replays
            self._launches = []
            for counters, was in zip(_STAGE_COUNTERS, before):
                delta = {k: counters[k] - was.get(k, 0) for k in counters}
                counters.clear()
                counters.update(was)
                self._launches.append(delta)

    def __call__(self, r, colmask, sigma):
        """Correction ``(n, bs)`` in the dtype of ``r``, and the CG steps."""
        if self.graph is not None:
            self._r32.copy_(r.T if self.transposed else r)
            self._mask.copy_(colmask)
            if torch.is_tensor(sigma):
                self._sigma.copy_(sigma)
            else:
                self._sigma.fill_(sigma)
            self.graph.replay()
            GRAPH_REPLAYS["cg_stage"] += 1
            for counters, delta in zip(_STAGE_COUNTERS, self._launches):
                for k, count in delta.items():
                    counters[k] = counters.get(k, 0) + count
            d, niters = self._d, self._niters.clone()
        else:
            r32 = r.T.float() if self.transposed else r.float()
            if torch.is_tensor(sigma):
                sigma = sigma.float()
            d, niters = self._pcg(r32, colmask, sigma)
        return (d.T if self.transposed else d).to(r.dtype), niters


def _mixed_inner_solve(stage: _MixedStage, rhs, xact, fmask, colmask, sigma,
                       refine: int, shifted):
    """Mixed-precision refinement: f32 CG stages on the correction, f64
    residual recomputed between stages (``shifted``, in the operator's f64
    kernel)."""
    w = xact
    niters = 0
    for _ in range(refine):
        r = (rhs - shifted(w)) * fmask[None, :]
        d, k = stage(r, colmask, sigma)
        w = w + d
        niters = niters + k
    return w, niters


def _compute_w(a_op, b_op, v, ritz, ss_eval, act_idx, act_cnt, sigma,
               size_x: int, bs: int, cg: BlockPCGParams,
               zero_tol: float, passes: int, cg_order: int = 1,
               mixed: bool = False, refine: int = 2,
               orth_method: str = "evp", stage: Optional[_MixedStage] = None,
               fixed: bool = False, linear_solver=None, precond=None,
               mesh=None):
    """Inverse-power correction block W: for the active window solve
    ``(A + sigma B) w = (lambda + sigma) B x`` from ``x``, then
    B-orthonormalize W against [X | P] and within (rank-revealing) into the
    W slots of ``v``.  ``act_cnt`` and ``sigma`` are Python numbers or 0-d
    tensors; ``stage`` is the f32 CG stage of the mixed branch (None: A has
    no f32 form), which carries its own preconditioner; ``fixed`` makes
    every CG run its whole step budget.  ``linear_solver(shifted, rhs, x,
    colmask)`` replaces the block CG (zero steps and residuals reported);
    ``precond`` preconditions the f64 block CGs.  Under a row mesh the
    user functions get the rank's rows (on a grid that splits columns, and
    the stage too, its columns of the block)."""
    colmask = torch.arange(bs, device=v.device) < act_cnt
    fmask = colmask.to(v.dtype)
    xact = select_cols(ritz, act_idx, mesh) * fmask[None, :]
    lam = ss_eval[act_idx] + sigma
    # cg_order=2's second stage continues the first one's columns, which
    # another rank of the grid row may hold: it solves for the whole block
    whole = cg_order == 2 and col_split(mesh) > 1
    if not whole:
        xact, lam, colmask, fmask = (own_cols(t, mesh)
                                     for t in (xact, lam, colmask, fmask))
    rhs = lam[None, :] * _matvec(b_op, xact)

    def shifted(y):
        return a_op.matvec(y) + sigma * _matvec(b_op, y)

    if linear_solver is not None:
        w = linear_solver(shifted, rhs, xact, colmask)
        niters = 0
        final_res = torch.zeros_like(fmask)
    elif mixed:
        if stage is not None:
            w, niters = _mixed_inner_solve(stage, rhs, xact, fmask, colmask,
                                           sigma, refine, shifted)
        else:
            # no f32 operator for this A (dense, diagonal, user): plain f64
            w, info = block_pcg(shifted, rhs, xact, cg, active0=colmask,
                                precond=precond, fixed=fixed, mesh=mesh)
            w = w * fmask[None, :]
            niters = info.niters
        rfin = (rhs - shifted(w)) * fmask[None, :]
        final_res = torch.sqrt(col_dots(rfin, rfin, mesh))
    elif cg_order == 2:
        half = max(bs // 2, 1)
        hmask = colmask & (torch.arange(bs, device=v.device) < half)
        w1, info1 = block_pcg(shifted, rhs, xact, cg, active0=hmask,
                              precond=precond, fixed=fixed, mesh=mesh)
        w2, info2 = block_pcg(shifted, rhs, w1, cg, active0=hmask,
                              precond=precond, fixed=fixed, mesh=mesh)
        hf = hmask.to(v.dtype)[None, :]
        w = torch.cat([(w1 * hf)[:, :half], (w2 * hf)[:, :half]], dim=1)
        w = torch.nn.functional.pad(w, (0, bs - w.shape[1]))[:, :bs]
        niters = info1.niters + info2.niters
        final_res = info2.final_res
        if whole:
            w = own_cols(w, mesh)
    else:
        w, info = block_pcg(shifted, rhs, xact, cg, active0=colmask,
                            precond=precond, fixed=fixed, mesh=mesh)
        w = w * fmask[None, :]
        niters, final_res = info.niters, info.final_res
    if not whole:
        final_res = gather_cols(final_res, mesh)
    q = v[:, :(size_x + bs) // col_split(mesh)]
    bmv = None if b_op is None else b_op.matvec
    w, w_cnt = orth_block_against(w, q, bmv, zero_tol=zero_tol, passes=passes,
                                  method=orth_method, precision="auto",
                                  mesh=mesh)
    v[:, q.shape[1]:] = w
    return v, w_cnt, niters, final_res


def _rr_struct_warm(h_eig, size_x: int, bs: int, mesh=None):
    """Structural warm start for the Rayleigh-Ritz eigensolve
    (``gcge_tpu/solvers/gcg.py:316-358``).

    The projected matrix is nearly block-diagonal: its X block is exactly
    ``diag(lambda)``, the X-P coupling exactly zero and the X-W coupling
    ``R^T W``, residual-sized.  So ``U0 = blockdiag(I, eigvecs(trailing 2bs
    block))`` diagonalizes all but residual-scale couplings, which
    ``eigh_newton``'s refinement contracts quadratically, and ``U0^T H U0``
    is assembled analytically.  One (2bs)^2 eigh (Jacobi-polished) takes the
    place of the m x m one.

    Returns ``(d0, u0, h1, warm_ok)``, the first three sorted ascending as
    ``eigh_newton(warm=(d0, u0), warm_h1=h1)`` expects.  ``warm_ok`` is the
    warm start's premise, ``||H1 offdiag|| < 0.02 (max d0 - min d0)``, from
    the polished result as in ``gcge_tpu``, a Python bool read back in the
    wait of the (2bs)^2 eigh (:func:`safe_eigh`'s ``extra``: the polish and
    the premise are queued before that wait), so that it adds no wait.  The
    two packages sum the norm in different orders, so a coupling within
    rounding of the threshold may take different branches in them.

    Under a mesh every rank takes rank 0's eigh of the trailing block (and
    its NaN flag, so that the ranks retry together) and rank 0's premise,
    each by a broadcast queued before that wait: the two branches run
    different collectives, so the ranks must take the same one."""
    dev, dt = h_eig.device, h_eig.dtype
    m = size_x + 2 * bs
    t = h_eig[size_x:, size_x:]
    h_xt = h_eig[:size_x, size_x:]
    lam_x = h_eig.diagonal()[:size_x]
    warm = {}

    def rank0_eigh(wt0, qt0, bad):
        if mesh is None:
            return wt0, qt0, bad
        k = wt0.shape[0]
        got = mesh.broadcast(torch.cat([wt0[None, :], qt0,
                                        bad.to(dt).expand(1, k)]))
        return got[0], got[1:k + 1], got[k + 1, 0] > 0

    def premise(wt0, qt0):
        wt, qt = jacobi_polish(t, wt0, qt0, sweeps=2)
        d0 = torch.cat([lam_x, wt])
        c_xt = h_xt @ qt                        # (size_x, 2bs)
        h1 = torch.diag(d0)
        h1[:size_x, size_x:] = c_xt
        h1[size_x:, :size_x] = c_xt.T
        warm.update(d0=d0, qt=qt, h1=h1)
        coupling = torch.linalg.norm(h1 * (1.0 - torch.eye(m, dtype=dt,
                                                           device=dev)))
        spread = torch.clamp(d0.max() - d0.min(), min=1e-300)
        ok = coupling < 0.02 * spread
        if mesh is not None:
            ok = mesh.broadcast(ok.reshape(1).to(dt))[0] > 0
        return [ok]

    _, _, (warm_ok,) = safe_eigh(t, extra=premise, finish=rank0_eigh)
    d0, h1 = warm["d0"], warm["h1"]
    perm = torch.argsort(d0, stable=True)
    u0 = torch.block_diag(torch.eye(size_x, dtype=dt, device=dev),
                          warm["qt"])
    return (d0.index_select(0, perm), u0.index_select(1, perm),
            h1.index_select(0, perm).index_select(1, perm), warm_ok)


def _rayleigh_ritz(a_op, v, h_pp, ss_eval, p_cnt, w_cnt, size_x: int,
                   bs: int, rr_backend: str = "auto", mesh=None,
                   rr_warm: bool = False):
    """Assemble the projected matrix and solve the small eigenproblem:
    X block diag(lambda), X-P block 0, P block from the recurrence, the W
    coupling ``V^T A W`` the only large A-application; invalid slots padded
    with a Gershgorin-large diagonal.  Returns the new Ritz values, subspace
    eigenvectors, projected matrix and Ritz vectors.

    ``rr_warm`` with ``rr_backend='newton'``: the Newton eigh starts from
    :func:`_rr_struct_warm` where its premise holds, else cold (gcge_tpu
    takes the branch by ``lax.cond``; here the premise is read in the wait
    of the warm start's own eigh)."""
    m = size_x + 2 * bs
    dev, dt = v.device, v.dtype
    ar = torch.arange(bs, device=dev)
    aw = a_op.matvec(v[:, (size_x + bs) // col_split(mesh):])
    h_vw = gram_cols(v, gather_cols(aw, mesh), mesh, tall_gram)   # (m, bs)
    h_vw = h_vw * (ar < w_cnt).to(dt)[None, :]

    h = torch.zeros((m, m), dtype=dt, device=dev)
    ix = torch.arange(size_x, device=dev)
    h[ix, ix] = ss_eval[:size_x]
    h[size_x:size_x + bs, size_x:size_x + bs] = h_pp
    h[:, size_x + bs:] = h_vw
    h[size_x + bs:, :size_x + bs] = h_vw[:size_x + bs].T
    h_ww = h_vw[size_x + bs:]
    h[size_x + bs:, size_x + bs:] = 0.5 * (h_ww + h_ww.T)

    valid = torch.cat([torch.ones(size_x, dtype=torch.bool, device=dev),
                       ar < p_cnt, ar < w_cnt])
    fvalid = valid.to(dt)
    h = h * fvalid[None, :] * fvalid[:, None]
    gersh = h.abs().sum(dim=1).max() + 1.0
    h_eig = h + torch.diag((1.0 - fvalid) * gersh)
    warm_ok = False
    if rr_warm and rr_backend == "newton":
        d0, u0, h1w, warm_ok = _rr_struct_warm(h_eig, size_x, bs, mesh)
    if warm_ok:
        w, c = eigh(h_eig, "newton", mesh, warm=(d0, u0), warm_h1=h1w,
                    cluster_first=False)
    else:
        w, c = eigh(h_eig, rr_backend, mesh)
    act_tot = size_x + p_cnt + w_cnt
    # a gather, not ``w[act_tot - 1]``: indexing by a 0-d tensor reads it
    # back to the host
    lam_pad = w.index_select(0, (act_tot - 1).reshape(1))
    ss_eval_new = torch.where(torch.arange(m, device=dev) < act_tot, w,
                              lam_pad)
    ritz = expand_cols(v, c[:, :size_x], mesh, tall_expand)
    return ss_eval_new, c, h, ritz


def _rr_warm(p: GCGParams) -> bool:
    """Whether the Rayleigh-Ritz steps after the first may take the
    structural warm start (``gcge_tpu``'s rule)."""
    return p.rr_warm in ("auto", "struct")


def _set_x(v, ritz, size_x: int):
    """ComputeX: copy the Ritz vectors into the X slots of ``v``."""
    v[:, :ritz.shape[1]] = ritz
    return v


def _expand_ritz(v, ss_evec, ritz, size_x_old: int, extra: int, mesh=None):
    """Restart growth: append P/W Ritz combinations as new X columns (on a
    grid that splits columns, the rank's columns of both follow each other:
    ``size_x_old`` is a multiple of the split)."""
    new_cols = expand_cols(v, ss_evec[:, size_x_old:size_x_old + extra], mesh,
                           tall_expand)
    return torch.cat([ritz, new_cols], dim=1)


def _grow_basis(v, ss_evec, ritz, ss_eval, size_x: int, extra: int, bs: int,
                mesh=None):
    """Restart growth: ``extra`` P/W Ritz combinations join X; the basis, the
    Ritz values and the projected problem are rebuilt at the new width.
    Returns ``(v, ritz, ss_eval, ss_evec, h, size_x)``."""
    ritz = _expand_ritz(v, ss_evec, ritz, size_x, extra, mesh)
    size_x += extra
    m = size_x + 2 * bs
    v = torch.zeros((v.shape[0], m // col_split(mesh)), dtype=v.dtype,
                    device=v.device)
    v[:, :ritz.shape[1]] = ritz
    ss_eval = torch.cat([ss_eval[:size_x],
                         ss_eval[size_x - 1].expand(2 * bs)])
    ss_evec = torch.eye(m, dtype=v.dtype, device=v.device)
    h = torch.diag(ss_eval)
    h[size_x:, size_x:] = 0.0
    return v, ritz, ss_eval, ss_evec, h, size_x


# --------------------------------------------------------------------------
# host-side convergence / window logic (numpy, as in gcge_tpu)
# --------------------------------------------------------------------------


def _classify(res, lam, tol_abs, tol_rel):
    """Per-column unconverged flags (the reference criterion)."""
    big = np.abs(lam) > tol_rel
    return np.where(big, (res > tol_abs) | (res > np.abs(lam) * tol_rel),
                    res > tol_abs)


def _check_convergence_host(res, ss_eval_h, c0_eff, scan_from, nev_conv_prev,
                            size_x, bs, tol_abs, tol_rel, gap_min,
                            multi_max=None):
    """nevConv and the active window on host scalars: first unconverged
    index, gapMin multiplicity backoff capped at ``multi_max``, then up to
    ``bs`` unconverged indices, extended past the window if fewer."""
    cw = len(res)
    lam_win = ss_eval_h[c0_eff:c0_eff + cw]
    unconv = _classify(res, lam_win, tol_abs, tol_rel)

    idx = cw
    for i in range(scan_from, cw):
        if unconv[i]:
            idx = i
            break
    idx_floor = 0 if multi_max is None else max(idx - multi_max, 0)
    while idx > idx_floor:
        lam_prev = ss_eval_h[c0_eff + idx - 1]
        lam_cur = ss_eval_h[c0_eff + idx]
        denom = abs(lam_prev) if lam_prev != 0 else 1.0
        if abs((lam_prev - lam_cur) / denom) > gap_min:
            break
        idx -= 1
    nev_conv = max(nev_conv_prev, c0_eff + idx)

    act = [c0_eff + i for i in range(scan_from, cw) if unconv[i]]
    nxt = c0_eff + cw
    while len(act) < bs and nxt < size_x:
        act.append(nxt)
        nxt += 1
    if not act:
        act = list(range(min(nev_conv, size_x - 1),
                         min(nev_conv + bs, size_x)))
    act = act[:bs]
    act_cnt = len(act)
    act_padded = act + [act[-1]] * (bs - act_cnt)
    return nev_conv, np.asarray(act_padded, np.int64), act_cnt


def _recount(a_op, b_op, ritz, ss_eval, nev_conv: int, size_x: int, cw: int,
             tol_abs, tol_rel, mesh=None) -> int:
    """``nev_conv`` counted again on the Ritz pairs as they stand: the
    leading run of ``[0, nev_conv)`` whose residuals pass
    :func:`_classify`.  The check counts a pair once it passes and keeps
    it, but a later iteration can move a counted pair off convergence (at a
    block narrower than an eigenvalue cluster, or a residual that was just
    inside the tolerance).  Both loops recount where they would stop and
    go on from the recount while it falls short, and recount once more
    after the loop, so the returned count holds only pairs that pass.  Runs
    over the check's own windows (width ``cw``), with one host read."""
    k = min(nev_conv, size_x)
    if k == 0:
        return 0
    res = []
    for c0 in range(0, k, cw):
        c0_eff = min(c0, size_x - cw)
        res.append(_residual_norms(a_op, b_op, ritz, ss_eval, c0_eff, cw,
                                   mesh)[c0 - c0_eff:])
    res = torch.cat(res)[:k].cpu().numpy()
    unconv = _classify(res, ss_eval[:k].cpu().numpy(), tol_abs, tol_rel)
    return int(np.cumprod(~unconv).sum())


# --------------------------------------------------------------------------
# fused iteration: the same logic in tensor operations on the device
# --------------------------------------------------------------------------


def _check_convergence_traced(res, ss_eval, c0, scan_from, nev_conv_prev,
                              size_x: int, bs: int, tol_abs, tol_rel,
                              gap_min, multi_max: int):
    """:func:`_check_convergence_host` on the device, without a host read:
    ``res`` (cw,) and ``ss_eval`` are tensors, ``c0``, ``scan_from`` and
    ``nev_conv_prev`` 0-d integer tensors.  Returns 0-d ``nev_conv``,
    ``act_idx`` (bs,) int64 and 0-d ``act_cnt``."""
    dev = res.device
    cw = res.shape[0]
    ar = torch.arange(cw, device=dev)
    lam_win = ss_eval.index_select(0, c0 + ar)
    unconv = torch.where(lam_win.abs() > tol_rel,
                         (res > tol_abs) | (res > lam_win.abs() * tol_rel),
                         res > tol_abs)
    # first unconverged index in [scan_from, cw), else cw
    scan_unconv = unconv & (ar >= scan_from)
    idx = torch.where(scan_unconv, ar, cw).min()
    # multiplicity back-off: the largest j <= idx with a real gap at j, over
    # positions 0..cw INCLUSIVE (idx == cw when the whole window converged:
    # the gap test then looks one past the window, as the host loop does)
    ar1 = torch.arange(cw + 1, device=dev)
    last = ss_eval.shape[0] - 1
    lam_m1 = ss_eval.index_select(0, torch.clamp(c0 + ar1 - 1, 0, last))
    lam_cur = ss_eval.index_select(0, torch.clamp(c0 + ar1, 0, last))
    denom = torch.where(lam_m1 != 0, lam_m1.abs(), 1.0)
    gap_ok = ((lam_m1 - lam_cur) / denom).abs() > gap_min
    gap_ok = gap_ok | (ar1 + c0 == 0)     # position 0 has nothing below it
    j = torch.where((ar1 <= idx) & gap_ok, ar1, 0).max()
    j = torch.minimum(j, idx)
    # never back off more than multi_max positions
    j = torch.maximum(j, torch.clamp(idx - multi_max, min=0))
    nev_conv = torch.maximum(nev_conv_prev, c0 + j)
    # active window: unconverged checked columns first, then the sequential
    # tail beyond the window, capped at size_x (larger keys sort behind)
    arb = torch.arange(bs, device=dev)
    win_idx = torch.where(scan_unconv, c0 + ar, size_x + ar)
    tail = c0 + cw + arb
    tail_idx = torch.where(tail < size_x, tail, 2 * size_x + cw + arb)
    cand = torch.sort(torch.cat([win_idx, tail_idx])).values[:bs]
    act_cnt = (cand < size_x).sum()
    # nothing active: the window at nev_conv, cut at size_x.  The count is
    # the host form's (the columns that exist); gcge_tpu's traced form says
    # bs here and repeats the last index, its host form does not
    use_fb = act_cnt == 0
    cand = torch.where(use_fb, torch.clamp(nev_conv + arb, max=size_x - 1),
                       cand)
    fb_cnt = torch.clamp(nev_conv + bs, max=size_x) - \
        torch.clamp(nev_conv, max=size_x - 1)
    act_cnt = torch.where(use_fb, fb_cnt, act_cnt)
    # invalid slots repeat the last valid index
    last_valid = cand.index_select(0, (act_cnt - 1).reshape(1))
    act_idx = torch.clamp(torch.where(arb < act_cnt, cand, last_valid),
                          max=size_x - 1)
    return nev_conv, act_idx, act_cnt


@dataclass
class _FusedState:
    """What one fused iteration hands to the next; every field a tensor on
    the device."""

    v: torch.Tensor          # (n, m) basis [X | P | W] (the rank's part)
    ritz: torch.Tensor       # (n, size_x)
    ss_eval: torch.Tensor    # (m,)
    ss_evec: torch.Tensor    # (m, m)
    h: torch.Tensor          # (m, m)
    act_idx: torch.Tensor    # (bs,) int64: the last active window
    act_cnt: torch.Tensor    # 0-d int64
    nev_conv: torch.Tensor   # 0-d int64
    num_iter: torch.Tensor   # 0-d int64
    stall: torch.Tensor      # 0-d int64
    res: torch.Tensor        # (cw,) the last residual window
    done: torch.Tensor       # 0-d bool: the chunk's stopping condition holds


def _fused_step(a_op, b_op, st: _FusedState, first: bool, nev_target: int,
                size_x: int, bs: int, cg: BlockPCGParams, p: GCGParams,
                stage: Optional[_MixedStage], mesh=None) -> _FusedState:
    """One whole GCG iteration on device tensors: convergence check, P from
    the previous active set, X, W with the new one, Rayleigh-Ritz.  Once
    ``nev_conv >= nev_target`` or two stalls hold, at entry or after this
    step's own check, the iteration is still computed (there is no loop on
    the device to leave) and a select keeps the old state, so the state, the
    counts and ``nev_conv`` equal those of a loop that had stopped there.
    ``first``: the iteration after the start or a restart, which checks
    nothing and has no P; the host knows it."""
    dev, dt = st.v.device, st.v.dtype
    cw = st.res.shape[0]
    arb = torch.arange(bs, device=dev)
    live = ~st.done
    if first:
        nev_conv, res = st.nev_conv, st.res
        act_idx = torch.clamp(nev_conv + arb, max=size_x - 1)
        act_cnt = torch.full_like(st.act_cnt, bs)
        p_blk = torch.zeros((st.v.shape[0], bs // col_split(mesh)), dtype=dt,
                            device=dev)
        p_cnt = torch.zeros_like(st.act_cnt)
        h_pp = torch.zeros((bs, bs), dtype=dt, device=dev)
    else:
        c0 = torch.clamp(st.nev_conv, max=size_x - cw)
        res_new = _residual_norms(a_op, b_op, st.ritz, st.ss_eval, c0, cw,
                                  mesh)
        nev_new, act_idx, act_cnt = _check_convergence_traced(
            res_new, st.ss_eval, c0, st.nev_conv - c0, st.nev_conv, size_x,
            bs, p.tol_abs, p.tol_rel, p.gap_min, p.multi_max)
        nev_conv = torch.where(live, nev_new, st.nev_conv)
        res = torch.where(live, res_new, st.res)
        p_blk, p_cnt, h_pp = _compute_p(
            st.v, st.ss_evec, st.h, st.act_idx, st.act_cnt, size_x, bs,
            p.orth_zero_tol, p.orth_passes, p.orth_method, mesh)
    # this iteration counts (the first one runs whatever nev_conv is, as in
    # the phased loop, where a restart is followed by an iteration)
    go = live if first else live & (nev_conv < nev_target)

    v = torch.empty_like(st.v)
    sxl = st.ritz.shape[1]
    v[:, :sxl] = st.ritz
    v[:, sxl:sxl + p_blk.shape[1]] = p_blk

    sigma = torch.full((), p.cg_shift, dtype=dt, device=dev)
    if p.cg_auto_shift:
        ic = torch.clamp(nev_conv, max=size_x - 2).reshape(1)
        lam_c = st.ss_eval.index_select(0, ic)[0]
        lam_c1 = st.ss_eval.index_select(0, ic + 1)[0]
        sigma = sigma + (-lam_c + 0.01 * (lam_c1 - lam_c))
    v, w_cnt, _, _ = _compute_w(
        a_op, b_op, v, st.ritz, st.ss_eval, act_idx, act_cnt, sigma, size_x,
        bs, cg, p.orth_zero_tol, p.orth_passes, p.cg_order, p.cg_mixed,
        p.cg_refine, p.orth_method, stage=stage, fixed=True,
        linear_solver=p.linear_solver, precond=p.linear_precond, mesh=mesh)
    ss_eval, ss_evec, h, ritz = _rayleigh_ritz(a_op, v, h_pp, st.ss_eval,
                                               p_cnt, w_cnt, size_x, bs,
                                               p.rr_backend, mesh,
                                               _rr_warm(p))

    def keep(new, old):
        return torch.where(go, new, old)

    stalled = (p_cnt == 0) & (w_cnt == 0)
    stall = keep(torch.where(stalled, st.stall + 1, 0), st.stall)
    return _FusedState(
        v=keep(v, st.v), ritz=keep(ritz, st.ritz),
        ss_eval=keep(ss_eval, st.ss_eval), ss_evec=keep(ss_evec, st.ss_evec),
        h=keep(h, st.h), act_idx=keep(act_idx, st.act_idx),
        act_cnt=keep(act_cnt, st.act_cnt), nev_conv=nev_conv,
        num_iter=st.num_iter + go, stall=stall, res=res,
        done=~go | (stall >= 2))


def _gcg_chunk(a_op, b_op, st: _FusedState, first: bool, steps: int,
               nev_target: int, size_x: int, bs: int, cg: BlockPCGParams,
               p: GCGParams, stage: Optional[_MixedStage],
               last: bool = False, mesh=None) -> _FusedState:
    """``steps`` fused iterations, launched without reading solver state back:
    the counterpart of ``gcge_tpu``'s one ``lax.while_loop``.  PyTorch has no
    loop on the device, so every step is launched and those after the stopping
    condition change nothing (:func:`_fused_step`).  ``last``: the chunk that
    spends the iteration budget; it ends with the convergence check of its
    last iterate, which the phased loop makes before it leaves on the budget
    (a step checks only at its start)."""
    for step in range(steps):
        st = _fused_step(a_op, b_op, st, first and step == 0, nev_target,
                         size_x, bs, cg, p, stage, mesh)
    if last:
        cw = st.res.shape[0]
        c0 = torch.clamp(st.nev_conv, max=size_x - cw)
        res = _residual_norms(a_op, b_op, st.ritz, st.ss_eval, c0, cw, mesh)
        nev_conv, _, _ = _check_convergence_traced(
            res, st.ss_eval, c0, st.nev_conv - c0, st.nev_conv, size_x, bs,
            p.tol_abs, p.tol_rel, p.gap_min, p.multi_max)
        # a solve that stopped (converged: checked already; stalled: the
        # phased loop leaves without a check) keeps what it has
        st = replace(st, nev_conv=torch.where(st.done, st.nev_conv, nev_conv),
                     res=torch.where(st.done, st.res, res))
    return st


def _run_fused(a_op, b_op, p: GCGParams, cg: BlockPCGParams, stage, v, ritz,
               ss_eval, ss_evec, h, size_x: int, nev_target: int, mesh=None,
               checkpoint=None, verbose: int = 0):
    """The host loop over fused chunks: one read per chunk, then restart
    growth, the stall stop and the iteration budget, as the phased loop has
    them.  Under a row mesh the read is rank 0's, broadcast, so that no rank
    leaves the loop while another waits in a collective.  ``checkpoint(
    total_iter, ritz, ss_eval, nev_conv)`` runs after every chunk.  Returns
    ``(ss_eval, ritz, size_x, nev_conv, total_iter, res_h, history)``."""
    bs, nev0 = p.block_size, p.nev
    dev, dt = v.device, v.dtype

    def scalar(value):
        return torch.full((), value, dtype=torch.int64, device=dev)

    def fresh_state(v, ritz, ss_eval, ss_evec, h, size_x, nev_conv):
        cw = min(max(p.check_max or 2 * bs, bs), size_x)
        return _FusedState(
            v=v, ritz=ritz, ss_eval=ss_eval, ss_evec=ss_evec, h=h,
            act_idx=torch.clamp(nev_conv + torch.arange(bs, device=dev),
                                max=size_x - 1),
            act_cnt=scalar(bs), nev_conv=scalar(nev_conv),
            num_iter=scalar(0), stall=scalar(0),
            res=torch.zeros(cw, dtype=dt, device=dev),
            done=torch.zeros((), dtype=torch.bool, device=dev))

    st = fresh_state(v, ritz, ss_eval, ss_evec, h, size_x, 0)
    nev_conv = num_iter = 0
    iter_budget = p.max_iter
    res_h = np.zeros((bs,))
    history = []
    while num_iter < iter_budget:
        steps = min(p.fuse, iter_budget - num_iter)
        st = _gcg_chunk(a_op, b_op, st, num_iter == 0, steps, nev_target,
                        size_x, bs, cg, p, stage,
                        last=num_iter + steps >= iter_budget, mesh=mesh)
        # the chunk's one read: three counts and the residual window
        back = torch.cat([torch.stack([st.nev_conv, st.num_iter,
                                       st.stall]).to(dt), st.res])
        if mesh is not None:
            back = mesh.broadcast(back)
        back = back.cpu()
        nev_conv, num_iter, stall = (int(x) for x in back[:3])
        res_h = back[3:].numpy()
        history.append((num_iter, nev_conv))
        _held(st.v, mesh)
        if checkpoint is not None:
            checkpoint(num_iter + (p.max_iter - iter_budget), st.ritz,
                       st.ss_eval, nev_conv)
        if verbose:
            print(f"{num_iter}\t{nev_conv}\t(res window max "
                  f"{res_h.max():.4e})")
        if nev_conv >= nev_target:
            if nev_conv >= nev0 or size_x >= p.nev_max:
                held = _recount(a_op, b_op, st.ritz, st.ss_eval, nev_conv,
                                size_x, st.res.shape[0], p.tol_abs,
                                p.tol_rel, mesh)
                if held == nev_conv:
                    break
                # as the phased loop: the next chunk checks from the recount
                nev_conv = held
                st = replace(st, nev_conv=scalar(held),
                             done=torch.zeros_like(st.done))
                continue
            extra = min(2 * bs, p.nev_max - size_x)
            grown = _grow_basis(st.v, st.ss_evec, st.ritz, st.ss_eval,
                                size_x, extra, bs, mesh)
            size_x = grown[-1]
            nev_target = min(nev_target + extra, nev0)
            st = fresh_state(*grown, nev_conv)
            iter_budget -= num_iter
            num_iter = 0
            if verbose:
                print(f"GCG restart: sizeX -> {size_x}, "
                      f"target -> {nev_target}")
            continue
        if stall >= 2:
            if verbose:
                print("GCG: subspace stagnated (P and W deflated); stopping")
            break
    total_iter = num_iter + (p.max_iter - iter_budget)
    nev_conv = _recount(a_op, b_op, st.ritz, st.ss_eval, nev_conv, size_x,
                        st.res.shape[0], p.tol_abs, p.tol_rel, mesh)
    return st.ss_eval, st.ritz, size_x, nev_conv, total_iter, res_h, history


# --------------------------------------------------------------------------
# solve loop
# --------------------------------------------------------------------------


def _init_fill_orth(b_op, x, zero_tol: float, passes: int, orth_method: str,
                    mesh=None):
    """One InitializeX trial: B-orthonormalize the block, which every rank
    of a grid row holds whole (B on the rank's columns, then gathered)."""
    bmv = None if b_op is None else whole_matvec(b_op.matvec, mesh)
    if col_split(mesh) > 1:
        mesh = mesh.replicated()
    return orth_within(x, bmv, zero_tol=zero_tol, passes=passes,
                       method=orth_method, precision="auto", mesh=mesh)


def _local_rows(x, mesh):
    """The rank's rows of a global ``(n, k)`` block (``x`` without a
    mesh)."""
    if mesh is None:
        return x
    r0, ln = mesh.block(x.shape[0])
    return x[r0:r0 + ln].contiguous()


def _init_x(b_op, x0, size_x: int, n: int, dtype, generator, zero_tol,
            passes, orth_method: str = "evp", mesh=None):
    """InitializeX: keep user vectors, fill with random, B-orthonormalize;
    re-randomize dependent columns until the block has full rank.  Under a
    mesh ``x0`` holds the rank's rows and each random block is the rank's
    rows of one global draw; on a grid that splits columns the rank keeps
    its columns of the orthonormal block."""
    def draw(cols):
        return _local_rows(set_random(generator, (n, cols), dtype), mesh)

    if x0 is not None:
        k0 = x0.shape[1]
        pad = draw(size_x - k0)
        x = torch.cat([x0.to(dtype), pad], dim=1)
    else:
        x = draw(size_x)
    for _ in range(5):
        x, rank = _init_fill_orth(b_op, x, zero_tol, passes, orth_method,
                                  mesh)
        r = int(rank)
        if r == size_x:
            return own_cols(x, mesh)
        x[:, r:] = draw(size_x - r)
    raise RuntimeError("InitializeX: could not build a full-rank "
                       "B-orthonormal block")


def _not_ported(params: GCGParams, mesh) -> None:
    """Raise for what the port does not run: a value that exists for the
    TPU only says so."""
    if mesh is not None and not isinstance(mesh, RowMesh):
        raise TypeError(f"mesh must be a gcge_tpu_torch.parallel.RowMesh "
                        f"(row_mesh()) or GridMesh (grid_mesh()), got "
                        f"{type(mesh).__name__}")
    if params.rr_warm not in ("auto", "struct", "off"):
        raise ValueError(f"unknown rr_warm {params.rr_warm!r}")
    check_backend(params.rr_backend)
    if params.fuse_hotswap not in ("auto", "on", "off"):
        raise ValueError(f"unknown fuse_hotswap {params.fuse_hotswap!r}")
    for name in ("orth_proj_precision", "rr_gemm_precision"):
        value = getattr(params, name)
        if value in ("osgemm", "mixed"):
            raise ValueError(f"{name}={value!r}: the Ozaki GEMMs exist only "
                             f"for the TPU's emulated f64; use 'auto' or "
                             f"'f64'")
        if value not in ("auto", "f64"):
            raise ValueError(f"unknown {name} {value!r}")


def _checkpointer(p: GCGParams, timers, mesh):
    """``save(total_iter, ritz, ss_eval, nev_conv)``: writes the Ritz pairs
    to ``p.checkpoint_path`` once ``p.checkpoint_every`` iterations have
    completed since the last write (``gcge_tpu``'s rule); under a mesh
    every rank gathers the rows (and a grid's columns) and the mesh's lead
    rank writes.  None without a path."""
    if not p.checkpoint_path or p.checkpoint_every <= 0:
        return None
    from gcge_tpu_torch.utils.checkpoint import save_checkpoint

    last = [0]

    def save(total_iter, ritz, ss_eval, nev_conv):
        if total_iter - last[0] < p.checkpoint_every:
            return
        last[0] = total_iter
        evec = ritz if mesh is None else \
            gather_rows(mesh, gather_cols(ritz, mesh))
        if mesh is None or mesh.lead:
            save_checkpoint(p.checkpoint_path, GCGResult(
                eval=ss_eval[:ritz.shape[1]].cpu().numpy(), evec=evec,
                nev_conv=int(nev_conv), num_iter=int(total_iter),
                res_norms=np.zeros(0), timers=dict(timers)), p)
    return save


@contextlib.contextmanager
def _profiled(profile_dir, device: torch.device, mesh):
    """A ``torch.profiler`` run around the solve (the host's activity, and
    the card's where the solve runs on one), written as a Chrome trace into
    ``profile_dir`` (``gcg_trace.json``; under a mesh one file a rank):
    the counterpart of ``jax.profiler.start_trace``."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    name = "gcg_trace.json" if mesh is None else \
        f"gcg_trace_rank{mesh.peers[mesh.rank]}.json"
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, name))


def gcg_solve(a_op, b_op=None, params: GCGParams = GCGParams(),
              x0: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              mesh: Optional[RowMesh] = None) -> GCGResult:
    """Solve ``A x = lambda B x`` for the ``params.nev`` smallest eigenpairs
    on the operators' device, by the phased loop or, with ``params.fuse >
    0``, by the fused one (chunks of ``fuse`` iterations without a host read;
    it reports the total time and one history entry per chunk, no phase
    timers).

    ``x0``: optional ``(n, k)`` starting vectors (numpy or tensor); the rest
    of the block is drawn from ``generator`` (default: seed 0 on the
    device).  ``mesh``: a row mesh (:func:`gcge_tpu_torch.parallel.row_mesh`)
    with operators from :func:`gcge_tpu_torch.parallel.shard_operator`; every
    rank of it calls ``gcg_solve`` with the same arguments, ``x0`` global,
    and gets its rows of the Ritz vectors in ``evec``.  ``params.profile_dir``
    writes a Chrome trace of the solve, ``params.checkpoint_path`` the Ritz
    pairs every ``params.checkpoint_every`` iterations.  ``mesh`` may be a
    grid (:func:`gcge_tpu_torch.parallel.grid_mesh`), with the operators
    sharded over it: ``evec`` is then the rank's rows and, where the solve
    splits columns, its columns ``j % n_cols == col`` of them."""
    _not_ported(params, mesh)
    with _profiled(params.profile_dir, a_op.device, mesh):
        return _gcg_solve(a_op, b_op, params, x0, generator, mesh)


def _gcg_solve(a_op, b_op, params: GCGParams, x0, generator, mesh
               ) -> GCGResult:
    n = a_op.shape[0]
    p = params.resolved(n)
    bs, nev0 = p.block_size, p.nev
    if col_split(mesh) > 1 and any(k % mesh.col_split for k in (
            p.nev_init, p.nev_max, bs, max(p.check_max or 2 * bs, bs))):
        # a width of the solve (the initial and the largest X, the block,
        # the residual window) does not split: every column on every rank
        # of a grid row
        mesh = mesh.replicated()
    # under a mesh, its lead rank prints
    verbose = p.verbose if mesh is None or mesh.lead else 0
    size_x = p.nev_init
    dtype = p.dtype
    device = a_op.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    cg = BlockPCGParams(max_iter=p.cg_max_iter, rate=p.cg_rate, tol=p.cg_tol,
                        tol_type=p.cg_tol_type)
    fused = p.fuse > 0
    stage = None
    t_start = time.perf_counter()
    if p.cg_mixed and p.linear_solver is None:
        if b_op is not None and not isinstance(b_op, DiagOperator):
            raise ValueError("cg_mixed requires B = None or diagonal")
        stage_cg = cg if p.cg_refine <= 1 else replace(
            cg, max_iter=-(-cg.max_iter // p.cg_refine))
        # the fused loop's stages run their whole budget and, on a card,
        # run as one captured graph
        stage = _MixedStage(a_op, b_op, stage_cg, bs // col_split(mesh),
                            fixed=fused,
                            capture=fused and device.type == "cuda",
                            precond=p.linear_precond, mesh=mesh)
        if stage.apply32 is None:
            stage = None
    timers = {k: 0.0 for k in ("initX", "checkconv", "compP", "compX",
                               "compW", "linsol", "compRR", "compRV",
                               "total")}
    # building the f32 operator and, on a card, capturing the stage's graph
    timers["stage"] = time.perf_counter() - t_start
    if verbose and stage is not None and stage.capture_error:
        print(f"GCG: the card refused to capture the CG stage under the "
              f"mesh; it runs eager ({stage.capture_error})")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        sync()
        timers[name] += time.perf_counter() - t0
        return out

    # ---- InitializeX + first RR -----------------------------------------
    if x0 is not None:
        x0 = _local_rows(torch.as_tensor(x0, dtype=dtype, device=device),
                         mesh)
    x = timed("initX", _init_x, b_op, x0, size_x, n, dtype, generator,
              p.orth_zero_tol, p.orth_passes, p.orth_method, mesh)
    m = size_x + 2 * bs
    v = torch.zeros((x.shape[0], m // col_split(mesh)), dtype=dtype,
                    device=device)
    v[:, :x.shape[1]] = x
    ss_eval, ss_evec, h, ritz, v = timed("compRR", _initial_rr, a_op, v,
                                         size_x, bs, p.rr_backend, mesh)
    checkpoint = _checkpointer(p, timers, mesh)

    nev_target = nev0 if size_x >= p.nev_max else min(2 * bs, nev0)
    if verbose:
        print(f"GCG: n={n} nev={nev0} bs={bs} sizeX={size_x} "
              f"nevMax={p.nev_max}")
        print("numIter\tnevConv")
    if fused:
        ss_eval, ritz, size_x, nev_conv, total_iter, res_h, history = \
            _run_fused(a_op, b_op, p, cg, stage, v, ritz, ss_eval, ss_evec,
                       h, size_x, nev_target, mesh, checkpoint, verbose)
        sync()
        timers["total"] = time.perf_counter() - t_start
        if verbose:
            print(f"GCG: {total_iter} iterations in {len(history)} fused "
                  f"chunks, nevConv={nev_conv}, {timers['total']:.3f} s "
                  f"(CG stage set-up {timers['stage']:.3f} s, initX "
                  f"{timers['initX']:.3f} s)")
        return GCGResult(eval=ss_eval[:size_x].cpu().numpy(), evec=ritz,
                         nev_conv=nev_conv, num_iter=total_iter,
                         res_norms=res_h, timers=timers, history=history)

    nev_conv = 0
    act_idx_prev = None
    act_cnt_prev = 0
    num_iter = 0
    iter_budget = p.max_iter
    history = []
    res_h = np.zeros((bs,))
    skip_p = True  # no P on the first iteration
    stall = 0

    while True:
        # ---- CheckConvergence ------------------------------------------
        cw = min(max(p.check_max or 2 * bs, bs), size_x)
        if num_iter > 0:
            c0 = nev_conv
            c0_eff = min(c0, size_x - cw)
            scan_from = c0 - c0_eff
            res = timed("checkconv", _residual_norms, a_op, b_op, ritz,
                        ss_eval, c0_eff, cw, mesh)
            res_h = res.cpu().numpy()
            ss_eval_h = ss_eval.cpu().numpy()
            nev_conv, act_idx, act_cnt = _check_convergence_host(
                res_h, ss_eval_h, c0_eff, scan_from, nev_conv, size_x, bs,
                p.tol_abs, p.tol_rel, p.gap_min, p.multi_max)
            if verbose:
                first_unconv = nev_conv if nev_conv < size_x else size_x - 1
                print(f"{num_iter}\t{nev_conv}\t"
                      f"[{first_unconv}] {ss_eval_h[first_unconv]:.14e} "
                      f"(res window max {res_h.max():.4e})")
            history.append((num_iter, nev_conv))
            if checkpoint is not None:
                checkpoint(num_iter + (p.max_iter - iter_budget), ritz,
                           ss_eval, nev_conv)
        else:
            ss_eval_h = ss_eval.cpu().numpy()
            act_idx = np.minimum(np.arange(nev_conv, nev_conv + bs),
                                 size_x - 1)
            act_cnt = bs

        # ---- converged / restart growth ----------------------------------
        if nev_conv >= nev_target:
            if nev_conv >= nev0 or size_x >= p.nev_max:
                held = _recount(a_op, b_op, ritz, ss_eval, nev_conv, size_x,
                                cw, p.tol_abs, p.tol_rel, mesh)
                if held == nev_conv:
                    break
                # a counted pair fails now: check again from the recount
                nev_conv = held
                continue
            extra = min(2 * bs, p.nev_max - size_x)
            v, ritz, ss_eval, ss_evec, h, size_x = _grow_basis(
                v, ss_evec, ritz, ss_eval, size_x, extra, bs, mesh)
            nev_target = min(nev_target + extra, nev0)
            ss_eval_h = ss_eval.cpu().numpy()
            iter_budget -= num_iter
            num_iter = 0
            skip_p = True
            act_idx = np.minimum(np.arange(nev_conv, nev_conv + bs),
                                 size_x - 1)
            act_cnt = bs
            if verbose:
                print(f"GCG restart: sizeX -> {size_x}, "
                      f"target -> {nev_target}")

        if num_iter >= iter_budget:
            break

        # ---- ComputeP (previous iteration's active set) ------------------
        sxl, bsl = size_x // col_split(mesh), bs // col_split(mesh)
        if skip_p or act_idx_prev is None:
            p_cnt = 0
            h_pp = torch.zeros((bs, bs), dtype=dtype, device=device)
            v[:, sxl:sxl + bsl] = 0.0
            skip_p = False
        else:
            p_blk, p_cnt, h_pp = timed(
                "compP", _compute_p, v, ss_evec, h,
                torch.as_tensor(act_idx_prev, device=device), act_cnt_prev,
                size_x, bs, p.orth_zero_tol, p.orth_passes, p.orth_method,
                mesh)
            v[:, sxl:sxl + bsl] = p_blk

        # ---- ComputeX ----------------------------------------------------
        v = timed("compX", _set_x, v, ritz, size_x)

        # ---- ComputeW ----------------------------------------------------
        sigma = p.cg_shift
        if p.cg_auto_shift:
            lam_c = ss_eval_h[min(nev_conv, size_x - 2)]
            lam_c1 = ss_eval_h[min(nev_conv + 1, size_x - 1)]
            sigma += float(-lam_c + 0.01 * (lam_c1 - lam_c))
        t0 = time.perf_counter()
        v, w_cnt, cg_iters, cg_res = _compute_w(
            a_op, b_op, v, ritz, ss_eval,
            torch.as_tensor(act_idx, device=device), act_cnt, sigma,
            size_x, bs, cg, p.orth_zero_tol, p.orth_passes, p.cg_order,
            p.cg_mixed, p.cg_refine, p.orth_method, stage=stage,
            linear_solver=p.linear_solver, precond=p.linear_precond,
            mesh=mesh)
        sync()
        timers["compW"] += time.perf_counter() - t0
        timers["linsol"] += time.perf_counter() - t0

        act_idx_prev, act_cnt_prev = act_idx, act_cnt

        # ---- RayleighRitz + RitzVec ---------------------------------------
        ss_eval, ss_evec, h, ritz = timed(
            "compRR", _rayleigh_ritz, a_op, v, h_pp, ss_eval, p_cnt, w_cnt,
            size_x, bs, p.rr_backend, mesh, _rr_warm(p))

        p_cnt_h, w_cnt_h = int(p_cnt), int(w_cnt)
        _held(v, mesh)
        if verbose >= 2:
            print(f"  dbg: p_cnt={p_cnt_h} w_cnt={w_cnt_h} "
                  f"cg_iters={cg_iters} sigma={sigma:.3e} "
                  f"cg_res_max={float(cg_res.max()):.3e} "
                  f"act={act_idx[:act_cnt]}")

        # stagnation guard: P and W both deflated -> the subspace is fixed
        if p_cnt_h == 0 and w_cnt_h == 0:
            stall += 1
            if stall >= 2:
                if verbose:
                    print("GCG: subspace stagnated (P and W deflated); "
                          "stopping")
                num_iter += 1
                break
        else:
            stall = 0
        num_iter += 1

    nev_conv = _recount(a_op, b_op, ritz, ss_eval, nev_conv, size_x, cw,
                        p.tol_abs, p.tol_rel, mesh)
    timers["total"] = time.perf_counter() - t_start
    total_iter = num_iter + (p.max_iter - iter_budget)
    if verbose:
        keys = ("checkconv", "compP", "compRR", "compRV", "compW", "compX",
                "initX")
        tt = max(timers["total"], 1e-12)
        print("|--GCG----------------------------")
        print("|checkconv  compP  compRR  compRV  compW(linsol)  compX  "
              "initX  total")
        print("|" + "  ".join(f"{timers[k]:.2f}" for k in keys + ("total",)))
        print("|" + "  ".join(f"{100 * timers[k] / tt:.1f}%" for k in keys))
        print("|--GCG----------------------------")
        print(f"GCG: {total_iter} iterations, nevConv={nev_conv}, "
              f"{timers['total']:.3f} s")
    return GCGResult(eval=ss_eval[:size_x].cpu().numpy(), evec=ritz,
                     nev_conv=int(nev_conv), num_iter=int(total_iter),
                     res_norms=res_h, timers=timers, history=history)
