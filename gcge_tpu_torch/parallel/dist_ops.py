"""Row-sharded operators — the counterpart of
``gcge_tpu/parallel/dist_ops.py``.

A :class:`RowShardedOperator` holds its rank's rows of a global operator and
applies them to the rank's rows of a multivector.  The reference's
distributed SpMM (PHG, ``app_phg.c:292-359``) exchanges the halo of x with
its neighbours and multiplies locally; ``gcge_tpu`` does the same under
``shard_map`` with ``ppermute``.  Here:

* **DIA**: rank ``r`` needs ``hl = -min(off)`` rows of its left neighbour
  and ``hr = max(off)`` of its right one.  The window ``[left halo | own
  rows | right halo]``, ``(ln + hl + hr, m)`` and contiguous, is assembled by
  one ``batch_isend_irecv`` (zeros past the ends of the matrix), and kernel
  1 (f64) or 2 (f32) runs on it with ``halo=(hl, hr)``.  In the transposed
  layout of the mixed inner CG, ``(m, ln)`` in shape and ``(ln, m)`` in
  memory, the window is built in that memory order and handed over as its
  transpose, so the stage's one memory order holds.
* **CSR**: a local CSR of the rank's rows whose columns index the same window
  ``[r0 - hl, r0 + ln + hr)``, ``hl``/``hr`` the band of the whole matrix;
  kernels 5 and 6 run on it unchanged (``CsrOperator`` takes ``n_cols !=
  n_rows``).  The counterpart of ``OneHotShardPack`` and
  ``pack_onehot_sharded`` (``gcge_tpu/ops/onehot_pallas.py:712``).
* Where the band is wider than a rank's block (``hl > ln`` or ``hr > ln``),
  the window is a slice of the ``all_gather``ed x instead, as ``gcge_tpu``
  decides (``dist_ops.py:206``, ``halo_ok``); with one rank it is x between
  zeros, as ``gcge_tpu``'s one-device branch has it.
* **Hybrid**: the DIA core on the halo path, the CSR remainder on the
  ``all_gather`` window (its columns are arbitrary by construction).
* **ELL** and **Dense**: the local rows against the ``all_gather``ed x.
* **Diag** and **Identity** need no communication: :func:`shard_operator`
  returns the plain operator of the rank's rows.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from gcge_tpu_torch.ops.onehot import CsrOperator
from gcge_tpu_torch.ops.operators import (DenseOperator, DiagOperator,
                                          DiaOperator, HybridOperator,
                                          IdentityOperator, LinearOperator,
                                          SparseOperator, _np_dtype)
from gcge_tpu_torch.ops.spmm import dia_spmm
from gcge_tpu_torch.parallel.mesh import RowMesh

# local products of the sharded DIA and CSR operators on a card, through the
# window, by kernel: the windowed path's share of ops.spmm.LAUNCHES and
# ops.onehot.LAUNCHES
WINDOWED = {"dia_f64": 0, "dia_f32": 0, "csr_f64": 0, "csr_f32": 0}
# products of the sharded AMG transfers on a card (``dist_mg``), one kernel-6
# launch each: their share of ops.onehot.LAUNCHES["csr_f64"]
TRANSFERS = {"prolong": 0, "restrict": 0}
# products of the sharded operators on any device, by the number of columns
# they ran on (on a grid that splits columns: the rank's columns of a block)
WIDTHS = {}
# the shape of the rank's part of the basis V at the end of the last
# iteration of a distributed GCG solve (solvers.gcg)
HELD = {"basis": None}


def halo_window(mesh: RowMesh, xn: torch.Tensor, hl: int, hr: int,
                gather: bool) -> torch.Tensor:
    """The window of global rows ``[r0 - hl, r0 + ln + hr)`` of the
    multivector whose rows ``[r0, r0 + ln)`` this rank holds as ``xn``
    (``(ln, m)``, any strides): a contiguous ``(ln + hl + hr, m)`` with zeros
    past the ends of the matrix.  ``gather``: from the ``all_gather``ed x,
    else from the two neighbours' halos (one ``batch_isend_irecv``)."""
    ln, m = xn.shape
    w = torch.empty((ln + hl + hr, m), dtype=xn.dtype, device=xn.device)
    if gather and mesh.world > 1:
        full = mesh.gather(xn)
        r0 = mesh.rank * ln
        lo, hi = max(r0 - hl, 0), min(r0 + ln + hr, full.shape[0])
        w.zero_()
        w[lo - (r0 - hl):hi - (r0 - hl)] = full[lo:hi]
        return w
    w[hl:hl + ln] = xn
    first, last = mesh.rank == 0, mesh.rank == mesh.world - 1
    if hl and first:
        w[:hl] = 0
    if hr and last:
        w[hl + ln:] = 0
    ops = []
    if not first:        # the left neighbour: its last hl rows, my first hr
        left = mesh.peers[mesh.rank - 1]
        if hl:
            ops.append(dist.P2POp(dist.irecv, w[:hl], left, mesh.group))
        if hr:
            ops.append(dist.P2POp(dist.isend, w[hl:hl + hr], left,
                                  mesh.group))
    if not last:         # the right neighbour: my last hl rows, its first hr
        right = mesh.peers[mesh.rank + 1]
        if hl:
            ops.append(dist.P2POp(dist.isend, w[ln:ln + hl], right,
                                  mesh.group))
        if hr:
            ops.append(dist.P2POp(dist.irecv, w[hl + ln:], right,
                                  mesh.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return w


class RowShardedOperator(LinearOperator):
    """A global ``n x n`` operator of which this rank holds the rows
    ``[r0, r0 + ln)``; ``matvec`` maps the rank's rows of x to its rows of
    ``A x`` (every rank calls it: it communicates).

    ``kind`` is ``'dia'`` (``local``: the value rows ``(ndiag, ln)`` as a
    :class:`DiaOperator`), ``'csr'`` (``local``: a :class:`CsrOperator` of
    ``ln`` rows over the window's ``ln + hl + hr`` columns), ``'hybrid'``
    (``local``: the DIA part and ``rest``, both sharded), ``'ell'`` or
    ``'dense'`` (``local``: the rank's rows over the global columns).
    ``gather``: the window comes from the ``all_gather``ed x."""

    def __init__(self, kind: str, local, mesh: RowMesh, n: int, hl: int = 0,
                 hr: int = 0, gather: bool = False, rest=None):
        self.kind, self.local, self.mesh = kind, local, mesh
        self.n, self.hl, self.hr = int(n), int(hl), int(hr)
        self.gather, self.rest = bool(gather), rest

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.mesh.device

    def _window(self, xn):
        return halo_window(self.mesh, xn, self.hl, self.hr, self.gather)

    def _count(self, kind: str, dtype) -> None:
        if self.mesh.device.type == "cuda":
            WINDOWED[f"{kind}_{'f64' if dtype == torch.float64 else 'f32'}"] \
                += 1

    def _apply(self, x, transposed: bool):
        xn = x.T if transposed else x
        if self.kind == "hybrid":
            y = self.local._apply(x, transposed)
            return y if self.rest is None else \
                y + self.rest._apply(x, transposed)
        if self.kind in ("ell", "dense"):
            y = self.local.matvec(self.mesh.gather(xn))
            return y.T if transposed else y
        w = self._window(xn)
        self._count(self.kind, x.dtype)
        if self.kind == "dia":
            return dia_spmm(self.local.values, self.local.offsets_t,
                            w.T if transposed else w, transposed,
                            halo=(self.hl, self.hr))
        return self.local.matvec_t(w.T) if transposed else \
            self.local.matvec(w)

    def matvec(self, x):
        """``x (ln, m) -> (A x)[r0:r0 + ln] (ln, m)``."""
        WIDTHS[x.shape[1]] = WIDTHS.get(x.shape[1], 0) + 1
        return self._apply(x, False)

    def matvec_t(self, xt):
        """The transposed layout: ``xt (m, ln) -> (m, ln)``, in the memory
        order of ``xt``."""
        WIDTHS[xt.shape[0]] = WIDTHS.get(xt.shape[0], 0) + 1
        return self._apply(xt, True)

    def astype(self, dtype) -> "RowShardedOperator":
        """The same operator on values of ``dtype`` (the f32 form of the
        mixed inner CG; a CSR part converts its values at first use)."""
        local = self.local
        if self.kind == "hybrid":
            local = local.astype(dtype)
        elif self.kind == "dia":
            local = DiaOperator(local.values.to(dtype), local.offsets,
                                local.n_cols)
        elif self.kind == "ell":
            local = SparseOperator(local.values.to(dtype), local.indices,
                                   local.n_cols)
        return RowShardedOperator(self.kind, local, self.mesh, self.n,
                                  self.hl, self.hr, self.gather, self.rest)


def _halo_ok(mesh: RowMesh, hl: int, hr: int, ln: int) -> bool:
    return mesh.world == 1 or (hl <= ln and hr <= ln)


def window_csr(mesh: RowMesh, rowptr, colidx, values, n: int, hl: int,
               hr: int, dtype, gather: bool = False) -> RowShardedOperator:
    """The sharded CSR operator from this rank's rows as host CSR
    (``rowptr`` from 0, ``colidx`` global), whose columns are then
    re-indexed into the window ``[r0 - hl, r0 + ln + hr)``."""
    r0, ln = mesh.block(n)
    colidx = np.asarray(colidx, np.int64) - (r0 - hl)
    if len(colidx) and (colidx.min() < 0 or colidx.max() >= ln + hl + hr):
        raise ValueError("a column lies outside the rank's window")
    dev = mesh.device
    local = CsrOperator(
        torch.as_tensor(np.asarray(rowptr, np.int32), device=dev),
        torch.as_tensor(colidx.astype(np.int32), device=dev),
        torch.as_tensor(np.asarray(values).astype(_np_dtype(dtype)),
                        device=dev), ln + hl + hr)
    return RowShardedOperator("csr", local, mesh, n, hl, hr,
                              gather or not _halo_ok(mesh, hl, hr, ln))


def _shard_csr(op: CsrOperator, mesh: RowMesh, gather: bool = False):
    n = op.shape[0]
    r0, ln = mesh.block(n)
    rowptr = op.rowptr.cpu().numpy().astype(np.int64)
    colidx = op.colidx.cpu().numpy()
    rows = np.repeat(np.arange(n), np.diff(rowptr))
    band = colidx.astype(np.int64) - rows
    hl = max(0, -int(band.min())) if len(band) else 0
    hr = max(0, int(band.max())) if len(band) else 0
    lo, hi = rowptr[r0], rowptr[r0 + ln]
    return window_csr(mesh, rowptr[r0:r0 + ln + 1] - lo, colidx[lo:hi],
                      op.values.cpu().numpy()[lo:hi], n, hl, hr, op.dtype,
                      gather)


def window_dia(mesh: RowMesh, values: torch.Tensor, offsets,
               n: int) -> RowShardedOperator:
    """The sharded DIA operator from this rank's value rows ``(ndiag,
    ln)`` (``values[d, i] = A[r0 + i, r0 + i + offsets[d]]``, zero where
    that column lies outside the matrix)."""
    r0, ln = mesh.block(n)
    offsets = tuple(int(o) for o in offsets)
    hl, hr = max(0, -min(offsets)), max(0, max(offsets))
    local = DiaOperator(values.to(mesh.device).contiguous(), offsets,
                        ln + hl + hr)
    return RowShardedOperator("dia", local, mesh, n, hl, hr,
                              not _halo_ok(mesh, hl, hr, ln))


def shard_operator(op, mesh: RowMesh):
    """This rank's rows of the global operator ``op`` (any device), on the
    mesh's device: a :class:`RowShardedOperator`, or for a diagonal or
    identity operator the plain operator of the rank's rows.  ``None`` stays
    ``None``.  On a grid (:class:`~gcge_tpu_torch.parallel.GridMesh`) the
    rows are split over the rank's row group (``mesh.rows``), so each row
    block is replicated along the grid's columns."""
    if op is None or isinstance(op, RowShardedOperator):
        return op
    mesh = getattr(mesh, "rows", mesh)
    n = op.shape[0]
    r0, ln = mesh.block(n)
    dev = mesh.device
    if isinstance(op, DiaOperator):
        return window_dia(mesh, op.values[:, r0:r0 + ln], op.offsets, n)
    if isinstance(op, CsrOperator):
        return _shard_csr(op, mesh)
    if isinstance(op, HybridOperator):
        dia = shard_operator(op.dia, mesh)
        rest = None if op.rest is None else _shard_csr(op.rest, mesh,
                                                       gather=True)
        return RowShardedOperator("hybrid", dia, mesh, n, rest=rest)
    if isinstance(op, SparseOperator):
        local = SparseOperator(op.values[r0:r0 + ln].to(dev),
                               op.indices[r0:r0 + ln].to(dev), op.n_cols)
        return RowShardedOperator("ell", local, mesh, n)
    if isinstance(op, DenseOperator):
        return RowShardedOperator("dense",
                                  DenseOperator(op.a[r0:r0 + ln].to(dev)),
                                  mesh, n)
    if isinstance(op, DiagOperator):
        return DiagOperator(op.d[r0:r0 + ln].to(dev))
    if isinstance(op, IdentityOperator):
        return IdentityOperator(ln, op.dtype, dev)
    raise NotImplementedError(f"shard_operator: {type(op).__name__}")
