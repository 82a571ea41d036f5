"""Irregular SpMM: the counterpart of ``gcge_tpu/ops/onehot_pallas.py``.

``gcge_tpu`` turns the irregular sparse product into MXU matmuls against
one-hot matrices, packed per (row-tile, column-window) pair, because the TPU
has no gather, and splits values into bf16/f32 planes because it has no f64.
Hopper has both, so the port keeps the function and drops the layout: the
matrix is plain CSR (``rowptr``, ``colidx`` int32, ``values``), packed once
on the host and sorted by (row, column).

* :func:`csr_spmm` computes ``y = A x`` in two layouts, ``x`` of shape
  ``(n, m)`` or ``(m, n)`` (``transposed=True``), and returns it in the
  memory order of ``x``.  On a CUDA tensor it launches kernel 5 (f32) or
  kernel 6 (f64) of ``csrc/csr_spmm.cu``; on a CPU tensor it runs
  :func:`csr_spmm_reference`, the plain PyTorch version.  Both kernels work
  in row tiles planned once per matrix on the host (:func:`csr_tiles`,
  :func:`csr_plan`): the plan depends on ``rowptr`` alone and serves both.
* :class:`CsrOperator` is the operator on top of it.
* :func:`onehot_mask_probe` / :func:`bf16_mask_supported` are the counterpart
  of the TPU's one-hot mask probe (kernel 7, ``csrc/mask_probe.cu``).

Not carried over, because they describe the TPU layout and not the function:
``pack_onehot``, ``pack_onehot_stats``, ``regroup_pairs``, the mask-mode
knob, the bf16 planes, the Dekker products and the integer slices.  The
counterpart of ``pack_onehot_sharded`` (a rank's rows re-indexed into its
halo window) is :func:`gcge_tpu_torch.parallel.dist_ops.window_csr`: a
:class:`CsrOperator` with more columns than rows, on the same kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gcge_tpu_torch.ops import _build
from gcge_tpu_torch.ops.operators import LinearOperator, _np_dtype
from gcge_tpu_torch.ops.spmm import (empty_in_order_of, in_order_of,
                                     row_fast, vec_width)

# launches of the CUDA kernels since the last reset, by kernel
LAUNCHES = {"csr_f32": 0, "csr_f64": 0, "mask_probe": 0}

_INT32_MAX = 2 ** 31 - 1
MASK_SHAPE = (8, 128)
# the row tiles of kernels 5 and 6: entries of colidx and values a block
# stages (8 bytes each in shared memory in f32, 12 in f64), and rows a tile
# holds at most
CSR_BUDGET = 1024
CSR_MAX_ROWS = 64
_ALIGN = 4             # entries of a 16-byte copy


def pack_csr(rows, cols, vals, shape):
    """COO triplets to CSR on the host: ``(rowptr, colidx, values)`` as numpy
    arrays, int32 indices, entries sorted by (row, column).  Duplicate entries
    are kept and therefore summed by the product."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    n_rows, n_cols = shape
    if max(n_rows, n_cols, len(vals)) > _INT32_MAX:
        raise ValueError(f"shape {shape} with {len(vals)} nonzeros does not "
                         "fit int32 CSR indices")
    if len(rows) and (rows.min() < 0 or rows.max() >= n_rows
                      or cols.min() < 0 or cols.max() >= n_cols):
        raise ValueError(f"COO indices outside shape {shape}")
    order = np.lexsort((cols, rows))
    rowptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=rowptr[1:])
    return (rowptr.astype(np.int32), cols[order].astype(np.int32),
            vals[order])


def _row_ids(rowptr: torch.Tensor, nnz: int) -> torch.Tensor:
    counts = (rowptr[1:] - rowptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(rowptr.shape[0] - 1, device=rowptr.device), counts,
        output_size=nnz)


def csr_tiles(rowptr: np.ndarray, budget: int = CSR_BUDGET,
              max_rows: int = CSR_MAX_ROWS) -> np.ndarray:
    """The row tiles of kernels 5 and 6 for CSR ``rowptr`` (n+1,): the first
    row of each tile, then n, as int32.  A tile is a range of at most ``max_rows`` whole
    rows whose entries, widened to 16-byte boundaries (``[rowptr[r0] // 4 *
    4, ceil4(rowptr[r1]))``), fit ``budget`` entries; a row whose entries do
    not is a tile of its own, which the kernel streams in chunks.  Greedy
    from the first row, so every row lies in exactly one tile."""
    if budget <= 0 or budget % _ALIGN or max_rows <= 0:
        raise ValueError(f"csr_tiles: budget {budget} (a positive multiple "
                         f"of {_ALIGN}) and max_rows {max_rows} > 0 expected")
    rowptr = np.asarray(rowptr, dtype=np.int64)
    n = len(rowptr) - 1
    starts = [0]
    r0 = 0
    while r0 < n:
        limit = rowptr[r0] // _ALIGN * _ALIGN + budget
        # the last row boundary within the budget (a multiple of 4, so that
        # rowptr[r1] <= limit also bounds its 16-byte ceiling)
        r1 = int(np.searchsorted(rowptr, limit, side="right")) - 1
        r1 = max(r0 + 1, min(r1, r0 + max_rows, n))
        starts.append(r1)
        r0 = r1
    return np.asarray(starts, dtype=np.int32)


@dataclass(frozen=True)
class CsrPlan:
    tiles: torch.Tensor   # (ntiles + 1,) int32 on the card: csr_tiles
    budget: int           # entries a block stages


def csr_plan(rowptr: torch.Tensor) -> CsrPlan:
    """The launch plan of kernels 5 and 6 for ``rowptr``, on its device (the
    same for both: it depends on ``rowptr`` alone).  It reads
    ``rowptr`` to the host and copies the tiles back: build it once per
    matrix (:class:`CsrOperator` does, when it is built), never while a CUDA
    graph is being captured."""
    tiles = csr_tiles(rowptr.cpu().numpy())
    return CsrPlan(torch.as_tensor(tiles, device=rowptr.device), CSR_BUDGET)


def csr_spmm_reference(rowptr: torch.Tensor, colidx: torch.Tensor,
                       values: torch.Tensor, x: torch.Tensor,
                       transposed: bool = False) -> torch.Tensor:
    """Plain PyTorch CSR SpMM: gather ``x[colidx] * values``, then a sum over
    each row's entries (``index_add_``), on the logical ``(n_cols, m)`` view
    of ``x``; the result in the memory order of ``x``, as :func:`csr_spmm`
    returns it."""
    xn = x.T if transposed else x
    n = rowptr.shape[0] - 1
    contrib = values[:, None] * xn[colidx.long()]
    y = torch.zeros((n, xn.shape[1]), dtype=x.dtype, device=x.device)
    y.index_add_(0, _row_ids(rowptr, values.shape[0]), contrib)
    return in_order_of(y.T if transposed else y, x)


def csr_spmm(rowptr: torch.Tensor, colidx: torch.Tensor,
             values: torch.Tensor, x: torch.Tensor,
             transposed: bool = False, plan: CsrPlan | None = None
             ) -> torch.Tensor:
    """``A x`` for CSR ``rowptr`` (n+1,) and ``colidx`` (nnz,) int32 and
    ``values`` (nnz,) of the dtype of ``x``.

    ``x`` is ``(n_cols, m)``, or ``(m, n_cols)`` when ``transposed``, with any
    strides; every ``colidx`` must be below ``n_cols`` (the packers check
    it).  The result is ``(n, m)`` or ``(m, n)``, freshly allocated, in the
    memory order of ``x``: like ``torch.empty_like(x)`` for a dense ``x``,
    else contiguous in the logical layout (``spmm.empty_in_order_of``).
    ``plan``: the row tiles for this ``rowptr`` (:func:`csr_plan`), which a
    product on a card needs."""
    if x.dim() != 2:
        raise ValueError(f"csr_spmm: x must be 2-D, got {tuple(x.shape)}")
    if rowptr.dim() != 1 or rowptr.shape[0] < 1 or colidx.dim() != 1 or \
            values.shape != colidx.shape:
        raise ValueError("csr_spmm: rowptr (n+1,), colidx (nnz,) and values "
                         "(nnz,) expected")
    if not (rowptr.device == colidx.device == values.device == x.device):
        raise ValueError("csr_spmm: rowptr, colidx, values and x must share "
                         "a device")
    if x.device.type == "cpu":
        return csr_spmm_reference(rowptr, colidx, values, x, transposed)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmm: unsupported device {x.device}")
    if x.dtype not in (torch.float64, torch.float32) or \
            values.dtype != x.dtype:
        raise TypeError(f"csr_spmm: values {values.dtype} and x {x.dtype} "
                        f"must both be float64 or both float32")
    if rowptr.dtype != torch.int32 or colidx.dtype != torch.int32:
        raise TypeError("csr_spmm: rowptr and colidx must be int32")
    if not (rowptr.is_contiguous() and colidx.is_contiguous()
            and values.is_contiguous()):
        raise ValueError("csr_spmm: rowptr, colidx and values must be "
                         "contiguous")
    n = rowptr.shape[0] - 1
    nnz = values.shape[0]
    m = x.shape[0] if transposed else x.shape[1]
    if max(n, nnz, x.shape[1 if transposed else 0]) > _INT32_MAX:
        raise ValueError("csr_spmm: the matrix does not fit int32 indices")
    y = empty_in_order_of(x, (m, n) if transposed else (n, m))
    if n * m == 0:
        return y
    # strides of the logical (n_cols, m) and (n, m) views of x and y
    if transposed:
        xs_i, xs_j = x.stride(1), x.stride(0)
        ys_i, ys_j = y.stride(1), y.stride(0)
    else:
        xs_i, xs_j = x.stride(0), x.stride(1)
        ys_i, ys_j = y.stride(0), y.stride(1)
    if plan is None:
        raise ValueError("csr_spmm: kernels 5 and 6 need the row tiles of "
                         "rowptr (plan=csr_plan(rowptr))")
    item = x.element_size()
    vec = vec_width(m, (xs_i, xs_j, x.data_ptr()), (ys_i, ys_j, y.data_ptr()),
                    item=item)
    copy16 = colidx.data_ptr() % 16 == 0 and values.data_ptr() % 16 == 0
    entry, counter = ("gcge_csr_spmm_f64", "csr_f64") if item == 8 else \
        ("gcge_csr_spmm_f32", "csr_f32")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(_build.lib(), entry)(
            rowptr.data_ptr(), colidx.data_ptr(), values.data_ptr(), nnz,
            plan.tiles.data_ptr(), plan.tiles.shape[0] - 1, plan.budget, m,
            x.data_ptr(), xs_i, xs_j, y.data_ptr(), ys_i, ys_j, vec,
            int(copy16), int(row_fast(m, ys_i, ys_j)), stream)
    _build.check(entry, err)
    LAUNCHES[counter] += 1
    return y


class CsrOperator(LinearOperator):
    """Irregular sparse operator in CSR layout, for patterns that neither the
    DIA nor the Hybrid layout carries (thousands of distinct diagonals).

    The counterpart of both ``gcge_tpu``'s ``OneHotOperator``
    (``onehot_pallas.py``: the f32 one-hot planes) and ``EllOneHotOperator``
    (``operators.py``: the f64 front of the same planes) in one class:
    ``matvec`` and ``matvec_t`` dispatch on the dtype of ``x``.  An ``x`` of
    the operator's dtype runs on ``values`` (f64: kernel 6 on the card); a
    float32 ``x`` on a float64 operator runs on a float32 copy of the values,
    made once at first use (kernel 5: the mixed-precision inner CG).  On a
    card the operator plans the row tiles of both kernels when it is built,
    so that a captured CG stage finds them on the card."""

    def __init__(self, rowptr: torch.Tensor, colidx: torch.Tensor,
                 values: torch.Tensor, n_cols: int):
        self.rowptr = rowptr      # (n_rows + 1,) int32
        self.colidx = colidx      # (nnz,) int32, sorted within each row
        self.values = values      # (nnz,)
        self.n_cols = int(n_cols)
        self._values32 = None
        self.plan = csr_plan(rowptr) if rowptr.device.type == "cuda" \
            else None

    @property
    def shape(self):
        return (self.rowptr.shape[0] - 1, self.n_cols)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def nnz(self):
        return int(torch.count_nonzero(self.values))

    def _values_for(self, dtype):
        if dtype == self.values.dtype:
            return self.values
        if dtype == torch.float32:
            if self._values32 is None:
                self._values32 = self.values.float()
            return self._values32
        raise TypeError(f"CsrOperator of {self.values.dtype} applied to "
                        f"{dtype}")

    def _apply(self, x, transposed: bool):
        if x.dim() != 2 or x.shape[1 if transposed else 0] != self.n_cols:
            raise ValueError(f"x of shape {tuple(x.shape)} does not match a "
                             f"CSR operator of {self.n_cols} columns "
                             f"(transposed={transposed})")
        return csr_spmm(self.rowptr, self.colidx, self._values_for(x.dtype),
                        x, transposed, self.plan)

    def matvec(self, x):
        """``x (n, m) -> A @ x (n, m)``."""
        return self._apply(x, False)

    def matvec_t(self, xt):
        """Transposed layout: ``xt (m, n) -> (A @ x)^T (m, n)``."""
        return self._apply(xt, True)

    @classmethod
    def from_coo(cls, rows, cols, vals, shape, dtype=torch.float64, *,
                 device):
        """Pack COO triplets to CSR on the host, then move to ``device``.

        On a CUDA device the one-hot mask probe (kernel 7) runs first, as
        ``gcge_tpu`` probes before its first one-hot product, and a card
        whose bf16 compare and select give no one-hot mask is refused."""
        rowptr, colidx, values = pack_csr(rows, cols, vals, shape)
        if torch.device(device).type == "cuda" and \
                not bf16_mask_supported(device):
            raise RuntimeError(f"the bf16 one-hot mask probe failed on "
                               f"{device}")
        return cls(torch.as_tensor(rowptr, device=device),
                   torch.as_tensor(colidx, device=device),
                   torch.as_tensor(values.astype(_np_dtype(dtype)),
                                   device=device), shape[1])

    @classmethod
    def from_scipy(cls, mat, dtype=torch.float64, *, device):
        coo = mat.tocoo()
        return cls.from_coo(coo.row, coo.col, coo.data, coo.shape,
                            dtype=dtype, device=device)

    def to_dense(self):
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        out.index_put_((_row_ids(self.rowptr, self.values.shape[0]),
                        self.colidx.long()), self.values, accumulate=True)
        return out


def onehot_mask_reference(ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch one-hot mask: ``M[a, b] = (a == ids[0, b])`` as bf16
    (8, 128), with the compare and the select on bf16 values."""
    iota = torch.arange(MASK_SHAPE[0], dtype=torch.int32,
                        device=ids.device).to(torch.bfloat16)
    idb = ids[0].to(torch.bfloat16)
    one = torch.ones((), dtype=torch.bfloat16, device=ids.device)
    return torch.where(iota[:, None] == idb[None, :], one, torch.zeros_like(one))


def onehot_mask_probe(ids: torch.Tensor) -> torch.Tensor:
    """The bf16 one-hot mask of int32 ``ids`` (8, 128): kernel 7 on a CUDA
    tensor, :func:`onehot_mask_reference` on a CPU tensor."""
    if tuple(ids.shape) != MASK_SHAPE or ids.dtype != torch.int32:
        raise TypeError(f"onehot_mask_probe: int32 ids of shape {MASK_SHAPE} "
                        f"expected, got {ids.dtype} {tuple(ids.shape)}")
    if ids.device.type == "cpu":
        return onehot_mask_reference(ids)
    if ids.device.type != "cuda":
        raise ValueError(f"onehot_mask_probe: unsupported device {ids.device}")
    if not ids.is_contiguous():
        raise ValueError("onehot_mask_probe: ids must be contiguous")
    out = torch.empty(MASK_SHAPE, dtype=torch.bfloat16, device=ids.device)
    entry = "gcge_onehot_mask_probe"
    fn = getattr(_build.lib(), entry)
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        err = fn(ids.data_ptr(), out.data_ptr(), stream)
    _build.check(entry, err)
    LAUNCHES["mask_probe"] += 1
    return out


def bf16_mask_supported(device="cuda") -> bool:
    """Whether the bf16 compare-and-select mask build gives a one-hot mask on
    ``device``: the sum of the probe's mask for ``ids = arange(128) % 8`` is
    128.  A failed build or launch raises.

    On the TPU the answer picks the mask form of the one-hot SpMM kernels.
    The port's SpMM kernels gather and build no masks, so the answer picks
    nothing on a solve's path: :meth:`CsrOperator.from_coo` runs the probe
    once per operator built on a card, as a check of the card's bf16
    arithmetic, and raises when it fails."""
    ids = torch.zeros(MASK_SHAPE, dtype=torch.int32, device=device)
    ids[0] = torch.arange(MASK_SHAPE[1], dtype=torch.int32,
                          device=device) % MASK_SHAPE[0]
    return float(onehot_mask_probe(ids).float().sum()) == MASK_SHAPE[1]
