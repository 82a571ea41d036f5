"""DIA SpMM: the counterpart of ``gcge_tpu/ops/spmm_pallas.py``.

:func:`dia_spmm` computes ``y = A x`` for DIA storage
``values[d, i] = A[i, i + offsets[d]]`` in two layouts: ``x`` of shape
``(n, m)`` (``transposed=False``, :meth:`DiaOperator.matvec`) or ``(m, n)``
(``transposed=True``, :meth:`DiaOperator.matvec_t`).  On a CUDA tensor it
launches kernel 1 (f64) or kernel 2 (f32) of ``csrc/dia_spmm.cu``, one
staged design in two types, on the launch plan of :func:`dia_plan`; on a CPU
tensor it runs :func:`dia_spmm_reference`, the plain PyTorch version.

Both SpMM wrappers of the port (this one and ``onehot.csr_spmm``) return
``y`` in the memory order of ``x``: :func:`empty_in_order_of` and
:func:`in_order_of` say what that means.  The mixed inner CG hands them
``r.T.float()``, ``(m, n)`` in shape and ``(n, m)`` in memory, and gets its
products back in the same order, so that every elementwise operation of the
stage runs on operands of one order.

The TPU kernels tile rows into lanes, zero-pad x by one tile per call and cap
the offsets at the tile width; none of that applies here.  The halo window
``(hl, hr)`` of the TPU entry points is kept: ``x`` then has ``n + hl + hr``
rows (a rank's rows between ``hl`` rows of its left neighbour and ``hr`` of
its right one, :mod:`gcge_tpu_torch.parallel.dist_ops`), row ``i`` of ``y``
reads ``x[hl + i + off_d]``, and only reads outside ``[0, n + hl + hr)`` are
zero.  ``halo=(0, 0)`` is the square product.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from gcge_tpu_torch.ops import _build

# launches of the CUDA kernels since the last reset, by kernel
LAUNCHES = {"dia_f64": 0, "dia_f32": 0}

DIA_ITEMS = 5          # kItems of csrc/dia_spmm.cu: column groups of a
                       # block's column tile


def column_major(t: torch.Tensor) -> bool:
    """Whether the matrix ``t`` is dense and laid out column by column (its
    transpose is contiguous) with more than one row and column; below that
    the two orders are one."""
    return t.shape[0] > 1 and t.shape[1] > 1 and t.T.is_contiguous()


def empty_in_order_of(x: torch.Tensor, shape) -> torch.Tensor:
    """An uninitialised matrix of ``shape`` in the memory order of ``x``:
    ``torch.empty_like(x)`` for a dense ``x`` of the same shape, column by
    column where ``x`` is (:func:`column_major`), else row by row."""
    rows, cols = shape
    if column_major(x):
        return torch.empty((cols, rows), dtype=x.dtype, device=x.device).T
    return torch.empty((rows, cols), dtype=x.dtype, device=x.device)


def in_order_of(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y`` in the memory order of ``x`` (see :func:`empty_in_order_of`),
    copied only where its own order differs."""
    if column_major(x):
        return y if column_major(y) else y.T.contiguous().T
    return y.contiguous()


def vec_width(m: int, *operands, item: int = 4) -> int:
    """Elements of ``item`` bytes a thread of the SpMM kernels moves at
    once: the largest count of at most 16 bytes (4, 2 or 1 floats; 2 or 1
    doubles) that divides ``m`` and for which every operand, given as
    ``(row stride, column stride, data_ptr)`` of its logical ``(rows, m)``
    view, has unit column stride, rows starting on a multiple of it and a
    start aligned to as many elements."""
    for v in (4, 2):
        if v * item <= 16 and m % v == 0 and all(
                sj == 1 and si % v == 0 and ptr % (item * v) == 0
                for si, sj, ptr in operands):
            return v
    return 1


def row_fast(m: int, ys_i: int, ys_j: int) -> bool:
    """Whether a thread of the SpMM kernels walks one row's column groups:
    where y's rows are adjacent and its columns are not (a transposed
    layout), so that neighbouring threads store neighbouring elements."""
    return ys_i == 1 and ys_j != 1 and m > 1


@dataclass(frozen=True)
class DiaPlan:
    vec: int          # elements a thread reads from a window and writes to y
    col_tile: int     # columns of x a block holds (m / col_tile tiles)
    flat: bool        # f32: the window is one range of x, 16-byte copies
    rows16: bool = False    # f64: each window row's segment starts on 16
                            # bytes, 16-byte copies
    row_fast: bool = False  # y's rows are adjacent: a thread's items are one
                            # row's column groups


@functools.lru_cache(maxsize=None)
def dia_plan(m: int, xs_i: int, xs_j: int, x_ptr16: int, ys_i: int,
             ys_j: int, y_ptr16: int, item: int = 4) -> DiaPlan:
    """Launch plan of kernel 2 (``item`` 4, f32) or kernel 1 (``item`` 8,
    f64) for the logical ``(n, m)`` views of ``x`` and ``y`` given by their
    strides and their ``data_ptr() % 16``.  ``vec`` follows the stores to
    ``y`` (:func:`vec_width`); a column tile holds at most ``DIA_ITEMS``
    groups of ``vec`` columns and is all of ``m`` where it can be.  The f32
    window copy is flat where x's rows are contiguous and adjacent and x
    starts on 16 bytes; the f64 one copies 16-byte pieces of each row where
    every tile's row segment starts on 16 bytes (unit column stride, an even
    row stride, x on 16 bytes and tiles of an even width or one tile).
    ``row_fast`` (kernel 1 only): see :func:`row_fast`."""
    vec = vec_width(m, (ys_i, ys_j, y_ptr16), item=item)
    col_tile = min(m, DIA_ITEMS * vec)
    unit = xs_j == 1 or m == 1
    fast = row_fast(m, ys_i, ys_j)
    if item == 4:
        # kernel 2 keeps its column-group-fastest items (csrc/dia_spmm.cu)
        flat = col_tile == m and unit and xs_i == m and x_ptr16 == 0
        return DiaPlan(vec, col_tile, flat)
    rows16 = unit and xs_i % 2 == 0 and x_ptr16 == 0 and \
        (col_tile % 2 == 0 or col_tile == m)
    return DiaPlan(vec, col_tile, False, rows16, fast)


def dia_spmm_reference(values: torch.Tensor, offsets: torch.Tensor,
                       x: torch.Tensor, transposed: bool = False,
                       halo: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Plain PyTorch DIA SpMM: one shifted multiply-add per diagonal, in the
    order of the offsets, on the logical ``(n + hl + hr, m)`` view of ``x``
    (row ``i`` of the result reads row ``hl + i + off`` of it); the result,
    ``(n, m)`` or ``(m, n)``, in the memory order of ``x``, as
    :func:`dia_spmm` returns it."""
    xn = x.T if transposed else x
    hl = halo[0]
    n = values.shape[1]
    nx = xn.shape[0]
    y = torch.zeros((n, xn.shape[1]), dtype=x.dtype, device=x.device)
    for d, off in enumerate(offsets.tolist()):
        # the rows i whose read hl + i + off lies in [0, nx)
        lo, hi = max(0, -(hl + off)), min(n, nx - hl - off)
        if lo < hi:
            y[lo:hi] += values[d, lo:hi, None] * \
                xn[hl + off + lo:hl + off + hi]
    return in_order_of(y.T if transposed else y, x)


def dia_spmm(values: torch.Tensor, offsets: torch.Tensor, x: torch.Tensor,
             transposed: bool = False, halo: tuple[int, int] = (0, 0)
             ) -> torch.Tensor:
    """``A x`` for DIA ``values`` (ndiag, n) and int32 ``offsets`` (ndiag,).

    ``x`` is ``(n + hl + hr, m)``, or ``(m, n + hl + hr)`` when
    ``transposed``, with any strides; ``halo=(hl, hr)`` (see the module's
    docstring).  The result is ``(n, m)`` or ``(m, n)``, freshly allocated,
    in the memory order of ``x``: like ``torch.empty_like(x)`` for a dense
    ``x``, else contiguous in the logical layout
    (:func:`empty_in_order_of`)."""
    hl, hr = (int(h) for h in halo)
    ndiag, n = values.shape
    if hl < 0 or hr < 0:
        raise ValueError(f"dia_spmm: negative halo {tuple(halo)}")
    nx = n + hl + hr
    if x.dim() != 2 or (x.shape[1] if transposed else x.shape[0]) != nx:
        raise ValueError(f"x of shape {tuple(x.shape)} does not match a DIA "
                         f"operator of {n} rows and halo {(hl, hr)} "
                         f"(transposed={transposed})")
    if offsets.shape != (ndiag,):
        raise ValueError(f"{offsets.shape[0]} offsets for {ndiag} diagonals")
    if values.device != x.device or offsets.device != x.device:
        raise ValueError("dia_spmm: values, offsets and x must share a device")
    if x.device.type == "cpu":
        return dia_spmm_reference(values, offsets, x, transposed, (hl, hr))
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmm: unsupported device {x.device}")
    if x.dtype not in (torch.float64, torch.float32) or values.dtype != x.dtype:
        raise TypeError(f"dia_spmm: values {values.dtype} and x {x.dtype} "
                        f"must both be float64 or both float32")
    if offsets.dtype != torch.int32 or not offsets.is_contiguous():
        raise TypeError("dia_spmm: offsets must be a contiguous int32 tensor")
    if not values.is_contiguous():
        raise ValueError("dia_spmm: values must be contiguous")
    m = x.shape[0] if transposed else x.shape[1]
    y = empty_in_order_of(x, (m, n) if transposed else (n, m))
    if n * m == 0:
        return y.zero_()
    # strides of the logical (n, m) views of x and y
    if transposed:
        xs_i, xs_j = x.stride(1), x.stride(0)
        ys_i, ys_j = y.stride(1), y.stride(0)
    else:
        xs_i, xs_j = x.stride(0), x.stride(1)
        ys_i, ys_j = y.stride(0), y.stride(1)
    item = x.element_size()
    plan = dia_plan(m, xs_i, xs_j, x.data_ptr() % 16, ys_i, ys_j,
                    y.data_ptr() % 16, item)
    # the value rows in 16-byte pieces: n a multiple of 16 bytes' worth
    vec16 = n % (16 // item) == 0 and values.data_ptr() % 16 == 0
    entry, counter = ("gcge_dia_spmm_f64", "dia_f64") if item == 8 else \
        ("gcge_dia_spmm_f32", "dia_f32")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(_build.lib(), entry)(
            values.data_ptr(), offsets.data_ptr(), ndiag, n, m, x.data_ptr(),
            hl, nx, xs_i, xs_j, y.data_ptr(), ys_i, ys_j, plan.vec,
            plan.col_tile,
            int(plan.flat or plan.rows16), int(vec16), int(plan.row_fast),
            stream)
    _build.check(entry, err)
    LAUNCHES[counter] += 1
    return y
