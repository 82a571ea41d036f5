"""DIA SpMM: the counterpart of ``gcge_tpu/ops/spmm_pallas.py``.

:func:`dia_spmm` computes ``y = A x`` for DIA storage
``values[d, i] = A[i, i + offsets[d]]`` in two layouts: ``x`` of shape
``(n, m)`` (``transposed=False``, :meth:`DiaOperator.matvec`) or ``(m, n)``
(``transposed=True``, :meth:`DiaOperator.matvec_t`).  On a CUDA tensor it
launches kernel 1 (f64) or kernel 2 (f32) of ``csrc/dia_spmm.cu``; on a CPU
tensor it runs :func:`dia_spmm_reference`, the plain PyTorch version.

Both SpMM wrappers of the port (this one and ``onehot.csr_spmm``) return
``y`` in the memory order of ``x``: :func:`empty_in_order_of` and
:func:`in_order_of` say what that means.  The mixed inner CG hands them
``r.T.float()``, ``(m, n)`` in shape and ``(n, m)`` in memory, and gets its
products back in the same order, so that every elementwise operation of the
stage runs on operands of one order.

The TPU kernels tile rows into lanes, zero-pad x by one tile per call and cap
the offsets at the tile width; none of that applies here.  The halo window
``(hl, hr)`` of the TPU entry points serves row-sharded operators, which the
port does not have yet: only ``halo=(0, 0)`` is accepted.
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


def vec_width(m: int, *operands) -> int:
    """Floats a thread of kernels 2 and 5 moves at once: the largest of 4,
    2 and 1 that divides ``m`` and for which every operand, given as
    ``(row stride, column stride, data_ptr)`` of its logical ``(rows, m)``
    view, has unit column stride, rows starting on a multiple of it and a
    start aligned to as many floats."""
    for v in (4, 2):
        if m % v == 0 and all(sj == 1 and si % v == 0 and ptr % (4 * v) == 0
                              for si, sj, ptr in operands):
            return v
    return 1


@dataclass(frozen=True)
class DiaPlan:
    vec: int          # floats a thread reads from a window and writes to y
    col_tile: int     # columns of x a block holds (grid y: m / col_tile)
    flat: bool        # the window is one range of x: 16-byte copies


@functools.lru_cache(maxsize=None)
def dia_plan(m: int, xs_i: int, xs_j: int, x_ptr16: int, ys_i: int,
             ys_j: int, y_ptr16: int) -> DiaPlan:
    """Launch plan of kernel 2 for the logical ``(n, m)`` views of ``x`` and
    ``y`` given by their strides and their ``data_ptr() % 16``.  The
    window copy is flat where x's rows are contiguous and adjacent and x
    starts on 16 bytes; ``vec`` follows the stores to ``y``
    (:func:`vec_width`); a column tile holds at most ``DIA_ITEMS`` groups of
    ``vec`` columns and is all of ``m`` where it can be."""
    vec = vec_width(m, (ys_i, ys_j, y_ptr16))
    col_tile = min(m, DIA_ITEMS * vec)
    flat = col_tile == m and (xs_j == 1 or m == 1) and xs_i == m \
        and x_ptr16 == 0
    return DiaPlan(vec, col_tile, flat)


def dia_spmm_reference(values: torch.Tensor, offsets: torch.Tensor,
                       x: torch.Tensor, transposed: bool = False
                       ) -> torch.Tensor:
    """Plain PyTorch DIA SpMM: one shifted multiply-add per diagonal, in the
    order of the offsets, on the logical ``(n, m)`` view of ``x``; the
    result in the memory order of ``x``, as :func:`dia_spmm` returns it."""
    xn = x.T if transposed else x
    n = values.shape[1]
    y = torch.zeros((n, xn.shape[1]), dtype=x.dtype, device=x.device)
    for d, off in enumerate(offsets.tolist()):
        if off >= n or -off >= n:
            continue
        if off >= 0:
            y[:n - off] += values[d, :n - off, None] * xn[off:]
        else:
            y[-off:] += values[d, -off:, None] * xn[:n + off]
    return in_order_of(y.T if transposed else y, x)


def dia_spmm(values: torch.Tensor, offsets: torch.Tensor, x: torch.Tensor,
             transposed: bool = False, halo: tuple[int, int] = (0, 0)
             ) -> torch.Tensor:
    """``A x`` for DIA ``values`` (ndiag, n) and int32 ``offsets`` (ndiag,).

    ``x`` is ``(n, m)``, or ``(m, n)`` when ``transposed``, with any strides.
    The result has the shape of ``x``, is freshly allocated and lies in the
    memory order of ``x``: ``torch.empty_like(x)`` for a dense ``x``, else
    contiguous in the logical layout (:func:`empty_in_order_of`)."""
    if tuple(halo) != (0, 0):
        raise NotImplementedError("DIA halo windows serve row-sharded "
                                  "operators (ROADMAP Queue 1 item 12)")
    ndiag, n = values.shape
    if x.dim() != 2 or (x.shape[1] if transposed else x.shape[0]) != n:
        raise ValueError(f"x of shape {tuple(x.shape)} does not match a DIA "
                         f"operator of {n} rows (transposed={transposed})")
    if offsets.shape != (ndiag,):
        raise ValueError(f"{offsets.shape[0]} offsets for {ndiag} diagonals")
    if values.device != x.device or offsets.device != x.device:
        raise ValueError("dia_spmm: values, offsets and x must share a device")
    if x.device.type == "cpu":
        return dia_spmm_reference(values, offsets, x, transposed)
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
    y = empty_in_order_of(x, x.shape)
    if n * m == 0:
        return y.zero_()
    # strides of the logical (n, m) views of x and y
    if transposed:
        xs_i, xs_j = x.stride(1), x.stride(0)
        ys_i, ys_j = y.stride(1), y.stride(0)
    else:
        xs_i, xs_j = x.stride(0), x.stride(1)
        ys_i, ys_j = y.stride(0), y.stride(1)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if x.dtype == torch.float64:
            entry, counter = "gcge_dia_spmm_f64", "dia_f64"
            err = lib.gcge_dia_spmm_f64(
                values.data_ptr(), offsets.data_ptr(), ndiag, n, m,
                x.data_ptr(), xs_i, xs_j, y.data_ptr(), ys_i, ys_j, stream)
        else:
            entry, counter = "gcge_dia_spmm_f32", "dia_f32"
            plan = dia_plan(m, xs_i, xs_j, x.data_ptr() % 16, ys_i, ys_j,
                            y.data_ptr() % 16)
            err = lib.gcge_dia_spmm_f32(
                values.data_ptr(), offsets.data_ptr(), ndiag, n, m,
                x.data_ptr(), xs_i, xs_j, y.data_ptr(), ys_i, ys_j, plan.vec,
                plan.col_tile, int(plan.flat),
                int(n % 4 == 0 and values.data_ptr() % 16 == 0), stream)
    _build.check(entry, err)
    LAUNCHES[counter] += 1
    return y
