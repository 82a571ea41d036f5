"""DIA SpMM: the counterpart of ``gcge_tpu/ops/spmm_pallas.py``.

:func:`dia_spmm` computes ``y = A x`` for DIA storage
``values[d, i] = A[i, i + offsets[d]]`` in two layouts: ``x`` of shape
``(n, m)`` (``transposed=False``, :meth:`DiaOperator.matvec`) or ``(m, n)``
(``transposed=True``, :meth:`DiaOperator.matvec_t`).  On a CUDA tensor it
launches kernel 1 (f64) or kernel 2 (f32) of ``csrc/dia_spmm.cu``; on a CPU
tensor it runs :func:`dia_spmm_reference`, the plain PyTorch version.

The TPU kernels tile rows into lanes, zero-pad x by one tile per call and cap
the offsets at the tile width; none of that applies here.  The halo window
``(hl, hr)`` of the TPU entry points serves row-sharded operators, which the
port does not have yet: only ``halo=(0, 0)`` is accepted.
"""

from __future__ import annotations

import torch

from gcge_tpu_torch.ops import _build

# launches of the CUDA kernels since the last reset, by kernel
LAUNCHES = {"dia_f64": 0, "dia_f32": 0}

_ENTRY = {torch.float64: ("gcge_dia_spmm_f64", "dia_f64"),
          torch.float32: ("gcge_dia_spmm_f32", "dia_f32")}


def dia_spmm_reference(values: torch.Tensor, offsets: torch.Tensor,
                       x: torch.Tensor, transposed: bool = False
                       ) -> torch.Tensor:
    """Plain PyTorch DIA SpMM: one shifted multiply-add per diagonal, in the
    order of the offsets, on the logical ``(n, m)`` view of ``x``."""
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
    return y.T if transposed else y


def dia_spmm(values: torch.Tensor, offsets: torch.Tensor, x: torch.Tensor,
             transposed: bool = False, halo: tuple[int, int] = (0, 0)
             ) -> torch.Tensor:
    """``A x`` for DIA ``values`` (ndiag, n) and int32 ``offsets`` (ndiag,).

    ``x`` is ``(n, m)``, or ``(m, n)`` when ``transposed``, with any strides;
    the result has the layout of ``x`` and is freshly allocated."""
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
    if x.dtype not in _ENTRY or values.dtype != x.dtype:
        raise TypeError(f"dia_spmm: values {values.dtype} and x {x.dtype} "
                        f"must both be float64 or both float32")
    if offsets.dtype != torch.int32 or not offsets.is_contiguous():
        raise TypeError("dia_spmm: offsets must be a contiguous int32 tensor")
    if not values.is_contiguous():
        raise ValueError("dia_spmm: values must be contiguous")
    m = x.shape[0] if transposed else x.shape[1]
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if n * m == 0:
        return y.zero_()
    # strides of the logical (n, m) views of x and y
    if transposed:
        xs_i, xs_j = x.stride(1), x.stride(0)
        ys_i, ys_j = y.stride(1), y.stride(0)
    else:
        xs_i, xs_j = x.stride(0), x.stride(1)
        ys_i, ys_j = y.stride(0), y.stride(1)
    entry, counter = _ENTRY[x.dtype]
    fn = getattr(_build.lib(), entry)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(values.data_ptr(), offsets.data_ptr(), ndiag, n, m,
                 x.data_ptr(), xs_i, xs_j, y.data_ptr(), ys_i, ys_j, stream)
    _build.check(entry, err)
    LAUNCHES[counter] += 1
    return y
