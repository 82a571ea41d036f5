"""Tall-skinny f64 GEMMs: the counterpart of ``gcge_tpu/ops/osgemm_pallas.py``.

The TPU has no f64 matrix unit, so ``gcge_tpu`` reaches f64 accuracy for the
solver's tall Grams and recombinations by slicing each operand into 7 bf16
planes.  Hopper multiplies in f64, so the port computes the same two products
directly:

* :func:`tall_gram` — ``a^T b`` for tall ``a (n, p)``, ``b (n, q)``
  (kernel 3 of ``csrc/tall_gemm.cu``, split over row chunks);
* :func:`tall_expand` — ``a @ c`` for tall ``a (n, k)`` and small
  ``c (k, q)`` (kernel 4).

On CUDA tensors the wrappers launch the kernels; on CPU tensors they run the
plain versions, :func:`tall_gram_reference` (the chunked
:func:`gcge_tpu_torch.ops.multivec.gram`) and :func:`tall_expand_reference`.
"""

from __future__ import annotations

import torch

from gcge_tpu_torch.ops import _build
from gcge_tpu_torch.ops.multivec import gram

# launches of the CUDA kernels since the last reset, by kernel
LAUNCHES = {"gram": 0, "expand": 0}

_GRAM_TILE = 32       # output tile edge of csrc/tall_gemm.cu
_GRAM_MIN_ROWS = 256  # fewest rows a Gram chunk is given
_GRAM_MAX_CHUNKS = 1024


def tall_gram_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return gram(a, b)


def tall_expand_reference(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return a @ c


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: operands must share a device")
        if t.dtype != torch.float64:
            raise TypeError(f"{name}: the CUDA kernel takes float64, "
                            f"got {t.dtype}")


def _gram_chunks(n: int, tiles: int, sms: int) -> tuple[int, int]:
    """(chunks, rows per chunk): about four blocks per SM in all, with at
    least _GRAM_MIN_ROWS rows in each chunk."""
    want = max(1, -(-4 * sms // tiles))
    chunks = max(1, min(want, -(-n // _GRAM_MIN_ROWS), _GRAM_MAX_CHUNKS))
    rows = -(-n // chunks)
    return -(-n // rows), rows


def tall_gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^T b`` ((n, p), (n, q) -> (p, q)); operands may be strided views."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"tall_gram: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not contract")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return tall_gram_reference(a, b)
    _check_cuda("tall_gram", a, b)
    n, p = a.shape
    q = b.shape[1]
    c = torch.empty((p, q), dtype=a.dtype, device=a.device)
    if p * q == 0:
        return c
    if n == 0:
        return c.zero_()
    tiles = -(-p // _GRAM_TILE) * -(-q // _GRAM_TILE)
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    chunks, rows = _gram_chunks(n, tiles, sms)
    part = torch.empty((chunks, p, q), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _build.lib().gcge_tall_gram_f64(
            a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(), b.stride(0),
            b.stride(1), n, p, q, chunks, rows, part.data_ptr(), c.data_ptr(),
            stream)
    _build.check("gcge_tall_gram_f64", err)
    LAUNCHES["gram"] += 1
    return c


def tall_expand(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a @ c`` ((n, k), (k, q) -> (n, q)); operands may be strided views."""
    if a.dim() != 2 or c.dim() != 2 or a.shape[1] != c.shape[0]:
        raise ValueError(f"tall_expand: shapes {tuple(a.shape)} and "
                         f"{tuple(c.shape)} do not contract")
    if a.device.type == "cpu" and c.device.type == "cpu":
        return tall_expand_reference(a, c)
    _check_cuda("tall_expand", a, c)
    n, k = a.shape
    q = c.shape[1]
    y = torch.empty((n, q), dtype=a.dtype, device=a.device)
    if n * q == 0:
        return y
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _build.lib().gcge_tall_expand_f64(
            a.data_ptr(), a.stride(0), a.stride(1), c.data_ptr(), c.stride(0),
            c.stride(1), n, k, q, y.data_ptr(), stream)
    _build.check("gcge_tall_expand_f64", err)
    LAUNCHES["expand"] += 1
    return y
