"""Tall-skinny f64 GEMMs: the counterpart of ``gcge_tpu/ops/osgemm_pallas.py``.

The TPU has no f64 matrix unit, so ``gcge_tpu`` reaches f64 accuracy for the
solver's tall Grams and recombinations by slicing each operand into 7 bf16
planes.  Hopper multiplies f64 on its tensor cores, so the port computes the
same two products directly (``csrc/tall_gemm.cu``):

* :func:`tall_gram` — ``a^T b`` for tall ``a (n, p)``, ``b (n, q)``
  (kernel 3: one block per chunk of rows and output tile, partials added
  in chunk order by a second launch);
* :func:`tall_expand` — ``a @ c`` for tall ``a (n, k)`` and small
  ``c (k, q)`` (kernel 4: C resident in shared memory, persistent blocks
  over row tiles of A).

Every launch decision is a Python function of shapes, strides and
``data_ptr()`` (:func:`copy_vec`, :func:`gram_plan`, :func:`expand_plan`),
so that the CPU tests reach it.  On CUDA tensors the wrappers launch the
kernels; on CPU tensors they run the plain versions,
:func:`tall_gram_reference` (the chunked
:func:`gcge_tpu_torch.ops.multivec.gram`) and :func:`tall_expand_reference`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from gcge_tpu_torch.ops import _build
from gcge_tpu_torch.ops.multivec import gram

# launches of the CUDA kernels since the last reset, by kernel: one a
# wrapper call
LAUNCHES = {"gram": 0, "expand": 0}
# launches of the fragment-layout check, which no solve runs
CHECK_LAUNCHES = {"dmma_tile": 0}

# dynamic shared memory a block of csrc/tall_gemm.cu may use: the H100's
# 232,448 bytes less 1 KB for the ring's barriers (kMaxDynamicSmem)
SMEM_BLOCK = 232_448 - 1024
STAGES = 4             # kStages: depth of the cp.async ring
GRAM_TILE = 128        # kGTile: output tile edge of kernel 3
GRAM_STAGE_BYTES = 32 * 1024   # aim for one ring stage of kernel 3
GRAM_MIN_ROWS = 256    # fewest rows a Gram chunk is given
GRAM_MAX_CHUNKS = 1024
EXPAND_ROWS = 64       # kERows: rows of a row tile of kernel 4
EXPAND_RING = STAGES * EXPAND_ROWS * 40 * 8    # kEPitch = 40 doubles
EXPAND_Q_TILE = 128    # 16 n-tiles: 8 a warp, two warps across
_WARPS = 8             # kConsumers: the warps that multiply


def tall_gram_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return gram(a, b)


def tall_expand_reference(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return a @ c


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def copy_vec(*ts: torch.Tensor) -> int:
    """2 (16-byte cp.async copies) when every row of every operand starts
    on 16 bytes and its columns are contiguous, else 1 (8-byte copies)."""
    for t in ts:
        rows, cols = t.shape
        if t.data_ptr() % 16 or (rows > 1 and t.stride(0) % 2) \
                or (cols > 1 and t.stride(1) != 1):
            return 1
    return 2


def _pitch(width: int) -> int:
    """Row pitch in doubles, at least ``width``, = 4 (mod 16): the 8-byte
    fragment loads of a half warp (rows t, columns g) hit distinct banks."""
    return width + (4 - width) % 16


@dataclass(frozen=True)
class GramPlan:
    chunks: int          # blocks along the rows (grid x)
    rows: int            # rows per chunk
    tiles: int           # output tiles of GRAM_TILE (grid y)
    bk: int              # rows of a ring stage
    pitch_a: int         # row pitches of the stage, doubles
    pitch_b: int
    wm: int              # warps across the m-tiles; 8 / wm split the k-steps
    nt: int              # n-tiles a warp holds: the kernel's instance
    smem: int            # dynamic shared memory, bytes


@functools.lru_cache(maxsize=None)
def gram_plan(n: int, p: int, q: int, sms: int) -> GramPlan:
    """Launch plan of kernel 3 for ``a (n, p)``, ``b (n, q)`` on a card
    with ``sms`` SMs: about one block per SM (a block's 384 threads take
    more than half of an SM's registers), each chunk at least GRAM_MIN_ROWS
    rows."""
    mt = _cdiv(min(p, GRAM_TILE), 16)
    nts = _cdiv(min(q, GRAM_TILE), 8)
    nt = next(size for size in (2, 4, 8, 16) if size >= nts)
    wm = 1 if mt == 1 else 2 if mt == 2 else 4 if mt <= 4 else _WARPS
    wk = _WARPS // wm
    pitch_a = _pitch(16 * mt)
    pitch_b = _pitch(8 * nts)
    row_bytes = 8 * (pitch_a + pitch_b)
    bk = max(8, min(128, GRAM_STAGE_BYTES // row_bytes // 8 * 8))
    if bk >= 8 * wk:                       # whole k-steps for every warp
        bk = bk // (8 * wk) * (8 * wk)
    smem = max(STAGES * bk * row_bytes, (wk - 1) * wm * nt * 32 * 4 * 8)
    tiles = _cdiv(p, GRAM_TILE) * _cdiv(q, GRAM_TILE)
    want = _cdiv(sms, tiles)
    chunks = max(1, min(want, _cdiv(n, GRAM_MIN_ROWS), GRAM_MAX_CHUNKS))
    rows = _cdiv(n, chunks)
    return GramPlan(_cdiv(n, rows), rows, tiles, bk, pitch_a, pitch_b, wm, nt,
                    smem)


@dataclass(frozen=True)
class ExpandPlan:
    q_tile: int          # columns of Y (and C) a launch
    k_chunk: int         # rows of C resident in shared memory a launch
    nt: int              # n-tiles of a q-tile: the kernel's instance
    grid: int            # persistent blocks
    smem: int            # dynamic shared memory, bytes


@functools.lru_cache(maxsize=None)
def expand_plan(n: int, k: int, q: int, sms: int) -> ExpandPlan:
    """Launch plan of kernel 4 for ``a (n, k)``, ``c (k, q)``: C (or one
    q-tile and k-chunk of it) in fragment order beside the ring, one
    persistent block per SM (a block's 384 threads take more than half of
    an SM's registers) or per row tile, whichever is fewer."""
    q_tile = 8 * _cdiv(_cdiv(q, _cdiv(q, EXPAND_Q_TILE)), 8)
    nt = _cdiv(q_tile, 8)
    steps = (SMEM_BLOCK - EXPAND_RING) // (nt * 32 * 2 * 8)
    k_chunk = 8 * _cdiv(_cdiv(k, _cdiv(k, 8 * steps)), 8)
    smem = _cdiv(min(k, k_chunk), 8) * nt * 32 * 2 * 8 + EXPAND_RING
    grid = max(1, min(_cdiv(n, EXPAND_ROWS), sms))
    return ExpandPlan(q_tile, k_chunk, nt, grid, smem)


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
    plan = gram_plan(n, p, q, _build.sm_count(a.device))
    part = torch.empty((plan.chunks, p, q), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _build.lib().gcge_tall_gram_f64(
            a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(), b.stride(0),
            b.stride(1), n, p, q, plan.chunks, plan.rows, plan.bk,
            plan.pitch_a, plan.pitch_b, plan.wm, plan.nt, plan.smem,
            copy_vec(a, b),
            part.data_ptr(), c.data_ptr(), stream)
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
    if k == 0:
        return y.zero_()
    plan = expand_plan(n, k, q, _build.sm_count(a.device))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _build.lib().gcge_tall_expand_f64(
            a.data_ptr(), a.stride(0), a.stride(1), c.data_ptr(), c.stride(0),
            c.stride(1), n, k, q, plan.q_tile, plan.k_chunk, plan.nt,
            plan.grid, plan.smem, copy_vec(a), y.data_ptr(), stream)
    _build.check("gcge_tall_expand_f64", err)
    LAUNCHES["expand"] += 1
    return y


def dmma_tile_check(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a @ c`` for one (16 x 8)(8 x 8) tile through the kernels' f64 mma
    with its fragments read straight from device memory: a check of the
    fragment layout (plain version: ``a @ c``)."""
    if tuple(a.shape) != (16, 8) or tuple(c.shape) != (8, 8):
        raise ValueError("dmma_tile_check takes a (16, 8) and a (8, 8)")
    if a.device.type == "cpu" and c.device.type == "cpu":
        return a @ c
    _check_cuda("dmma_tile_check", a, c)
    a, c = a.contiguous(), c.contiguous()
    d = torch.empty((16, 8), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _build.lib().gcge_dmma_tile_check(
            a.data_ptr(), c.data_ptr(), d.data_ptr(), stream)
    _build.check("gcge_dmma_tile_check", err)
    CHECK_LAUNCHES["dmma_tile"] += 1
    return d
