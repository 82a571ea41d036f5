"""The two measurement kernels: the counterparts of the Pallas kernels in
``benchmarks/df64_push.py`` and ``benchmarks/pallas_isolate.py``.

* :func:`fma_probe` — does the compiler turn ``a * b - p`` (``p`` the rounded
  product) into one fused multiply-add?  Kernel 8, ``csrc/fma_probe.cu``,
  beside the Dekker two-product error of the same product.
* :func:`slice_gram` — the pieces of the bf16-sliced tall Gram that reaches
  f64 accuracy on a machine without f64, one ``mode`` at a time: ``none``
  (loads and a cast), ``peel``, ``dot``, ``full``.  Kernel 9,
  ``csrc/slice_gram.cu``.  No solve runs it on Hopper (the port's Gram is
  native f64); it says what each piece costs on the card.

On CUDA tensors the wrappers launch the kernels; on CPU tensors they run the
plain PyTorch versions beside them (:func:`fma_probe_plain`,
:func:`slice_gram_plain`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gcge_tpu_torch.ops import _build

# launches of the CUDA kernels since the last reset, by kernel
LAUNCHES = {"fma_probe": 0, "slice_gram": 0}

PROBE_SHAPE = (8, 128)
_SPLITTER = 4097.0          # 2^12 + 1: Veltkamp split of an f32
SLICES = 7                  # bf16 slices per (hi, lo) value, 7 bits each
MODES = ("none", "peel", "dot", "full")
_ROW_TILE = 16              # rows of A per block of csrc/slice_gram.cu
_MAX_Q = 16                 # rows of B it takes
_COL_STEP = 64              # columns it stages per step


class FmaProbe(NamedTuple):
    """What :func:`fma_probe` found."""

    out: torch.Tensor       # (16, 128) f32: rows 0-7 ``a*b - p``, 8-15 Dekker
    fused: bool             # the two blocks are bitwise equal
    nonzeros: int           # nonzero Dekker errors (of 1024)


def _check_probe_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    for t in (a, b):
        if tuple(t.shape) != PROBE_SHAPE or t.dtype != torch.float32:
            raise TypeError(f"fma_probe: float32 operands of shape "
                            f"{PROBE_SHAPE} expected, got {t.dtype} "
                            f"{tuple(t.shape)}")
    if a.device != b.device:
        raise ValueError("fma_probe: operands must share a device")


def fma_probe_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel 8: rows 0-7 the exact error of the
    rounded product (the 48-bit product and its difference from ``p`` are
    exact in f64, and the difference fits an f32), which is what one FMA
    gives; rows 8-15 the Dekker two-product error in 17 eager f32
    operations, none of them fused."""
    _check_probe_operands(a, b)
    p = a * b
    exact = (a.double() * b.double() - p.double()).float()
    c = _SPLITTER * a
    a_hi = c - (c - a)
    a_lo = a - a_hi
    c = _SPLITTER * b
    b_hi = c - (c - b)
    b_lo = b - b_hi
    dekker = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return torch.cat([exact, dekker], dim=0)


def fma_probe_blocks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The ``(16, 128)`` output of the probe: kernel 8 on CUDA tensors,
    :func:`fma_probe_plain` on CPU tensors."""
    _check_probe_operands(a, b)
    if a.device.type == "cpu":
        return fma_probe_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"fma_probe: unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("fma_probe: operands must be contiguous")
    out = torch.empty((2 * PROBE_SHAPE[0], PROBE_SHAPE[1]),
                      dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _build.lib().gcge_fma_probe(a.data_ptr(), b.data_ptr(),
                                          out.data_ptr(), stream)
    _build.check("gcge_fma_probe", err)
    LAUNCHES["fma_probe"] += 1
    return out


def fma_probe(a: torch.Tensor, b: torch.Tensor) -> FmaProbe:
    """Run the probe and read its two facts back: whether ``a * b - p`` came
    out bitwise equal to the Dekker error (the compiler fused it), and how
    many of the 1024 Dekker errors are nonzero.  The answer picks no code
    path."""
    out = fma_probe_blocks(a, b)
    rows = PROBE_SHAPE[0]
    err_fma, err_dek = out[:rows], out[rows:]
    fused = bool((err_fma.view(torch.int32) == err_dek.view(torch.int32))
                 .all())
    return FmaProbe(out, fused, int(torch.count_nonzero(err_dek)))


# --------------------------------------------------------------------------
# kernel 9: the sliced Gram, piece by piece
# --------------------------------------------------------------------------


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def peel_stack(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The 7 bf16 slices of the f32 pair ``(hi, lo)``, ``(h, c)`` each,
    stacked to ``(7 h, c)``: slice ``k`` is the remainder rounded (half to
    even) to a multiple of ``2^-7(k+1)``.  ``hi`` alone feeds slices 0-2;
    ``lo`` joins through a two-sum, whose error term is added back after
    slice 4."""
    slices = []
    r = hi

    def take(r, k):
        s = torch.round(r * 2.0 ** (7 * (k + 1))) * 2.0 ** (-7 * (k + 1))
        slices.append(s.to(torch.bfloat16))
        return r - s

    for k in range(3):
        r = take(r, k)
    r, rl = _two_sum(r, lo)
    for k in range(3, SLICES):
        r = take(r, k)
        if k == 4:
            r = r + rl
    return torch.cat(slices, dim=0)


def _check_planes(ahi, alo, bhi, blo, mode: str, nr: int) -> None:
    if mode not in MODES:
        raise ValueError(f"slice_gram: mode {mode!r} not in {MODES}")
    for t in (ahi, alo, bhi, blo):
        if t.dim() != 2 or t.dtype != torch.float32:
            raise TypeError("slice_gram: 2-D float32 planes expected")
        if t.device != ahi.device:
            raise ValueError("slice_gram: planes must share a device")
    if alo.shape != ahi.shape or blo.shape != bhi.shape or \
            ahi.shape[1] != bhi.shape[1]:
        raise ValueError(f"slice_gram: planes {tuple(ahi.shape)}, "
                         f"{tuple(alo.shape)}, {tuple(bhi.shape)}, "
                         f"{tuple(blo.shape)} do not match")
    if nr <= 0 or ahi.shape[1] % nr:
        raise ValueError(f"slice_gram: {ahi.shape[1]} columns are not a "
                         f"multiple of the chunk {nr}")


def slice_gram_plain(ahi, alo, bhi, blo, mode: str = "full",
                     nr: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of kernel 9: chunk by chunk of ``nr`` columns,
    the stacks (peeled, or slice 0 = ``bf16(hi)`` and zeros behind), their
    product in f32, and the chunk slabs added in order into one f32 slab
    ``(7P, 7Q)``.  Zeros without the dot."""
    _check_planes(ahi, alo, bhi, blo, mode, nr)
    p, q = ahi.shape[0], bhi.shape[0]
    acc = torch.zeros((SLICES * p, SLICES * q), dtype=torch.float32,
                      device=ahi.device)
    if mode in ("none", "peel"):
        return acc

    def stack(hi, lo):
        if mode == "full":
            return peel_stack(hi, lo).float()
        rest = torch.zeros(((SLICES - 1) * hi.shape[0], hi.shape[1]),
                           dtype=torch.float32, device=hi.device)
        return torch.cat([hi.to(torch.bfloat16).float(), rest], dim=0)

    for c0 in range(0, ahi.shape[1], nr):
        cols = slice(c0, c0 + nr)
        acc = acc + stack(ahi[:, cols], alo[:, cols]) @ \
            stack(bhi[:, cols], blo[:, cols]).T
    return acc


def slice_gram(ahi, alo, bhi, blo, mode: str = "full",
               nr: int = 1024) -> torch.Tensor:
    """The ``(7P, 7Q)`` f32 slab of the sliced Gram of A ``(P, n_pad)`` and
    B ``(Q, n_pad)``, given as hi/lo f32 planes, over chunks of ``nr``
    columns: kernel 9 on CUDA tensors, :func:`slice_gram_plain` on CPU
    tensors.  ``mode`` picks the pieces that run; without the dot (``none``,
    ``peel``) the result is zeros.  In ``dot`` and ``none`` only slice 0 of
    each stack is filled, so only the ``[:P, :Q]`` block can be nonzero."""
    _check_planes(ahi, alo, bhi, blo, mode, nr)
    if ahi.device.type == "cpu":
        return slice_gram_plain(ahi, alo, bhi, blo, mode, nr)
    if ahi.device.type != "cuda":
        raise ValueError(f"slice_gram: unsupported device {ahi.device}")
    p, n_pad = ahi.shape
    q = bhi.shape[0]
    if p % _ROW_TILE or not 1 <= q <= _MAX_Q or nr % _COL_STEP:
        raise ValueError(f"slice_gram: the CUDA kernel takes P a multiple of "
                         f"{_ROW_TILE}, Q <= {_MAX_Q} and a chunk that is a "
                         f"multiple of {_COL_STEP}; got P={p}, Q={q}, "
                         f"chunk={nr}")
    for t in (ahi, alo, bhi, blo):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("slice_gram: planes must be contiguous and "
                             "16-byte aligned")
    size = (SLICES * p, SLICES * q)
    out = torch.empty(size, dtype=torch.float32, device=ahi.device)
    part = torch.empty((n_pad // nr, *size), dtype=torch.float32,
                       device=ahi.device)
    with torch.cuda.device(ahi.device):
        stream = torch.cuda.current_stream(ahi.device).cuda_stream
        # the tenth argument is the kernel's keep_alive guard: always 0
        err = _build.lib().gcge_slice_gram(
            ahi.data_ptr(), alo.data_ptr(), bhi.data_ptr(), blo.data_ptr(),
            p, q, n_pad, nr, MODES.index(mode), 0, part.data_ptr(),
            out.data_ptr(), stream)
    _build.check("gcge_slice_gram", err)
    LAUNCHES["slice_gram"] += 1
    return out
