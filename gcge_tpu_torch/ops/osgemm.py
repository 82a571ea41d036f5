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

Each kernel has two paths (:func:`tall_path`).  The ``"narrow"`` path is
the design above, for the classes of a nev=50 solve (p, q, k at most
128), which are bound by their bytes.  The ``"wide"`` path takes the
classes with one side above 128 and the other at least 64 (the
production widths, m = 480 and 960, bound by their f64 operations where
both sides are wide): 128 x 128 output tiles of register-blocked mma
warps over the whole contraction, in one launch (the expand) or one
launch and the ordered chunk sum (the Gram).

Every launch decision is a Python function of shapes, strides and
``data_ptr()`` (:func:`copy_vec`, :func:`c_mode`, :func:`tall_path`,
:func:`gram_plan`, :func:`expand_plan`, :func:`wide_gram_plan`,
:func:`wide_expand_plan`),
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
WIDE_FROM = 128       # a side above this takes the wide path ...
WIDE_MIN_SIDE = 64    # ... where the other side is at least this wide
WIDE_MIN_ROWS = 1024  # fewest rows a wide Gram chunk is given


@dataclass(frozen=True)
class WideShape:
    """A block of the wide path, ``Wide<WM, WN, MT, NT, K, STAGES, MINB>``
    of ``csrc/tall_gemm.cu``: WM x WN warps of MT x NT mma tiles (16 x 8),
    k-slices of K through a ring of STAGES, MINB blocks an SM."""
    wm: int
    wn: int
    mt: int
    nt: int
    k: int
    stages: int
    per_sm: int

    @property
    def bm(self) -> int:          # rows of the output tile
        return 16 * self.mt * self.wm

    @property
    def bn(self) -> int:          # its columns
        return 8 * self.nt * self.wn

    @property
    def pitches(self) -> tuple[int, int, int]:
        """Row pitches in doubles of the expand's A stage [bm][k + 8] and
        of the [k][bm + 2] and [k][bn + 2] stages."""
        return self.k + 8, self.bm + 2, self.bn + 2

    @property
    def smem_expand(self) -> int:
        pa, _, pn = self.pitches
        return 8 * self.stages * (self.bm * pa + self.k * pn)

    @property
    def smem_gram(self) -> int:
        _, pm, pn = self.pitches
        return 8 * self.stages * self.k * (pm + pn)


# the block both wide kernels launch (WideShape of tall_gemm.cu): 128 x 128
# tiles of 8 warps, k-slices of 32 through 3 stages, one block an SM
WIDE = WideShape(2, 4, 4, 4, 32, 3, 1)
SM_SMEM = 233_472     # shared memory of an SM, 1 KB of it kept a block
PATHS = ("narrow", "wide")


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


def c_mode(c: torch.Tensor) -> int:
    """How the wide expand copies C: 1, 16-byte copies of its rows (rows on
    16 bytes, columns contiguous); 2, 16-byte copies of its columns into a
    transposed stage (column-major with columns on 16 bytes, the layout
    ``torch.linalg.eigh`` gives its eigenvectors, so the solver's
    ``c[:, :size_x]``); else 0, 8-byte copies (any strides)."""
    if copy_vec(c) == 2:
        return 1
    k, q = c.shape
    if c.data_ptr() % 16 == 0 and (k <= 1 or c.stride(0) == 1) \
            and (q <= 1 or c.stride(1) % 2 == 0):
        return 2
    return 0


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


def tall_path(p: int, q: int) -> str:
    """The path of kernel 3 at ``(p x q)`` or of kernel 4 at ``(n x p)(p x
    q)``: ``"wide"`` where one side exceeds the narrow path's resident tile
    (WIDE_FROM) and the other is at least WIDE_MIN_SIDE; else ``"narrow"``
    (the resident designs above: every class of a nev=50 solve, and the
    (480 x 40) and (440 x 40) classes of nev=200, where most of the wide
    path's warps would idle and it measured slower)."""
    return "wide" if max(p, q) > WIDE_FROM and min(p, q) >= WIDE_MIN_SIDE \
        else "narrow"


def _makespan(units: int, slots: int, size: float) -> float:
    """Time of ``units`` equal blocks of ``size`` on ``slots`` blocks that
    run at once."""
    return _cdiv(units, slots) * size


@dataclass(frozen=True)
class WideGramPlan:
    chunks: int          # chunks of rows; blocks = chunks x tiles
    rows: int            # rows per chunk
    tiles: int           # output tiles of WIDE.bm x WIDE.bn
    smem: int            # dynamic shared memory, bytes


@functools.lru_cache(maxsize=None)
def wide_gram_plan(n: int, p: int, q: int, sms: int) -> WideGramPlan:
    """Launch plan of kernel 3's wide path: the chunk count whose blocks
    (chunks x tiles, WIDE.per_sm an SM at a time) finish soonest,
    chunks of at least WIDE_MIN_ROWS rows, the fewest chunks within 2 % of
    the best (each chunk costs a partial of p q doubles)."""
    tiles = _cdiv(p, WIDE.bm) * _cdiv(q, WIDE.bn)
    most = max(1, min(n // WIDE_MIN_ROWS, GRAM_MAX_CHUNKS))
    cost = {c: _makespan(tiles * c, sms * WIDE.per_sm, _cdiv(n, c))
            for c in range(1, most + 1)}
    best = min(cost.values())
    chunks = min(c for c, v in cost.items() if v <= 1.02 * best)
    rows = _cdiv(n, chunks)
    return WideGramPlan(_cdiv(n, rows), rows, tiles, WIDE.smem_gram)


@dataclass(frozen=True)
class WideExpandPlan:
    band: int            # rows of Y a block (a multiple of 16)
    q_tile: int          # columns of Y a block (a multiple of 8)
    blocks: int          # one launch: bands x q-tiles, q-tiles fastest
    smem: int            # dynamic shared memory, bytes


@functools.lru_cache(maxsize=None)
def wide_expand_plan(n: int, k: int, q: int, sms: int) -> WideExpandPlan:
    """Launch plan of kernel 4's wide path: one launch over all of k and
    q.  The q-tiles are WIDE.bn wide (the last one narrower); the row
    band, a multiple of 16 from WIDE.bm down to half of it, is the one
    whose blocks finish soonest, the widest within 2 % of the best (a
    wider band reads C fewer times)."""
    q_tile = min(WIDE.bn, 8 * _cdiv(q, 8))
    q_tiles = _cdiv(q, q_tile)
    cost = {band: _makespan(_cdiv(n, band) * q_tiles, sms * WIDE.per_sm,
                            band)
            for band in range(WIDE.bm, WIDE.bm // 2 - 1, -16)}
    best = min(cost.values())
    band = max(b for b, v in cost.items() if v <= 1.02 * best)
    return WideExpandPlan(band, q_tile, _cdiv(n, band) * q_tiles,
                          WIDE.smem_expand)


def _path(path, p: int, q: int) -> str:
    if path is None:
        return tall_path(p, q)
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS} or None, got {path!r}")
    return path


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


def tall_gram(a: torch.Tensor, b: torch.Tensor, path: str | None = None
              ) -> torch.Tensor:
    """``a^T b`` ((n, p), (n, q) -> (p, q)); operands may be strided views.
    ``path``: None picks it by :func:`tall_path`; ``"narrow"`` or
    ``"wide"`` forces one (for measurements and tests only)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"tall_gram: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not contract")
    n, p = a.shape
    q = b.shape[1]
    path = _path(path, p, q)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return tall_gram_reference(a, b)
    _check_cuda("tall_gram", a, b)
    c = torch.empty((p, q), dtype=a.dtype, device=a.device)
    if p * q == 0:
        return c
    if n == 0:
        return c.zero_()
    sms = _build.sm_count(a.device)
    plan = gram_plan(n, p, q, sms) if path == "narrow" \
        else wide_gram_plan(n, p, q, sms)
    part = torch.empty((plan.chunks, p, q), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if path == "narrow":
            name = "gcge_tall_gram_f64"
            err = _build.lib().gcge_tall_gram_f64(
                a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(),
                b.stride(0), b.stride(1), n, p, q, plan.chunks, plan.rows,
                plan.bk, plan.pitch_a, plan.pitch_b, plan.wm, plan.nt,
                plan.smem, copy_vec(a, b),
                part.data_ptr(), c.data_ptr(), stream)
        else:
            name = "gcge_tall_gram_wide_f64"
            err = _build.lib().gcge_tall_gram_wide_f64(
                a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(),
                b.stride(0), b.stride(1), n, p, q, plan.chunks, plan.rows,
                copy_vec(a, b), part.data_ptr(), c.data_ptr(), stream)
    _build.check(name, err)
    LAUNCHES["gram"] += 1
    return c


def tall_expand(a: torch.Tensor, c: torch.Tensor, path: str | None = None
                ) -> torch.Tensor:
    """``a @ c`` ((n, k), (k, q) -> (n, q)); operands may be strided views.
    ``path`` as for :func:`tall_gram`."""
    if a.dim() != 2 or c.dim() != 2 or a.shape[1] != c.shape[0]:
        raise ValueError(f"tall_expand: shapes {tuple(a.shape)} and "
                         f"{tuple(c.shape)} do not contract")
    n, k = a.shape
    q = c.shape[1]
    path = _path(path, k, q)
    if a.device.type == "cpu" and c.device.type == "cpu":
        return tall_expand_reference(a, c)
    _check_cuda("tall_expand", a, c)
    y = torch.empty((n, q), dtype=a.dtype, device=a.device)
    if n * q == 0:
        return y
    if k == 0:
        return y.zero_()
    sms = _build.sm_count(a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if path == "narrow":
            name = "gcge_tall_expand_f64"
            plan = expand_plan(n, k, q, sms)
            err = _build.lib().gcge_tall_expand_f64(
                a.data_ptr(), a.stride(0), a.stride(1), c.data_ptr(),
                c.stride(0), c.stride(1), n, k, q, plan.q_tile, plan.k_chunk,
                plan.nt, plan.grid, plan.smem, copy_vec(a), y.data_ptr(),
                stream)
        else:
            name = "gcge_tall_expand_wide_f64"
            wide = wide_expand_plan(n, k, q, sms)
            err = _build.lib().gcge_tall_expand_wide_f64(
                a.data_ptr(), a.stride(0), a.stride(1), c.data_ptr(),
                c.stride(0), c.stride(1), n, k, q, wide.band, wide.q_tile,
                copy_vec(a), c_mode(c), y.data_ptr(), stream)
    _build.check(name, err)
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
