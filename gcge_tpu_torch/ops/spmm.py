"""DIA SpMM: the counterpart of ``gcge_tpu/ops/spmm_pallas.py``.

:func:`dia_spmm` computes ``y = A x`` for DIA storage
``values[d, i] = A[i, i + offsets[d]]`` in two layouts: ``x`` of shape
``(n, m)`` (``transposed=False``, :meth:`DiaOperator.matvec`) or ``(m, n)``
(``transposed=True``, :meth:`DiaOperator.matvec_t`).  On a CUDA tensor it
launches kernel 1 (f64) or kernel 2 (f32) of ``csrc/dia_spmm.cu``, one
staged design in two types, on the launch plan of :func:`dia_plan`; on a CPU
tensor it runs :func:`dia_spmm_reference`, the plain PyTorch version.  Each
kernel has two paths with the same bits: the ``"narrow"`` one holds a column
tile of at most ``DIA_ITEMS`` groups (all of m = 10), the ``"wide"`` one all
columns of its rows up to a slab of ``DIA_SLAB`` (:class:`DiaWidePlan`),
for operands past one tile whose columns are adjacent (the wide solves' CG
operands and windows of V, m = 40 and 80).

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
# the wide path (csrc/dia_spmm.cu, dia_spmm_wide): kSlab, kWideThreads,
# kWideStages, kRun
DIA_SLAB = 80
DIA_WIDE_THREADS = 128
DIA_WIDE_STAGES = 2
DIA_RUN = 4
PATHS = ("narrow", "wide")


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


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def wide_items(item: int, vec: int) -> int:
    """Rows a thread of the wide path holds (``kWideItems`` of
    csrc/dia_spmm.cu): 8, twice that where a read is narrower than 16
    bytes."""
    return 8 * (2 if vec * item < 16 else 1)


@dataclass(frozen=True)
class DiaWidePlan:
    """A launch of the wide path: blocks of ``rows`` rows and one slab of
    columns each; thread t takes column group ``t % G`` of its slab (G =
    slab width / vec) and the ``items`` consecutive rows of row block ``t //
    G``."""
    item: int         # bytes of an element
    vec: int          # elements a thread reads and writes at once
    slab: int         # columns of a block (the last slab may be narrower)
    rt: int           # row blocks of ``items`` rows in a block
    ld: int           # elements a window row takes in shared memory
    skew: int         # elements between row blocks of the window beyond ld
    sh: int           # x's row segments start sh elements past 16 bytes
    two: bool = False   # f64 rows an odd number of doubles apart: row r's
                        # segment at phase (sh + r xs_i) % 2 (sh that of row 0)

    @property
    def items(self) -> int:
        return wide_items(self.item, self.vec)

    @property
    def rows(self) -> int:          # R: rows of a block
        return self.rt * self.items

    @property
    def threads(self) -> int:       # a block's threads, whole warps
        return _round_up(self.slab // self.vec * self.rt, 32)

    def window_row(self, a: int) -> int:
        """Where window row ``a`` starts in a stage (``wide_row``)."""
        return a * self.ld + a // self.items * self.skew

    def stage_elems(self) -> int:
        """Elements of a ring stage (``wide_stage_elems``): the window's
        rows + kRun - 1 rows and their skews, rounded to 16 bytes, then
        kRun value rows."""
        rows = self.rows + DIA_RUN - 1
        window = _round_up(rows * self.ld + (rows // self.items + 1)
                           * self.skew, 16 // self.item)
        return window + DIA_RUN * self.rows

    @property
    def smem(self) -> int:          # bytes of shared memory a block asks
        return DIA_WIDE_STAGES * self.item * self.stage_elems()

    def slabs(self, m: int) -> list[tuple[int, int]]:
        """The ``(first column, width)`` of each slab."""
        return [(c0, min(self.slab, m - c0))
                for c0 in range(0, m, self.slab)]


def wide_skew(item: int, vec: int, groups: int, ld: int) -> int:
    """The skew (in elements, a multiple of 16 bytes) that makes a warp's
    window reads conflict-free: thread t reads ``vec`` elements of row block
    ``t // groups`` at column group ``t % groups``, and the shared memory
    serves ``128 / (vec item)`` such reads at once from different banks when
    their addresses, in reads, are t modulo that count."""
    lanes = 128 // (vec * item)           # reads served together
    per = 16 // item // vec               # reads in 16 bytes
    want = (groups - wide_items(item, vec) * ld // vec) % lanes
    return _round_up(want, per) % lanes * vec


@dataclass(frozen=True)
class DiaPlan:
    vec: int          # elements a thread reads from a window and writes to y
    col_tile: int     # columns of x a block holds (m / col_tile tiles)
    flat: bool        # f32: the window is one range of x, 16-byte copies
    rows16: bool = False    # f64: each window row's segment starts on 16
                            # bytes, 16-byte copies
    row_fast: bool = False  # y's rows are adjacent: a thread's items are one
                            # row's column groups
    wide: DiaWidePlan | None = None     # the wide path's launch, if taken


def _wide_plan(m: int, xs_i: int, xs_j: int, x_ptr16: int, ys_i: int,
               ys_j: int, y_ptr16: int, item: int) -> DiaWidePlan | None:
    """The wide path's plan, or None where it cannot take the layout: x's
    and y's columns must be adjacent and x's rows a multiple of 16 bytes
    apart (every row segment of the window at one 16-byte phase) or, in
    f64, 8 bytes past one (``two``: PAS's contiguous (n, 75) block; the
    rows alternate between two phases, and a window row takes room for the
    higher one)."""
    two = item == 8 and xs_i % 2 == 1
    if m > 1 and (xs_j != 1 or ys_j != 1) or xs_i * item % 16 and not two:
        return None
    per16 = 16 // item
    nslabs = -(-m // DIA_SLAB)
    slab = m if nslabs == 1 else _round_up(-(-m // nslabs), per16)
    # vec: the stores to y and the reads of a window row, both aligned (1
    # where the rows take two phases: xs_i is odd)
    vec = vec_width(m, (ys_i, ys_j, y_ptr16), (xs_i, 1, x_ptr16), item=item)
    sh = x_ptr16 // item % per16
    ld = _round_up((sh | per16 // 2 if two else sh) + slab, per16)
    groups = slab // vec
    return DiaWidePlan(item, vec, slab, max(1, DIA_WIDE_THREADS // groups),
                       ld, wide_skew(item, vec, groups, ld), sh, two)


@functools.lru_cache(maxsize=None)
def dia_plan(m: int, xs_i: int, xs_j: int, x_ptr16: int, ys_i: int,
             ys_j: int, y_ptr16: int, item: int = 4,
             path: str | None = None) -> DiaPlan:
    """Launch plan of kernel 2 (``item`` 4, f32) or kernel 1 (``item`` 8,
    f64) for the logical ``(n, m)`` views of ``x`` and ``y`` given by their
    strides and their ``data_ptr() % 16``.  The narrow path's fields: ``vec``
    follows the stores to ``y`` (:func:`vec_width`); a column tile holds at
    most ``DIA_ITEMS`` groups of ``vec`` columns and is all of ``m`` where it
    can be.  The f32 window copy is flat where x's rows are contiguous and
    adjacent and x starts on 16 bytes; the f64 one copies 16-byte pieces of
    each row where every tile's row segment starts on 16 bytes (unit column
    stride, an even row stride, x on 16 bytes and tiles of an even width or
    one tile).  ``row_fast`` (kernel 1 only): see :func:`row_fast`.

    ``wide``: the wide path's plan (:func:`_wide_plan`) where the path is
    ``"wide"``.  ``path`` None takes it where it can and m needs more than
    one narrow tile, else the narrow path; ``"narrow"`` or ``"wide"``
    forces one (a layout the wide path cannot take raises ``ValueError``).
    On an H100 80GB HBM3 at 700 W (PERF.md) the wide path measured 1.46-2.7
    times as fast as the narrow one at every operand past one tile (m = 20
    to 800).  At m = 10 it measured 0.88-1.00 times as fast at every
    operand of 148,877 or 157,464 rows, whatever the layout; only a halo
    block of 39,366 rows measured 1.10 times, and the plan cannot tell that
    case by the layout it sees, so every m = 10 operand keeps the narrow
    path."""
    if path is not None and path not in PATHS:
        raise ValueError(f"path must be one of {PATHS} or None, got {path!r}")
    vec = vec_width(m, (ys_i, ys_j, y_ptr16), item=item)
    col_tile = min(m, DIA_ITEMS * vec)
    unit = xs_j == 1 or m == 1
    fast = row_fast(m, ys_i, ys_j)
    wide = None
    if path != "narrow":
        wide = _wide_plan(m, xs_i, xs_j, x_ptr16, ys_i, ys_j, y_ptr16, item)
        if wide is None and path == "wide":
            raise ValueError(f"the wide path cannot take x strides "
                             f"({xs_i}, {xs_j}) and y strides ({ys_i}, "
                             f"{ys_j}) at m = {m}")
        if path is None and col_tile == m:
            wide = None
    if item == 4:
        # kernel 2 keeps its column-group-fastest items (csrc/dia_spmm.cu)
        flat = col_tile == m and unit and xs_i == m and x_ptr16 == 0
        return DiaPlan(vec, col_tile, flat, wide=wide)
    rows16 = unit and xs_i % 2 == 0 and x_ptr16 == 0 and \
        (col_tile % 2 == 0 or col_tile == m)
    return DiaPlan(vec, col_tile, False, rows16, fast, wide)


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
             transposed: bool = False, halo: tuple[int, int] = (0, 0),
             path: str | None = None) -> torch.Tensor:
    """``A x`` for DIA ``values`` (ndiag, n) and int32 ``offsets`` (ndiag,).

    ``x`` is ``(n + hl + hr, m)``, or ``(m, n + hl + hr)`` when
    ``transposed``, with any strides; ``halo=(hl, hr)`` (see the module's
    docstring).  The result is ``(n, m)`` or ``(m, n)``, freshly allocated,
    in the memory order of ``x``: like ``torch.empty_like(x)`` for a dense
    ``x``, else contiguous in the logical layout
    (:func:`empty_in_order_of`).  ``path``: None picks the kernel's path by
    :func:`dia_plan`, ``"narrow"`` or ``"wide"`` forces one (measurements
    and tests); both give the same bits."""
    if path is not None and path not in PATHS:
        raise ValueError(f"path must be one of {PATHS} or None, got {path!r}")
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
                    y.data_ptr() % 16, item, path)
    # the value rows in 16-byte pieces: n a multiple of 16 bytes' worth
    vec16 = n % (16 // item) == 0 and values.data_ptr() % 16 == 0
    kind = "f64" if item == 8 else "f32"
    head = (values.data_ptr(), offsets.data_ptr(), ndiag, n, m, x.data_ptr(),
            hl, nx, xs_i)
    w = plan.wide
    if w is not None:
        entry = f"gcge_dia_spmm_wide_{kind}"
        args = (*head, y.data_ptr(), ys_i, ys_j, w.vec, w.slab, w.rt, w.ld,
                w.skew, w.sh, int(vec16))
    else:
        entry = f"gcge_dia_spmm_{kind}"
        args = (*head, xs_j, y.data_ptr(), ys_i, ys_j, plan.vec,
                plan.col_tile, int(plan.flat or plan.rows16), int(vec16),
                int(plan.row_fast))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(_build.lib(), entry)(*args, stream)
    _build.check(entry, err)
    LAUNCHES["dia_" + kind] += 1
    return y
