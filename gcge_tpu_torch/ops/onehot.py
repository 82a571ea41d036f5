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
  :func:`csr_spmm_reference`, the plain PyTorch version.  Both kernels run
  on a plan made once per matrix on the host (:func:`csr_plan`): rows of at
  most ``CSR_SPLIT`` entries in row tiles (:func:`csr_tiles`), longer rows
  on whole blocks (:func:`csr_split`); operands wider than ``CSR_WIDE_M``
  columns on tiles of fewer rows (the wide path).  That part depends on
  ``rowptr`` alone and serves both.  Given ``colidx``, f64 ``values`` and the
  columns as well, the plan of a matrix with long rows also holds its rows
  of more than ``PANEL_MIN`` entries as dense 16 x 8 tiles
  (:func:`csr_panels`), on which kernel 6 runs them on the f64 tensor cores
  where m is at least ``CSR_PANEL_M`` and the tiles are full enough (the
  panel path).
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

import functools
from dataclasses import dataclass

import numpy as np
import torch

from gcge_tpu_torch.ops import _build
from gcge_tpu_torch.ops.operators import LinearOperator, _np_dtype
from gcge_tpu_torch.ops.spmm import (empty_in_order_of, in_order_of,
                                     row_fast, vec_width)

# launches of the CUDA kernels since the last reset, by kernel; and of
# kernels 5 and 6 on the wide path's tiles (``_wide``: their share of
# ``csr_f32`` and ``csr_f64``)
LAUNCHES = {"csr_f32": 0, "csr_f64": 0, "csr_f64_panel": 0,
            "mask_probe": 0, "csr_f32_wide": 0, "csr_f64_wide": 0}

_INT32_MAX = 2 ** 31 - 1
MASK_SHAPE = (8, 128)
# the row tiles of kernels 5 and 6: entries of colidx and values a block
# stages (8 bytes each in shared memory in f32, 12 in f64), and rows a tile
# holds at most
CSR_BUDGET = 1024
CSR_MAX_ROWS = 64
_ALIGN = 4             # entries of a 16-byte copy
# the split path: rows of more entries than CSR_SPLIT run on whole blocks,
# in parts of at most CSR_PART entries (kPart of csrc/csr_spmm.cu, which
# sizes the shared memory that stages a part), a block each
CSR_SPLIT = 256
CSR_PART = 2048
# the panel path of kernel 6 (csrc/csr_spmm.cu, csr_panel_f64): in a matrix
# with rows of the split path, the rows of more than PANEL_MIN entries in
# panels of PANEL_ROWS rows, the columns in k-groups of PANEL_K; taken for m
# of at least CSR_PANEL_M where the entries fill at least PANEL_FILL of the
# tiles (on an H100, PERF.md: faster than the split path at PAS's m = 75 at
# AMG level 2 A, 28 % full, and level 3 A, 71 %; slower at level 2 R, 17 %,
# and at m = 10 everywhere; at m = 40 level 3 A ran slower in one run and
# faster in another)
PANEL_MIN = 32
PANEL_ROWS = 16
PANEL_K = 8
CSR_PANEL_M = 64
PANEL_FILL = 0.2
# a matrix of at most PANEL_NARROW columns (the AMG coarsest level, 1,350)
# has few panels: its k-groups are cut into chunks of PANEL_CHUNK columns,
# each a warp, whose sums a second launch adds in chunk order
PANEL_NARROW = 4096
PANEL_CHUNK = 512
# the wide path of kernels 5 and 6: operands of more than CSR_WIDE_M columns
# run on row tiles of at most CSR_WIDE_BUDGET entries and CSR_WIDE_ROWS rows,
# on the same kernels (on an H100, PERF.md: 3-6 % faster than the 64-row
# tiles at the irregular nev=200 solve's m = 40 operands, 13-23 % at m = 80
# and 100; at m = 20 and at some m = 10 operands slower)
CSR_WIDE_M = 20
CSR_WIDE_BUDGET = 512
CSR_WIDE_ROWS = 32
PATHS = ("split", "panel", "wide")


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
              max_rows: int = CSR_MAX_ROWS,
              longest: int = CSR_SPLIT) -> np.ndarray:
    """The row tiles of kernels 5 and 6 for CSR ``rowptr`` (n+1,), as
    ``(first row, end)`` pairs, int32 ``(ntiles, 2)``.  A tile is a range of
    at most ``max_rows`` whole rows whose entries, widened to 16-byte
    boundaries (``[rowptr[r0] // 4 * 4, ceil4(rowptr[r1]))``), fit
    ``budget`` entries.  Tiles hold only the rows of at most ``longest``
    entries (and of no more than fit the budget alone): the longer rows are
    left out, for the split path (:func:`csr_split`; ``CSR_SPLIT``) or the
    panel path (:func:`csr_panels`; ``PANEL_MIN``).  Greedy from the first
    row, a tile ending before each row left out, so every other row lies in
    exactly one tile."""
    if budget <= 0 or budget % _ALIGN or max_rows <= 0:
        raise ValueError(f"csr_tiles: budget {budget} (a positive multiple "
                         f"of {_ALIGN}) and max_rows {max_rows} > 0 expected")
    rowptr = np.asarray(rowptr, dtype=np.int64)
    n = len(rowptr) - 1
    # a row of budget - 3 entries still fits the budget, widened
    left_out = np.flatnonzero(np.diff(rowptr) >
                              min(longest, budget - (_ALIGN - 1)))
    pairs = []
    r0 = k = 0
    while r0 < n:
        if k < len(left_out) and left_out[k] == r0:
            r0, k = r0 + 1, k + 1
            continue
        stop = int(left_out[k]) if k < len(left_out) else n
        limit = rowptr[r0] // _ALIGN * _ALIGN + budget
        # the last row boundary within the budget (a multiple of 4, so that
        # rowptr[r1] <= limit also bounds its 16-byte ceiling)
        r1 = int(np.searchsorted(rowptr, limit, side="right")) - 1
        r1 = max(r0 + 1, min(r1, r0 + max_rows, stop))
        pairs.append((r0, r1))
        r0 = r1
    return np.asarray(pairs, dtype=np.int32).reshape(-1, 2)


def csr_split(rowptr: np.ndarray, split: int = CSR_SPLIT,
              part: int = CSR_PART) -> tuple[np.ndarray, np.ndarray]:
    """The split path of kernels 5 and 6 for CSR ``rowptr`` (n+1,): every
    row of more than ``split`` entries, cut into ``ceil(len / part)`` parts
    of equal length, each part a block.  Returns ``(blocks, multi)``, int32:
    ``blocks`` (nsplit, 4), one ``(row, part, parts, slot)`` a block, rows of
    more parts first, then in row order, a row's parts together and in
    order, ``slot`` the row of the kernel's scratch that takes the part's
    sums where the row has more than one part (numbered from 0 in that
    order), else -1; ``multi`` (nmulti, 4), one ``(row, first slot, parts,
    0)`` for each row of more than one part, whose parts' sums the kernel
    adds in part order.  A row's entry depends on its length alone."""
    if split < 0 or part <= 0:
        raise ValueError(f"csr_split: split {split} >= 0 and part {part} > 0 "
                         "expected")
    lengths = np.diff(np.asarray(rowptr, dtype=np.int64))
    rows = np.flatnonzero(lengths > split)
    parts = -(-lengths[rows] // part)
    order = np.argsort(-parts, kind="stable")
    rows, parts = rows[order], parts[order]
    several = parts > 1
    first = np.cumsum(np.where(several, parts, 0)) - np.where(several, parts,
                                                               0)
    starts = np.cumsum(parts) - parts
    k = np.arange(int(parts.sum())) - np.repeat(starts, parts)
    slot = np.where(np.repeat(several, parts), np.repeat(first, parts) + k,
                    -1)
    blocks = np.stack([np.repeat(rows, parts), k, np.repeat(parts, parts),
                       slot], axis=1)
    multi = np.stack([rows[several], first[several], parts[several],
                      np.zeros(int(several.sum()), np.int64)], axis=1)
    return blocks.astype(np.int32), multi.astype(np.int32)


def panel_chunks(n_cols: int) -> int:
    """Column chunks of the panel path for a matrix of ``n_cols`` columns:
    one, or chunks of ``PANEL_CHUNK`` at most ``PANEL_NARROW`` columns (a
    function of the columns alone, which a shard of rows shares)."""
    return 1 if n_cols > PANEL_NARROW else max(1, -(-n_cols // PANEL_CHUNK))


def csr_panels(rowptr: np.ndarray, colidx: np.ndarray, values: np.ndarray,
               rows: np.ndarray, n_cols: int):
    """The panel path's plan for the rows ``rows`` of a CSR matrix of
    ``n_cols`` columns: the rows in ascending order, cut into panels of
    ``PANEL_ROWS``, and for each panel the k-groups (columns ``[8 k, 8 k +
    8)``) that hold one of its entries, in column order, each a dense 16 x
    8 tile of values, zeros where the matrix has no entry, in the f64 mma's
    fragment order: slot ``4 (4 (i % 8) + j % 4) + i // 8 + 2 (j // 4)``
    (lane, then its four values) for the entry of the tile's row i and
    column j (csrc/csr_spmm.cu, dmma).  A panel's k-groups fall into the
    column chunks of :func:`panel_chunks`.  Returns ``(rows, ptr, kcol,
    vals, multi, fill)``: int32 (nrows,); int32 (npanels chunks + 1,)
    (chunk c of panel p holds the k-groups ``[ptr[p chunks + c], ptr[p
    chunks + c + 1])``); int32 (nkg,) (a k-group's first column); float64
    (nkg, 128); int32 (nrows, 4), ``(row, k chunks, chunks, 0)`` for the
    k-th row, the combine of its chunks' sums; the share of the tiles' slots
    that hold an entry.  None where a row holds a column twice (the tile
    would add the two values before the product)."""
    rowptr = np.asarray(rowptr, dtype=np.int64)
    rows = np.sort(np.asarray(rows, dtype=np.int64))
    lengths = rowptr[rows + 1] - rowptr[rows]
    total = int(lengths.sum())
    first = np.cumsum(lengths) - lengths
    ent = np.repeat(rowptr[rows] - first, lengths) + np.arange(total)
    k = np.repeat(np.arange(len(rows)), lengths)     # the row's position
    col = np.asarray(colidx, dtype=np.int64)[ent]
    if np.any((col[1:] == col[:-1]) & (k[1:] == k[:-1])):
        return None
    n_groups = -(-n_cols // PANEL_K)
    key = k // PANEL_ROWS * n_groups + col // PANEL_K
    sub, inv = np.unique(key, return_inverse=True)   # by (panel, k-group)
    npanels = -(-len(rows) // PANEL_ROWS)
    chunks = panel_chunks(n_cols)
    width = -(-n_cols // chunks)
    kcol = sub % n_groups * PANEL_K
    ptr = np.searchsorted(sub // n_groups * chunks + kcol // width,
                          np.arange(npanels * chunks + 1))
    i, j = k % PANEL_ROWS, col % PANEL_K
    vals = np.zeros((len(sub), PANEL_ROWS * PANEL_K))
    vals[inv, 4 * (4 * (i % 8) + j % 4) + i // 8 + 2 * (j // 4)] = \
        np.asarray(values, dtype=np.float64)[ent]
    multi = np.stack([rows, np.arange(len(rows)) * chunks,
                      np.full(len(rows), chunks),
                      np.zeros(len(rows), np.int64)], axis=1)
    return (rows.astype(np.int32), ptr.astype(np.int32),
            kcol.astype(np.int32), vals, multi.astype(np.int32),
            total / max(vals.size, 1))


@dataclass(frozen=True)
class CsrPanels:
    """The panel path's plan on the card (:func:`csr_panels`)."""

    rows: torch.Tensor    # (nrows,) int32: the panels' rows, ascending
    ptr: torch.Tensor     # (npanels chunks + 1,) int32: the k-groups
    kcol: torch.Tensor    # (nkg,) int32: a k-group's first column
    vals: torch.Tensor    # (nkg, 128) float64: the tiles, fragment order
    multi: torch.Tensor   # (nrows, 4) int32: the combine of the chunks
    fill: float           # share of the tiles' slots that hold an entry
    tiles: torch.Tensor   # (ntiles, 2) int32: row tiles of the other rows
    chunks: int           # column chunks (panel_chunks)
    values_ptr: int       # data_ptr() of the values the tiles hold

    @property
    def npanels(self) -> int:
        return (self.ptr.shape[0] - 1) // self.chunks


@dataclass(frozen=True)
class CsrPlan:
    tiles: torch.Tensor   # (ntiles, 2) int32 on the card: first row, end
    budget: int           # entries a tile stages
    split: torch.Tensor   # (nsplit + nmulti, 4) int32 on the card: the
                          # split blocks, then the rows of several parts
    nsplit: int
    nmulti: int
    slots: int            # rows of scratch: the parts of those rows
    wide: torch.Tensor    # (nwide, 2) int32: the wide path's row tiles
    panels: CsrPanels | None = None   # kernel 6's panel path (f64 only)


def csr_plan(rowptr: torch.Tensor, colidx: torch.Tensor | None = None,
             values: torch.Tensor | None = None,
             n_cols: int | None = None) -> CsrPlan:
    """The launch plan of kernels 5 and 6 for ``rowptr``, on its device (the
    same for both: it depends on ``rowptr`` alone): the row tiles of
    :func:`csr_tiles` for the rows of at most ``CSR_SPLIT`` entries, at
    ``CSR_BUDGET`` and ``CSR_MAX_ROWS`` and (``wide``) at
    ``CSR_WIDE_BUDGET`` and ``CSR_WIDE_ROWS``, and the split blocks of
    :func:`csr_split` for the longer rows.  Given ``colidx``,
    float64 ``values`` and the matrix's ``n_cols`` too, and where there are
    split rows, ``panels`` holds the rows of more than ``PANEL_MIN`` entries
    for kernel 6's panel path (:func:`csr_panels`, reading both to the
    host) and the row tiles of the others.  It reads ``rowptr`` to the host
    and copies the plan back: build it once per matrix (:class:`CsrOperator`
    does, when it is built), never while a CUDA graph is being captured."""
    rp = rowptr.cpu().numpy().astype(np.int64)
    blocks, multi = csr_split(rp)
    dev = rowptr.device
    panels = None
    if len(blocks) and values is not None and \
            values.dtype == torch.float64:
        made = csr_panels(rp, colidx.cpu().numpy(), values.cpu().numpy(),
                          np.flatnonzero(np.diff(rp) > PANEL_MIN), n_cols)
        if made is not None:
            *arrays, fill = made
            panels = CsrPanels(
                *(torch.as_tensor(t, device=dev) for t in arrays), fill,
                torch.as_tensor(csr_tiles(rp, longest=PANEL_MIN),
                                device=dev),
                panel_chunks(n_cols), values.data_ptr())
    return CsrPlan(torch.as_tensor(csr_tiles(rp), device=dev),
                   CSR_BUDGET,
                   torch.as_tensor(np.concatenate([blocks, multi]),
                                   device=dev),
                   len(blocks), len(multi), int(multi[:, 2].sum()),
                   torch.as_tensor(csr_tiles(rp, CSR_WIDE_BUDGET,
                                             CSR_WIDE_ROWS), device=dev),
                   panels)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def csr_path(plan: CsrPlan, values: torch.Tensor, m: int) -> str:
    """The path on which :func:`csr_spmm` runs a matrix, given no ``path``:
    ``"panel"`` (the long rows on panels) where the plan holds panels for
    these ``values``, m is at least ``CSR_PANEL_M`` and the tiles are at
    least ``PANEL_FILL`` full; else ``"wide"`` (the short rows on the wide
    tiles, the long rows split) where m is above ``CSR_WIDE_M``; else
    ``"split"`` (the short rows on the row tiles, the long rows split).
    The panel choice is the matrix's: a shard of its rows with its own plan
    may fill its tiles otherwise; the wide choice is m's alone."""
    pn = plan.panels
    held = pn is not None and values.dtype == torch.float64 and \
        pn.values_ptr == values.data_ptr()
    if held and m >= CSR_PANEL_M and pn.fill >= PANEL_FILL:
        return "panel"
    return "wide" if m > CSR_WIDE_M else "split"


def panel_launch(npanels: int, m: int, sms: int) -> tuple[int, int]:
    """``(warps, nt)`` of a panel launch for ``npanels`` panels (times their
    column chunks): panels a block and n-tiles of 8 columns a warp: 5 (each
    tile read once a slab of 40 columns, the most that keeps the next
    k-groups' fragments in registers) where that leaves four warps an SM,
    else 2; four panels a block where that leaves two blocks an SM, else
    one."""
    ntiles = -(-m // 8)
    nt = 5 if ntiles > 2 and npanels * -(-ntiles // 5) >= 4 * sms else 2
    blocks = -(-npanels // 4) * -(-ntiles // nt)
    return (4 if blocks >= 2 * sms else 1), nt


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
             transposed: bool = False, plan: CsrPlan | None = None,
             path: str | None = None) -> torch.Tensor:
    """``A x`` for CSR ``rowptr`` (n+1,) and ``colidx`` (nnz,) int32 and
    ``values`` (nnz,) of the dtype of ``x``.

    ``x`` is ``(n_cols, m)``, or ``(m, n_cols)`` when ``transposed``, with any
    strides; every ``colidx`` must be below ``n_cols`` (the packers check
    it).  The result is ``(n, m)`` or ``(m, n)``, freshly allocated, in the
    memory order of ``x``: like ``torch.empty_like(x)`` for a dense ``x``,
    else contiguous in the logical layout (``spmm.empty_in_order_of``).
    ``plan``: the launch plan for this ``rowptr`` (:func:`csr_plan`), which
    a product on a card needs.  ``path``: None takes :func:`csr_path`'s
    choice; ``"split"`` (the row tiles and the split path), ``"wide"`` (the
    wide path's tiles and the split path) or ``"panel"`` forces one
    (measurements and tests; ``"panel"`` raises ``ValueError`` where the
    plan holds no panels for ``values``).  The split and the wide path give
    the same bits (a row's sum is the same chain wherever its tile ends);
    the panel path others (another summation order), each the same on every
    launch and in a shard of rows that takes the same path."""
    if path is not None and path not in PATHS:
        raise ValueError(f"path must be one of {PATHS} or None, got {path!r}")
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
    pn = plan.panels
    if path == "panel" and not (pn is not None and
                                values.dtype == torch.float64 and
                                pn.values_ptr == values.data_ptr()):
        raise ValueError("csr_spmm: the plan holds no panels for these "
                         "values (csr_plan(rowptr, colidx, values, n_cols), "
                         "f64)")
    chosen = path or csr_path(plan, values, m)
    panel, wide = chosen == "panel", chosen == "wide"
    item = x.element_size()
    vec = vec_width(m, (xs_i, xs_j, x.data_ptr()), (ys_i, ys_j, y.data_ptr()),
                    item=item)
    copy16 = colidx.data_ptr() % 16 == 0 and values.data_ptr() % 16 == 0
    # the row tiles (the wide path's, or those of the rows the panel path
    # leaves) and split blocks; the partial sums of the rows of several
    # parts, added by the kernel's second launch
    tiles, budget = (plan.wide, CSR_WIDE_BUDGET) if wide else \
        (pn.tiles if panel else plan.tiles, plan.budget)
    nsplit, nmulti = (0, 0) if panel else (plan.nsplit, plan.nmulti)
    scratch = torch.empty((plan.slots, m), dtype=x.dtype, device=x.device) \
        if nmulti else None
    entry, counter = ("gcge_csr_spmm_f64", "csr_f64") if item == 8 else \
        ("gcge_csr_spmm_f32", "csr_f32")
    lib = _build.lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(
            rowptr.data_ptr(), colidx.data_ptr(), values.data_ptr(), nnz,
            tiles.data_ptr(), tiles.shape[0], budget,
            plan.split.data_ptr(), nsplit, nmulti,
            None if scratch is None else scratch.data_ptr(), m,
            x.data_ptr(), xs_i, xs_j, y.data_ptr(), ys_i, ys_j, vec,
            int(copy16), int(row_fast(m, ys_i, ys_j)), stream)
        _build.check(entry, err)
        if panel:
            warps, nt = panel_launch(pn.npanels * pn.chunks, m,
                                     _sm_count(x.device.index))
            # the chunks' sums, added in chunk order by a second launch
            part = torch.empty((pn.rows.shape[0] * pn.chunks, m),
                               dtype=x.dtype, device=x.device) \
                if pn.chunks > 1 else None
            err = lib.gcge_csr_panel_f64(
                pn.rows.data_ptr(), pn.rows.shape[0], pn.ptr.data_ptr(),
                pn.npanels, pn.chunks, pn.kcol.data_ptr(),
                pn.vals.data_ptr(), pn.multi.data_ptr(),
                None if part is None else part.data_ptr(),
                x.shape[1 if transposed else 0], m, x.data_ptr(), xs_i,
                xs_j, y.data_ptr(), ys_i, ys_j, warps, nt, stream)
            _build.check("gcge_csr_panel_f64", err)
            LAUNCHES["csr_f64_panel"] += 1
    LAUNCHES[counter] += 1
    if wide:
        LAUNCHES[counter + "_wide"] += 1
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
    card the operator makes the launch plan of both kernels when it is
    built, so that a captured CG stage finds it on the card."""

    def __init__(self, rowptr: torch.Tensor, colidx: torch.Tensor,
                 values: torch.Tensor, n_cols: int):
        self.rowptr = rowptr      # (n_rows + 1,) int32
        self.colidx = colidx      # (nnz,) int32, sorted within each row
        self.values = values      # (nnz,)
        self.n_cols = int(n_cols)
        self._values32 = None
        self.plan = csr_plan(rowptr, colidx, values, self.n_cols) \
            if rowptr.device.type == "cuda" else None

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
