"""Block B-orthonormalization with rank deflation — the counterpart of
``gcge_tpu/solvers/orth.py``: the EVP kernel (:func:`orth_block`), the
binary split (:func:`bgs_orth`) and column-wise modified Gram-Schmidt
(:func:`mgs_orth`).

Shapes stay fixed: the returned multivector has its ``rank`` valid columns
compacted at the front and exact zeros behind; ``rank`` is a 0-d integer
tensor on the operands' device.  ``precision`` routes the tall products
(``q^T B x``, ``x u``) as ``gcge_tpu`` routes them: ``'auto'`` through
:func:`gcge_tpu_torch.ops.osgemm.tall_gram` and
:func:`~gcge_tpu_torch.ops.osgemm.tall_expand` (the CUDA kernels 3 and 4 on
the card, where ``gcge_tpu`` takes its sliced GEMMs on the TPU), ``'f64'``
through the plain :func:`gcge_tpu_torch.ops.multivec.gram` and ``@`` (as
``gcge_tpu`` does for the small P-coefficient block).  On the CPU both are
the same functions.  The small eigenproblems go through
:func:`gcge_tpu_torch.ops.eighs.safe_eigh`.  Under a row mesh (``mesh``)
the tall blocks are each rank's rows and every Gram and column dot is summed
over the ranks (:func:`gcge_tpu_torch.ops.multivec.psum`); the small
problems are then the same on every rank.

On a grid that splits columns (``mesh.col_split`` above 1) GCG hands
:func:`orth_block_against` its columns of the new block and of the basis.
The block is narrow: every rank of a grid row gathers it whole (one
``all_gather``) and orthonormalizes it on its rows as under a row mesh,
with B applied to its columns and gathered
(:func:`gcge_tpu_torch.ops.multivec.whole_matvec`), then keeps its
columns.  The basis stays split: :func:`orth_against` multiplies the
rank's columns of it by the whole block, and the grid row sums the
partial recombinations (``all_reduce``).
"""

from __future__ import annotations

import torch

from gcge_tpu_torch.ops import osgemm
from gcge_tpu_torch.ops.eighs import safe_eigh
from gcge_tpu_torch.ops.multivec import (col_dots, col_split, gather_cols,
                                         gram, own_cols, psum, sum_cols,
                                         whole_matvec)

# precisions the port accepts; both compute in f64: 'auto' on kernels 3/4,
# 'f64' on plain products
PRECISIONS = ("auto", "f64")


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"orth precision {precision!r}: the port computes "
                         f"in f64 and accepts {PRECISIONS}")


def _gram_p(a, b, precision: str, mesh=None):
    """Tall Gram ``a^T b``: kernel 3 ('auto') or the plain chunked Gram,
    summed over the ranks of ``mesh``."""
    return psum(osgemm.tall_gram(a, b) if precision == "auto" else gram(a, b),
                mesh)


def _expand_p(a, c, precision: str):
    """Recombination ``a @ c``: kernel 4 ('auto') or the plain product."""
    return osgemm.tall_expand(a, c) if precision == "auto" else a @ c


def _rel_floor(dtype: torch.dtype) -> float:
    """Gram-eigenvalue relative deflation floor: 64 eps."""
    return 64.0 * torch.finfo(dtype).eps


def orth_against(x, q, b_matvec=None, passes: int = 2,
                 precision: str = "f64", mesh=None):
    """``x <- x - q (q^T B x)``, ``passes`` times, for a B-orthonormal
    ``q``.  Zero (masked) columns of either block are no-ops.  On a grid
    that splits columns ``q`` is the rank's columns and ``x`` the whole
    block: each rank projects out its columns of ``q``, and the grid row
    sums the projections."""
    _check_precision(precision)
    for _ in range(passes):
        bx = x if b_matvec is None else b_matvec(x)
        coef = _gram_p(q, bx, precision, mesh)
        x = x - sum_cols(_expand_p(q, coef, precision), mesh)
    return x


def orth_block(x, b_matvec=None, zero_tol: float = 1e-13, passes: int = 2,
               ref_scale2=None, precision: str = "f64", mesh=None):
    """B-orthonormalize the columns of ``x`` with rank deflation.

    Per pass: ``G = x^T B x``, ``w, u = eigh(G)``, recombine
    ``x u diag(1/sqrt(w))`` in descending eigenvalue order, dropping
    directions with ``w <= max(zero_tol^2 ref_scale2, 64 eps w_max)`` (later
    passes: ``zero_tol``).  ``ref_scale2`` defaults to the first pass's
    largest Gram eigenvalue.  Ends with one Newton-Schulz polish.
    Returns ``(x_orth, rank)``."""
    _check_precision(precision)
    floor = _rel_floor(x.dtype)
    rank = None
    for i in range(passes):
        bx = x if b_matvec is None else b_matvec(x)
        g = _gram_p(x, bx, precision, mesh)
        g = 0.5 * (g + g.T)
        w, u = safe_eigh(g)
        w = w.flip(0)
        u = u.flip(1)
        w_max = torch.clamp(w[0], min=1e-300)
        if ref_scale2 is None and i == 0:
            ref_scale2 = w_max
        thresh = (zero_tol * zero_tol) * ref_scale2 if i == 0 else zero_tol
        # no tensor is made from a Python number: on a card that is a copy
        # from the host, which the fused iteration must not wait for
        if torch.is_tensor(thresh):
            thresh = torch.maximum(thresh, floor * w_max)
        else:
            thresh = torch.clamp(floor * w_max, min=thresh)
        valid = w > thresh
        scale = torch.where(valid, torch.rsqrt(torch.where(valid, w, 1.0)),
                            0.0)
        x = _expand_p(x, u * scale[None, :], precision)
        cnt = valid.sum()
        rank = cnt if rank is None else torch.minimum(rank, cnt)
    if rank is None:
        rank = torch.full((), x.shape[1], dtype=torch.int64, device=x.device)
    return _ns_polish(x, b_matvec, precision, mesh), rank


def _ns_polish(x, b_matvec=None, precision: str = "f64", mesh=None):
    """One Newton-Schulz step ``x <- x (3I - x^T B x)/2``; zero columns stay
    zero."""
    bx = x if b_matvec is None else b_matvec(x)
    g = _gram_p(x, bx, precision, mesh)
    m = x.shape[1]
    eye = torch.eye(m, dtype=x.dtype, device=x.device)
    return _expand_p(x, 1.5 * eye - 0.5 * g, precision)


def orth_within(x, b_matvec=None, zero_tol: float = 1e-13, passes: int = 2,
                ref_scale2=None, method: str = "evp", precision: str = "f64",
                mesh=None):
    """In-block B-orthonormalization: ``method='evp'`` (:func:`orth_block`),
    ``'bgs'`` (:func:`bgs_orth`) or ``'mgs'`` (:func:`mgs_orth`).  bgs and
    mgs zero dependent columns in place; here the zero columns are moved to
    the back in a stable order, since GCG's count-based masks take the valid
    columns to be the first ones.  Returns ``(x, rank)``."""
    if method == "evp":
        return orth_block(x, b_matvec, zero_tol=zero_tol, passes=passes,
                          ref_scale2=ref_scale2, precision=precision,
                          mesh=mesh)
    if method == "bgs":
        x, rank = bgs_orth(x, b_matvec, zero_tol=zero_tol, passes=passes,
                           ref_scale2=ref_scale2, precision=precision,
                           mesh=mesh)
    elif method == "mgs":
        _check_precision(precision)
        x, rank = mgs_orth(x, b_matvec, zero_tol=zero_tol * zero_tol,
                           mesh=mesh)
    else:
        raise ValueError(f"unknown orth method {method!r}")
    zero = (col_dots(x, x, mesh) == 0).to(torch.int8)
    order = torch.sort(zero, stable=True).indices
    return x.index_select(1, order), rank


def orth_block_against(x, q, b_matvec=None, zero_tol: float = 1e-13,
                       passes: int = 2, ref_scale2=None, method: str = "evp",
                       precision: str = "auto", mesh=None):
    """Orthonormalize ``x`` against ``q`` and within itself, ``passes``
    times, then project once more.  The deflation scale is the entry-time
    largest column norm, so a direction that is small because most of ``x``
    lay in span(q) survives.  On a grid that splits columns ``x`` and ``q``
    are the rank's columns: the block is gathered whole, orthonormalized on
    every rank of the grid row, and split again.  Returns ``(x, rank)``."""
    _check_precision(precision)
    inner = mesh
    if col_split(mesh) > 1:
        x = gather_cols(x, mesh)
        b_matvec = None if b_matvec is None else whole_matvec(b_matvec, mesh)
        inner = mesh.replicated()
    if ref_scale2 is None:
        bx = x if b_matvec is None else b_matvec(x)
        ref_scale2 = torch.clamp(col_dots(x, bx, inner).max(), min=1e-300)
    rank = torch.full((), x.shape[1], dtype=torch.int64, device=x.device)
    for i in range(passes):
        x = orth_against(x, q, b_matvec, passes=1, precision=precision,
                         mesh=mesh)
        x, r = orth_within(x, b_matvec, zero_tol=zero_tol, passes=1,
                           ref_scale2=ref_scale2 if i == 0 else None,
                           method=method, precision=precision, mesh=inner)
        rank = torch.minimum(rank, r)
    # the last within-block recombination can re-amplify span(q) leakage of
    # near-floor directions; one more projection removes it
    x = orth_against(x, q, b_matvec, passes=1, precision=precision,
                     mesh=mesh)
    return own_cols(x, mesh), rank


def bgs_orth(x, b_matvec=None, zero_tol: float = 1e-13, passes: int = 2,
             leaf: int = 16, ref_scale2=None, precision: str = "auto",
             mesh=None):
    """Binary-split B-orthonormalization (the reference's
    ``BinaryGramSchmidt``): orthonormalize the left half, project it out of
    the right half, recurse into the right half; blocks of at most ``leaf``
    columns go to :func:`orth_block`.  Dependent columns are zeroed in
    place, not compacted across halves; the rank counts the surviving
    columns.  Deflation is judged against the entry's largest column norm
    (``ref_scale2``).  The projections and Grams run through
    :func:`orth_against` and :func:`orth_block` at ``precision`` (``'auto'``:
    kernels 3 and 4 on the card).  Reads nothing back to the host."""
    _check_precision(precision)
    if ref_scale2 is None:
        bx = x if b_matvec is None else b_matvec(x)
        ref_scale2 = torch.clamp(col_dots(x, bx, mesh).max(), min=1e-30)
    m = x.shape[1]
    if m <= leaf:
        return orth_block(x, b_matvec, zero_tol=zero_tol, passes=passes,
                          ref_scale2=ref_scale2, precision=precision,
                          mesh=mesh)
    half = m // 2
    left, lrank = bgs_orth(x[:, :half], b_matvec, zero_tol, passes, leaf,
                           ref_scale2, precision, mesh)
    right = orth_against(x[:, half:], left, b_matvec, passes=passes,
                         precision=precision, mesh=mesh)
    right, rrank = bgs_orth(right, b_matvec, zero_tol, passes, leaf,
                            ref_scale2, precision, mesh)
    # the right half's recombinations can re-grow left components at
    # rounding level: one more projection, then a Newton-Schulz polish
    right = orth_against(right, left, b_matvec, passes=1, precision=precision,
                         mesh=mesh)
    right = _ns_polish(right, b_matvec, precision, mesh)
    return torch.cat([left, right], dim=1), lrank + rrank


def mgs_orth(x, b_matvec=None, zero_tol: float = 1e-14, reorth: int = 1,
             mesh=None):
    """Column-wise modified Gram-Schmidt with deflation (the reference's
    ``OrthSelf``), a test oracle: a column whose B-norm squared is at most
    ``zero_tol`` after ``1 + reorth`` sweeps of projections is zeroed in
    place.  Returns ``(x, rank)``, ``rank`` a 0-d tensor.  Quadratic in the
    column count; reads nothing back to the host."""
    def bmv(v):
        return v if b_matvec is None else b_matvec(v[:, None])[:, 0]

    cols = []
    rank = torch.zeros((), dtype=torch.int64, device=x.device)
    for k in range(x.shape[1]):
        v = x[:, k]
        for _ in range(1 + reorth):
            for q in cols:
                v = v - q * psum(q @ bmv(v), mesh)
        nrm2 = psum(v @ bmv(v), mesh)
        ok = nrm2 > zero_tol
        v = v * torch.where(ok, torch.rsqrt(torch.where(ok, nrm2, 1.0)), 0.0)
        cols.append(v)
        rank = rank + ok
    return torch.stack(cols, dim=1), rank
