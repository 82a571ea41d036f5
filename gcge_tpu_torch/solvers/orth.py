"""Block B-orthonormalization with rank deflation — the counterpart of
``gcge_tpu/solvers/orth.py`` (EVP method).

Shapes stay fixed: the returned multivector has its ``rank`` valid columns
compacted at the front and exact zeros behind; ``rank`` is a 0-d integer
tensor on the operands' device.  The tall products (``q^T B x``, ``x u``)
run through :func:`gcge_tpu_torch.ops.osgemm.tall_gram` and
:func:`~gcge_tpu_torch.ops.osgemm.tall_expand`, the CUDA kernels 3 and 4 on
the card; the small eigenproblems through
:func:`gcge_tpu_torch.ops.eighs.safe_eigh`.
"""

from __future__ import annotations

import torch

from gcge_tpu_torch.ops.eighs import safe_eigh
from gcge_tpu_torch.ops.multivec import col_dots
from gcge_tpu_torch.ops.osgemm import tall_expand, tall_gram

# precisions the port accepts; both mean f64 products ('auto' resolves to
# f64 everywhere off the TPU in gcge_tpu)
PRECISIONS = ("auto", "f64")


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"orth precision {precision!r}: the port computes "
                         f"in f64 and accepts {PRECISIONS}")


def _rel_floor(dtype: torch.dtype) -> float:
    """Gram-eigenvalue relative deflation floor: 64 eps."""
    return 64.0 * torch.finfo(dtype).eps


def orth_against(x, q, b_matvec=None, passes: int = 2,
                 precision: str = "f64"):
    """``x <- x - q (q^T B x)``, ``passes`` times, for a B-orthonormal
    ``q``.  Zero (masked) columns of either block are no-ops."""
    _check_precision(precision)
    for _ in range(passes):
        bx = x if b_matvec is None else b_matvec(x)
        coef = tall_gram(q, bx)
        x = x - tall_expand(q, coef)
    return x


def orth_block(x, b_matvec=None, zero_tol: float = 1e-13, passes: int = 2,
               ref_scale2=None, precision: str = "f64"):
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
        g = tall_gram(x, bx)
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
        x = tall_expand(x, u * scale[None, :])
        cnt = valid.sum()
        rank = cnt if rank is None else torch.minimum(rank, cnt)
    if rank is None:
        rank = torch.full((), x.shape[1], dtype=torch.int64, device=x.device)
    return _ns_polish(x, b_matvec), rank


def _ns_polish(x, b_matvec=None):
    """One Newton-Schulz step ``x <- x (3I - x^T B x)/2``; zero columns stay
    zero."""
    bx = x if b_matvec is None else b_matvec(x)
    g = tall_gram(x, bx)
    m = x.shape[1]
    eye = torch.eye(m, dtype=x.dtype, device=x.device)
    return tall_expand(x, 1.5 * eye - 0.5 * g)


def orth_within(x, b_matvec=None, zero_tol: float = 1e-13, passes: int = 2,
                ref_scale2=None, method: str = "evp", precision: str = "f64"):
    """In-block B-orthonormalization.  ``method='evp'``
    (:func:`orth_block`) is ported; ``'bgs'`` and ``'mgs'`` are not yet."""
    if method == "evp":
        return orth_block(x, b_matvec, zero_tol=zero_tol, passes=passes,
                          ref_scale2=ref_scale2, precision=precision)
    if method in ("bgs", "mgs"):
        raise NotImplementedError(f"orth method {method!r} is not ported "
                                  f"yet (ROADMAP Queue 1 item 3)")
    raise ValueError(f"unknown orth method {method!r}")


def orth_block_against(x, q, b_matvec=None, zero_tol: float = 1e-13,
                       passes: int = 2, ref_scale2=None, method: str = "evp",
                       precision: str = "auto"):
    """Orthonormalize ``x`` against ``q`` and within itself, ``passes``
    times, then project once more.  The deflation scale is the entry-time
    largest column norm, so a direction that is small because most of ``x``
    lay in span(q) survives.  Returns ``(x, rank)``."""
    _check_precision(precision)
    if ref_scale2 is None:
        bx = x if b_matvec is None else b_matvec(x)
        ref_scale2 = torch.clamp(col_dots(x, bx).max(), min=1e-300)
    rank = torch.full((), x.shape[1], dtype=torch.int64, device=x.device)
    for i in range(passes):
        x = orth_against(x, q, b_matvec, passes=1, precision=precision)
        x, r = orth_within(x, b_matvec, zero_tol=zero_tol, passes=1,
                           ref_scale2=ref_scale2 if i == 0 else None,
                           method=method, precision=precision)
        rank = torch.minimum(rank, r)
    # the last within-block recombination can re-amplify span(q) leakage of
    # near-floor directions; one more projection removes it
    return orth_against(x, q, b_matvec, passes=1, precision=precision), rank
