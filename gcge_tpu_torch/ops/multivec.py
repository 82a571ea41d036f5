"""Block (multi-vector) operations — the counterpart of ``gcge_tpu/ops/multivec.py``.

A multivector is a tensor of shape ``(n, m)`` whose columns are the vectors.
Each function is one or two tensor expressions on the operands' device.
Under a row mesh (:class:`gcge_tpu_torch.parallel.RowMesh`, passed as
``mesh``) each rank holds its rows of the multivectors, and a contraction
over rows is the local one followed by :func:`psum`.
"""

from __future__ import annotations

import torch

# Row-chunk length of the Gram contraction.  The chunked sum is the plain
# version of the tall Gram kernel (gcge_tpu_torch.ops.osgemm.tall_gram) and
# keeps the summation order of gcge_tpu.ops.multivec.gram.
GRAM_CHUNK = 256
# budget for the materialized per-chunk partial products of `gram`; past it
# the chunks are summed in groups
GRAM_PART_BYTES = 256 * 2**20


def psum(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``mesh`` (one ``all_reduce``); ``t``
    itself without a mesh."""
    return t if mesh is None else mesh.psum(t)


def col_dots(x: torch.Tensor, y: torch.Tensor, mesh=None) -> torch.Tensor:
    """Per-column dots ``sum(x * y, axis=0)`` — the 'D' inner product."""
    return psum((x * y).sum(dim=0), mesh)


def gram(x: torch.Tensor, y: torch.Tensor, chunk: int = GRAM_CHUNK
         ) -> torch.Tensor:
    """Gram block ``x^T y`` by chunked contraction: per-chunk products,
    then a sum over the chunks."""
    n, mx = x.shape
    my = y.shape[1]
    if n <= chunk:
        return x.T @ y
    k = -(-n // chunk)
    pad = k * chunk - n
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        y = torch.nn.functional.pad(y, (0, 0, 0, pad))
    xr = x.reshape(k, chunk, mx)
    yr = y.reshape(k, chunk, my)
    g = max(1, GRAM_PART_BYTES // max(mx * my * x.element_size(), 1))
    if k <= g:
        return torch.bmm(xr.transpose(1, 2), yr).sum(dim=0)
    acc = torch.zeros((mx, my), dtype=x.dtype, device=x.device)
    for s in range(0, k, g):
        acc = acc + torch.bmm(xr[s:s + g].transpose(1, 2),
                              yr[s:s + g]).sum(dim=0)
    return acc


def block_inner(x: torch.Tensor, y: torch.Tensor, mode: str = "N",
                mesh=None) -> torch.Tensor:
    """'N': ``x^T y``; 'S': the same, symmetrized; 'D': column dots."""
    if mode == "D":
        return col_dots(x, y, mesh)
    g = psum(gram(x, y), mesh)
    if mode == "S":
        g = 0.5 * (g + g.T)
    return g


def axpby(alpha, x: torch.Tensor | None, beta, y: torch.Tensor
          ) -> torch.Tensor:
    """``alpha*x + beta*y`` columnwise; ``x=None`` scales ``y``."""
    if x is None:
        return beta * y
    return alpha * x + beta * y


def linear_comb(x: torch.Tensor | None, coef: torch.Tensor | None,
                y: torch.Tensor, beta=None) -> torch.Tensor:
    """``x @ coef + y * diag(beta)``; ``x=None`` skips the product and
    ``beta=None`` drops the ``y`` term."""
    acc = None
    if x is not None and coef is not None:
        acc = x @ coef
    if beta is not None:
        yb = y * beta
        acc = yb if acc is None else acc + yb
    if acc is None:
        raise ValueError("linear_comb: nothing to compute "
                         "(x/coef and beta both None)")
    return acc


def qtap(q: torch.Tensor, a_matvec, p: torch.Tensor, mode: str = "N"
         ) -> torch.Tensor:
    """``Q^T A P`` with ``a_matvec`` a multivector product (None: A = I)."""
    ap = p if a_matvec is None else a_matvec(p)
    return block_inner(q, ap, mode)


def set_random(generator: torch.Generator, shape, dtype=torch.float64,
               device=None) -> torch.Tensor:
    """Random multivector, uniform in (-1, 1), drawn from ``generator``
    (on the generator's device unless ``device`` is given)."""
    device = generator.device if device is None else device
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return 2.0 * u - 1.0


def column_mask(m: int, count, dtype=torch.float64, device=None
                ) -> torch.Tensor:
    """``(m,)`` mask with ones in the first ``count`` entries."""
    return (torch.arange(m, device=device) < count).to(dtype)


def range_mask(m: int, start, end, dtype=torch.float64, device=None
               ) -> torch.Tensor:
    """``(m,)`` mask of the half-open column window ``[start, end)``."""
    idx = torch.arange(m, device=device)
    return ((idx >= start) & (idx < end)).to(dtype)
