"""Block (multi-vector) operations — the counterpart of ``gcge_tpu/ops/multivec.py``.

A multivector is a tensor of shape ``(n, m)`` whose columns are the vectors.
Each function is one or two tensor expressions on the operands' device.
Under a row mesh (:class:`gcge_tpu_torch.parallel.RowMesh`, passed as
``mesh``) each rank holds its rows of the multivectors, and a contraction
over rows is the local one followed by :func:`psum`.

On a grid that splits columns (:class:`gcge_tpu_torch.parallel.GridMesh`
with ``col_split`` C above 1) a rank also holds only its columns of a
column-sharded multivector: column ``j`` lies on the rank whose grid column
is ``j % C``, so each of a basis' blocks ``[X | P | W]`` (widths multiples
of C) is split evenly, and a block cut from it at a multiple of C keeps the
layout.  The functions below with ``cols`` or ``whole`` in their names
move columns (over the grid's column group) and reduce to plain
expressions where C is 1: :func:`own_cols`, :func:`gather_cols`,
:func:`sum_cols`, :func:`select_cols`, :func:`whole_matvec`, and the
all-gather products :func:`gram_cols` (the rank's rows of ``a^T b`` for its
columns of ``a``, summed over the rows, then gathered over the columns)
and :func:`expand_cols` (its columns of ``a c``: the partial products of
the ranks of a grid row, summed over them).  :func:`psum` and
:func:`col_dots` sum over the rows only.
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
    """Per-column dots ``sum(x * y, axis=0)`` — the 'D' inner product (of
    the columns the rank holds)."""
    return psum((x * y).sum(dim=0), mesh)


def col_split(mesh) -> int:
    """The column shards of a multivector under ``mesh``: a grid's
    ``col_split``, else 1."""
    return 1 if mesh is None else getattr(mesh, "col_split", 1)


def own_cols(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The rank's columns ``x[:, col::C]`` of a block every rank of its grid
    row holds whole (``x`` itself where C is 1 or does not divide the
    width); 1-D ``x`` is a row of per-column values."""
    c = col_split(mesh)
    if c == 1 or x.shape[-1] % c:
        return x
    return x[..., mesh.col::c].contiguous()


def gather_cols(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The whole block from the ranks' columns ``x`` (the inverse of
    :func:`own_cols`; one ``all_gather`` over the grid row); 1-D ``x`` is a
    row of per-column values."""
    c = col_split(mesh)
    if c == 1:
        return x
    parts = mesh.col_gather(x)                  # (C, ..., k / C)
    return parts.movedim(0, -1).reshape(x.shape[:-1] + (-1,))


def sum_cols(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """``t`` summed over the ranks of the grid row (one ``all_reduce``);
    ``t`` itself where the columns are not split."""
    return t if col_split(mesh) == 1 else mesh.col_sum(t)


def select_cols(x: torch.Tensor, idx: torch.Tensor, mesh=None
                ) -> torch.Tensor:
    """The columns ``idx`` (global indices, a device tensor) of the
    column-sharded ``x``, whole on every rank of the grid row: each rank
    puts in the columns it holds and zeros elsewhere, and the row sums them
    (one ``all_reduce``; a sum of one value and zeros is that value)."""
    c = col_split(mesh)
    if c == 1:
        return x[:, idx]
    mine = (idx % c == mesh.col)[None, :]
    local = torch.clamp(idx // c, max=x.shape[1] - 1)
    return sum_cols(torch.where(mine, x.index_select(1, local), 0.0), mesh)


def whole_matvec(matvec, mesh=None):
    """``matvec`` for a block that every rank of a grid row holds whole: it
    runs on the rank's columns and the product is gathered over the row
    (on the whole block where the split does not divide its width)."""
    c = col_split(mesh)
    if c == 1:
        return matvec

    def apply(x):
        if x.shape[1] % c:
            return matvec(x)
        return gather_cols(matvec(own_cols(x, mesh)), mesh)
    return apply


def gram_cols(a: torch.Tensor, b: torch.Tensor, mesh, gram_fn
              ) -> torch.Tensor:
    """``a^T b`` (``gram_fn(a, b)`` locally) for the rank's columns of ``a``
    and the whole ``b``: summed over the rows, then the rows of the product
    gathered over the grid row into the whole ``(k_a, k_b)``."""
    g = psum(gram_fn(a, b), mesh)
    c = col_split(mesh)
    if c == 1:
        return g
    parts = mesh.col_gather(g)                  # (C, k_a / C, k_b)
    return parts.transpose(0, 1).reshape(-1, g.shape[1])


def expand_cols(a: torch.Tensor, coef: torch.Tensor, mesh, expand_fn
                ) -> torch.Tensor:
    """The rank's columns of ``a @ coef`` (``expand_fn`` locally) for its
    columns of ``a``: each rank multiplies by the rows of ``coef`` of the
    columns it holds, the grid row sums the partial products (one
    ``all_reduce``), and the rank keeps its columns."""
    c = col_split(mesh)
    if c == 1:
        return expand_fn(a, coef)
    part = expand_fn(a, coef[mesh.col::c].contiguous())
    return own_cols(sum_cols(part, mesh), mesh)


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
