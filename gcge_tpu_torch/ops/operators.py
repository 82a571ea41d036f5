"""Linear operators — the counterpart of ``gcge_tpu/ops/operators.py``.

An operator holds its tensors on one explicit ``device`` and has one method,
``matvec(X) -> A @ X``, on multivectors of shape ``(n, m)``; the solvers are
generic over it.

* :class:`DenseOperator`    — dense symmetric matrix.
* :class:`SparseOperator`   — ELL (padded-row) sparse matrix, gather SpMM.
* :class:`DiaOperator`      — DIA (diagonal) storage; ``matvec``/``matvec_t``
  run the DIA kernels of :mod:`gcge_tpu_torch.ops.spmm` on CUDA.
* :class:`HybridOperator`   — DIA core plus a CSR remainder.
* :class:`DiagOperator`     — diagonal (mass) matrix.
* :class:`IdentityOperator` — B = I.
* :class:`ShiftedOperator`  — ``A + sigma*B``, applied without forming it.
* :class:`FunctionOperator` — matrix-free, from a multivector function.

The irregular layout, :class:`~gcge_tpu_torch.ops.onehot.CsrOperator`, lives
with its kernels in :mod:`gcge_tpu_torch.ops.onehot`; :func:`make_operator`
picks among DIA, Hybrid and CSR.

``gcge_tpu``'s ``DiaDF64Operator`` stores f64 values as f32 hi/lo planes
because the TPU has no f64; the port's f64 :class:`DiaOperator` runs the
native-f64 kernel instead.
"""

from __future__ import annotations

import numpy as np
import torch

from gcge_tpu_torch.ops.spmm import dia_spmm


def _np_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


class LinearOperator:
    """Protocol: symmetric linear operator on multivectors ``(n, m)``."""

    shape: tuple[int, int]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)


class DenseOperator(LinearOperator):
    """Dense symmetric operator; matvec is one GEMM."""

    def __init__(self, a: torch.Tensor):
        self.a = a

    @property
    def shape(self):
        return tuple(self.a.shape)

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self):
        return self.a.device

    def matvec(self, x):
        return self.a @ x


class DiagOperator(LinearOperator):
    """Diagonal operator (e.g. lumped mass matrix)."""

    def __init__(self, d: torch.Tensor):
        self.d = d

    @property
    def shape(self):
        return (self.d.shape[0], self.d.shape[0])

    @property
    def dtype(self):
        return self.d.dtype

    @property
    def device(self):
        return self.d.device

    def matvec(self, x):
        return self.d[:, None] * x


class IdentityOperator(LinearOperator):
    """B = I for standard eigenproblems ``A x = lambda x``."""

    def __init__(self, n: int, dtype=torch.float64, device="cuda"):
        self.n = int(n)
        self.dtype = dtype
        self.device = torch.device(device)

    @property
    def shape(self):
        return (self.n, self.n)

    def matvec(self, x):
        return x


class ShiftedOperator(LinearOperator):
    """``(A + sigma * B) x`` without forming ``A + sigma B``."""

    def __init__(self, a: LinearOperator, b: LinearOperator | None, sigma):
        self.a = a
        self.b = b
        self.sigma = sigma

    @property
    def shape(self):
        return self.a.shape

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self):
        return self.a.device

    def matvec(self, x):
        y = self.a.matvec(x)
        bx = x if self.b is None else self.b.matvec(x)
        return y + self.sigma * bx


class FunctionOperator(LinearOperator):
    """Matrix-free symmetric operator from a multivector function
    ``fn(x: (n, m)) -> (n, m)``."""

    def __init__(self, fn, n: int, dtype=torch.float64, device="cuda"):
        self.fn = fn
        self.n = int(n)
        self.dtype = dtype
        self.device = torch.device(device)

    @property
    def shape(self):
        return (self.n, self.n)

    def matvec(self, x):
        return self.fn(x)


class SparseOperator(LinearOperator):
    """Symmetric sparse operator in ELL (padded-row) layout.

    ``y[i] = sum_k values[i, k] * x[indices[i, k]]``; padded entries carry
    ``values == 0`` and index row 0.  A plain gather SpMM, as ``gcge_tpu``
    leaves it to XLA."""

    def __init__(self, values: torch.Tensor, indices: torch.Tensor,
                 n_cols: int):
        self.values = values      # (n_rows, kmax), zero-padded
        self.indices = indices    # (n_rows, kmax) int64, 0-padded
        self.n_cols = int(n_cols)

    @property
    def shape(self):
        return (self.values.shape[0], self.n_cols)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def nnz(self):
        return int(torch.count_nonzero(self.values))

    def matvec(self, x):
        y = torch.zeros((self.values.shape[0], x.shape[1]), dtype=x.dtype,
                        device=x.device)
        for k in range(self.values.shape[1]):
            y = y + self.values[:, k, None] * x[self.indices[:, k]]
        return y

    @classmethod
    def from_coo(cls, rows, cols, vals, shape, dtype=torch.float64, *,
                 device):
        """Pack COO triplets to ELL on the host, then move to ``device``."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        n_rows, n_cols = shape
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        counts = np.bincount(rows, minlength=n_rows)
        kmax = max(int(counts.max()) if len(counts) else 0, 1)
        values = np.zeros((n_rows, kmax), dtype=_np_dtype(dtype))
        indices = np.zeros((n_rows, kmax), dtype=np.int64)
        row_start = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=row_start[1:])
        pos = np.arange(len(rows)) - row_start[rows]
        values[rows, pos] = vals
        indices[rows, pos] = cols
        return cls(torch.as_tensor(values, device=device),
                   torch.as_tensor(indices, device=device), n_cols)

    @classmethod
    def from_scipy(cls, mat, dtype=torch.float64, *, device):
        coo = mat.tocoo()
        return cls.from_coo(coo.row, coo.col, coo.data, coo.shape,
                            dtype=dtype, device=device)

    def to_dense(self):
        n = self.values.shape[0]
        out = torch.zeros((n, self.n_cols), dtype=self.dtype,
                          device=self.device)
        rows = torch.arange(n, device=self.device).repeat_interleave(
            self.values.shape[1])
        out.index_put_((rows, self.indices.reshape(-1)),
                       self.values.reshape(-1), accumulate=True)
        return out


class DiaOperator(LinearOperator):
    """Sparse operator in DIA (diagonal) layout.

    ``y[i] = sum_d values[d, i] * x[i + offsets[d]]`` with fixed offsets: a
    shift and a multiply-add per diagonal, no gathers.  On CUDA ``matvec``
    and ``matvec_t`` launch the DIA kernel (f64: kernel 1, f32: kernel 2)."""

    def __init__(self, values: torch.Tensor, offsets, n_cols: int):
        self.values = values          # (ndiag, n_rows); values[d, i] = A[i, i+off_d]
        self.offsets = tuple(int(o) for o in offsets)
        self.n_cols = int(n_cols)
        self.offsets_t = torch.tensor(self.offsets, dtype=torch.int32,
                                      device=values.device)

    @property
    def shape(self):
        return (self.values.shape[1], self.n_cols)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def nnz(self):
        return int(torch.count_nonzero(self.values))

    def matvec(self, x):
        """``x (n, m) -> A @ x (n, m)``."""
        return dia_spmm(self.values, self.offsets_t, x, transposed=False)

    def matvec_t(self, xt):
        """Transposed layout: ``xt (m, n) -> (A @ x)^T (m, n)``; the layout
        of the mixed-precision inner CG."""
        return dia_spmm(self.values, self.offsets_t, xt, transposed=True)

    @classmethod
    def from_coo(cls, rows, cols, vals, shape, dtype=torch.float64, *,
                 device):
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        n_rows, n_cols = shape
        offs = cols - rows
        uniq = np.unique(offs)
        values = np.zeros((len(uniq), n_rows), dtype=_np_dtype(dtype))
        values[np.searchsorted(uniq, offs), rows] = vals
        return cls(torch.as_tensor(values, device=device),
                   tuple(uniq.tolist()), n_cols)

    def to_dense(self):
        n = self.values.shape[1]
        out = torch.zeros((n, self.n_cols), dtype=self.dtype,
                          device=self.device)
        rows = torch.arange(n, device=self.device)
        for d, off in enumerate(self.offsets):
            cols = rows + off
            ok = (cols >= 0) & (cols < self.n_cols)
            out[rows[ok], cols[ok]] += self.values[d, rows[ok]]
        return out

    @staticmethod
    def n_diagonals(rows, cols) -> int:
        return len(np.unique(np.asarray(cols) - np.asarray(rows)))


class HybridOperator(LinearOperator):
    """DIA core plus an irregular remainder — the counterpart of
    ``gcge_tpu``'s ``HybridOperator``.

    After RCM reordering most irregular symmetric matrices are almost banded:
    the bulk of the nonzeros lands on a few hundred diagonals, with a thin
    scatter of outliers.  The dominant diagonals go to the DIA layout
    (kernels 1 and 2 on the card); the leftovers, which ``gcge_tpu`` keeps in
    a narrow gather-ELL, go to a
    :class:`~gcge_tpu_torch.ops.onehot.CsrOperator` (kernels 5 and 6).
    ``rest`` is None when the diagonals hold everything."""

    def __init__(self, dia: DiaOperator, rest):
        self.dia = dia
        self.rest = rest

    @property
    def shape(self):
        return self.dia.shape

    @property
    def dtype(self):
        return self.dia.dtype

    @property
    def device(self):
        return self.dia.device

    @property
    def nnz(self):
        return self.dia.nnz + (0 if self.rest is None else self.rest.nnz)

    def matvec(self, x):
        y = self.dia.matvec(x)
        if self.rest is not None:
            y = y + self.rest.matvec(x)
        return y

    def to_dense(self):
        d = self.dia.to_dense()
        return d if self.rest is None else d + self.rest.to_dense()

    @classmethod
    def from_coo(cls, rows, cols, vals, shape, dtype=torch.float64, *,
                 device, max_diags: int = 128):
        """The ``max_diags`` most populated diagonals to DIA, the rest to
        CSR."""
        from gcge_tpu_torch.ops.onehot import CsrOperator

        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        offs = cols - rows
        uniq, counts = np.unique(offs, return_counts=True)
        keep = uniq[np.argsort(-counts)[:max_diags]]
        in_dia = np.isin(offs, keep)
        dia = DiaOperator.from_coo(rows[in_dia], cols[in_dia], vals[in_dia],
                                   shape, dtype=dtype, device=device)
        rest = None
        if (~in_dia).any():
            rest = CsrOperator.from_coo(rows[~in_dia], cols[~in_dia],
                                        vals[~in_dia], shape, dtype=dtype,
                                        device=device)
        return cls(dia, rest)


def make_operator(rows, cols, vals, shape, dtype=torch.float64, *, device,
                  max_diags: int = 128, hybrid_cover: float = 0.85,
                  hybrid_max_ell_width: int = 8):
    """Pick the sparse layout for the pattern, under ``gcge_tpu``'s rule:

    * **DIA** when at most ``max_diags`` diagonals are stored;
    * **Hybrid** (DIA core + CSR outliers) when the top ``max_diags``
      diagonals cover ``hybrid_cover`` of the nonzeros and the remainder is
      at most ``hybrid_max_ell_width`` entries a row;
    * **CSR** for any other square pattern, on every device (``gcge_tpu``'s
      one-hot fill and byte guards are the TPU's cost model and have no
      counterpart);
    * **ELL** for rectangular matrices.
    """
    from gcge_tpu_torch.ops.onehot import CsrOperator

    rows = np.asarray(rows)
    cols = np.asarray(cols)
    if shape[0] != shape[1]:
        return SparseOperator.from_coo(rows, cols, vals, shape, dtype=dtype,
                                       device=device)
    offs = cols - rows
    uniq, counts = np.unique(offs, return_counts=True)
    if len(uniq) <= max_diags:
        return DiaOperator.from_coo(rows, cols, vals, shape, dtype=dtype,
                                    device=device)
    order = np.argsort(-counts)
    covered = counts[order[:max_diags]].sum() / max(len(offs), 1)
    if covered >= hybrid_cover:
        out = ~np.isin(offs, uniq[order[:max_diags]])
        width = np.bincount(rows[out], minlength=shape[0]).max() \
            if out.any() else 0
        if width <= hybrid_max_ell_width:
            return HybridOperator.from_coo(rows, cols, vals, shape,
                                           dtype=dtype, device=device,
                                           max_diags=max_diags)
    return CsrOperator.from_coo(rows, cols, vals, shape, dtype=dtype,
                                device=device)
