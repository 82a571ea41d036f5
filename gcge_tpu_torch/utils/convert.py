"""Carry operators across from plain arrays.

:func:`operator_from_numpy` builds the port's operator from a dict of numpy
arrays, so an operator built elsewhere (for example by ``gcge_tpu``, read
into such a dict) can be handed to the port without the port importing it.
"""

from __future__ import annotations

import numpy as np
import torch

from gcge_tpu_torch.ops.onehot import CsrOperator
from gcge_tpu_torch.ops.operators import (DenseOperator, DiagOperator,
                                          DiaOperator, HybridOperator,
                                          SparseOperator)


def _csr_from_entries(rows, cols, vals, shape, *, device, dtype):
    """CSR operator from padded entry arrays: zero-value padding dropped."""
    rows, cols, vals = (np.asarray(a).reshape(-1) for a in (rows, cols, vals))
    keep = vals != 0
    return CsrOperator.from_coo(
        rows[keep], cols[keep], vals[keep], shape, device=device,
        dtype=dtype or torch.from_numpy(np.empty(0, vals.dtype)).dtype)


def operator_from_numpy(state: dict, *, device, dtype=None):
    """Operator on ``device`` from ``state``, one of

    * ``{"kind": "dia", "values", "offsets", "n_cols"}`` (a df64 DIA
      operator arrives as its f64 ``values``);
    * ``{"kind": "ell", "values", "indices", "n_cols"}``;
    * ``{"kind": "onehot", "t_ids", "w_ids", "rloc", "cloc", "pvals",
      "pvals_lo", "r_tile", "w_tile", "n"}``: the pair arrays of a one-hot
      operator.  Entry ``[p, j]`` is row ``t_ids[p] * r_tile + rloc[p, j]``,
      column ``w_ids[p] * w_tile + cloc[p, j]``, value ``pvals + pvals_lo``
      in f64; it arrives as a :class:`CsrOperator`;
    * ``{"kind": "hybrid", "dia": <a "dia" state>, "ell": <an "ell" state> or
      None}``: the ELL remainder arrives as the CSR ``rest`` of a
      :class:`HybridOperator`;
    * ``{"kind": "diag", "d"}``;
    * ``{"kind": "dense", "a"}``.

    ``dtype`` casts the values (default: keep the arrays' dtype)."""
    def t(arr):
        return torch.as_tensor(np.array(arr), dtype=dtype, device=device)

    kind = state["kind"]
    if kind == "dia":
        return DiaOperator(t(state["values"]),
                           tuple(int(o) for o in state["offsets"]),
                           int(state["n_cols"]))
    if kind == "ell":
        indices = torch.as_tensor(np.array(state["indices"], np.int64),
                                  device=device)
        return SparseOperator(t(state["values"]), indices,
                              int(state["n_cols"]))
    if kind == "onehot":
        n = int(state["n"])
        t_ids, w_ids = np.asarray(state["t_ids"]), np.asarray(state["w_ids"])
        rows = t_ids[:, None].astype(np.int64) * int(state["r_tile"]) \
            + np.asarray(state["rloc"])
        cols = w_ids[:, None].astype(np.int64) * int(state["w_tile"]) \
            + np.asarray(state["cloc"])
        vals = np.asarray(state["pvals"], np.float64) \
            + np.asarray(state["pvals_lo"], np.float64)
        return _csr_from_entries(rows, cols, vals, (n, n), device=device,
                                 dtype=dtype)
    if kind == "hybrid":
        dia = operator_from_numpy(state["dia"], device=device, dtype=dtype)
        ell, rest = state["ell"], None
        if ell is not None:
            values = np.asarray(ell["values"])
            rows = np.repeat(np.arange(values.shape[0]), values.shape[1])
            rest = _csr_from_entries(
                rows, ell["indices"], values,
                (values.shape[0], int(ell["n_cols"])), device=device,
                dtype=dtype)
        return HybridOperator(dia, rest)
    if kind == "diag":
        return DiagOperator(t(state["d"]))
    if kind == "dense":
        return DenseOperator(t(state["a"]))
    raise ValueError(f"unknown operator kind {kind!r}")
