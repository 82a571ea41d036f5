"""Carry operators across from plain arrays.

:func:`operator_from_numpy` builds the port's operator from a dict of numpy
arrays, so an operator built elsewhere (for example by ``gcge_tpu``, read
into such a dict) can be handed to the port without the port importing it.
"""

from __future__ import annotations

import numpy as np
import torch

from gcge_tpu_torch.ops.operators import (DenseOperator, DiagOperator,
                                          DiaOperator, SparseOperator)


def operator_from_numpy(state: dict, *, device, dtype=None):
    """Operator on ``device`` from ``state``, one of

    * ``{"kind": "dia", "values", "offsets", "n_cols"}`` (a df64 DIA
      operator arrives as its f64 ``values``);
    * ``{"kind": "ell", "values", "indices", "n_cols"}``;
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
    if kind == "diag":
        return DiagOperator(t(state["d"]))
    if kind == "dense":
        return DenseOperator(t(state["a"]))
    raise ValueError(f"unknown operator kind {kind!r}")
