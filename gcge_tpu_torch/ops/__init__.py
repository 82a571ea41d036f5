"""Operators, multivector ops, the projected eigensolver and the CUDA kernels
of the port (DIA SpMM in :mod:`.spmm`, tall GEMMs in :mod:`.osgemm`)."""

from gcge_tpu_torch.ops.multivec import (axpby, block_inner, col_dots,
                                         column_mask, gram, linear_comb, qtap,
                                         range_mask, set_random)
from gcge_tpu_torch.ops.operators import (DenseOperator, DiagOperator,
                                          DiaOperator, FunctionOperator,
                                          IdentityOperator, LinearOperator,
                                          ShiftedOperator, SparseOperator,
                                          make_operator)

__all__ = [
    "LinearOperator", "DenseOperator", "DiagOperator", "DiaOperator",
    "FunctionOperator", "IdentityOperator", "ShiftedOperator",
    "SparseOperator", "make_operator", "col_dots", "gram", "block_inner",
    "axpby", "linear_comb", "qtap", "set_random", "column_mask", "range_mask",
]
