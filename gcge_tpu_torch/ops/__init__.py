"""Operators, multivector ops, the projected eigensolvers and the CUDA
kernels of the port (DIA SpMM in :mod:`.spmm`, tall GEMMs in :mod:`.osgemm`,
CSR SpMM and the mask probe in :mod:`.onehot`, the FMA probe and the
sliced-Gram isolation kernel in :mod:`.probes`, the Jacobi sweeps in
:mod:`.eighs`)."""

from gcge_tpu_torch.ops.eighs import (eigh, eigh_jacobi, eigh_newton,
                                      jacobi_polish, safe_eigh)
from gcge_tpu_torch.ops.multivec import (axpby, block_inner, col_dots,
                                         column_mask, gram, linear_comb, qtap,
                                         range_mask, set_random)
from gcge_tpu_torch.ops.operators import (DenseOperator, DiagOperator,
                                          DiaOperator, FunctionOperator,
                                          HybridOperator, IdentityOperator,
                                          LinearOperator, ShiftedOperator,
                                          SparseOperator, make_operator)
from gcge_tpu_torch.ops.onehot import CsrOperator, bf16_mask_supported
from gcge_tpu_torch.ops.probes import fma_probe, slice_gram

__all__ = [
    "eigh", "eigh_jacobi", "eigh_newton", "safe_eigh", "jacobi_polish",
    "LinearOperator", "DenseOperator", "DiagOperator", "DiaOperator",
    "FunctionOperator", "HybridOperator", "IdentityOperator",
    "ShiftedOperator", "SparseOperator", "CsrOperator", "make_operator",
    "bf16_mask_supported", "fma_probe", "slice_gram", "col_dots", "gram", "block_inner",
    "axpby", "linear_comb", "qtap", "set_random", "column_mask", "range_mask",
]
