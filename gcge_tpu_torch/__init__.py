"""gcge_tpu_torch — the PyTorch/CUDA port of ``gcge_tpu``.

Computes the smallest ``nev`` eigenpairs of large symmetric (generalized)
eigenproblems ``A x = lambda B x`` with the GCG algorithm on one NVIDIA
Hopper card (or, with the plain PyTorch versions of the kernels, on the CPU).
The module layout and names mirror ``gcge_tpu``; the kernels that
``gcge_tpu`` writes in Pallas for the TPU are CUDA C++ for ``sm_90a`` here
(``gcge_tpu_torch/ops/csrc``), built at first use.  The device is always
given by the caller.
"""

import torch

# a reference states its matmul precision: no TF32 anywhere in the port
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from gcge_tpu_torch.ops.operators import (  # noqa: E402
    DenseOperator,
    DiagOperator,
    DiaOperator,
    FunctionOperator,
    HybridOperator,
    IdentityOperator,
    LinearOperator,
    ShiftedOperator,
    SparseOperator,
    make_operator,
)
from gcge_tpu_torch.ops.onehot import CsrOperator, bf16_mask_supported  # noqa: E402
from gcge_tpu_torch.ops.probes import fma_probe, slice_gram  # noqa: E402
from gcge_tpu_torch.api import eigsh, solve  # noqa: E402
from gcge_tpu_torch.solvers.gcg import GCGParams, GCGResult, gcg_solve  # noqa: E402
from gcge_tpu_torch.solvers.bpcg import BlockPCGParams, block_pcg  # noqa: E402
from gcge_tpu_torch.solvers.orth import orth_against, orth_block  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "LinearOperator",
    "DenseOperator",
    "DiagOperator",
    "FunctionOperator",
    "DiaOperator",
    "HybridOperator",
    "CsrOperator",
    "IdentityOperator",
    "ShiftedOperator",
    "SparseOperator",
    "make_operator",
    "GCGParams",
    "GCGResult",
    "gcg_solve",
    "solve",
    "eigsh",
    "BlockPCGParams",
    "block_pcg",
    "orth_block",
    "orth_against",
    "bf16_mask_supported",
    "fma_probe",
    "slice_gram",
]
