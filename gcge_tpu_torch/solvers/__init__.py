"""Solvers of the port: GCG (phased and fused loops), block PCG, block
orthonormalization, AMG and the multilevel PAS solver."""

from gcge_tpu_torch.solvers.bpcg import (BlockPCGInfo, BlockPCGParams,
                                         block_pcg, block_pcg_t, pcg)
from gcge_tpu_torch.solvers.gcg import GCGParams, GCGResult, gcg_solve
from gcge_tpu_torch.solvers.multigrid import (MGHierarchy, MGLevel,
                                              bamg_preconditioner, bamg_solve,
                                              build_hierarchy,
                                              chebyshev_smooth,
                                              multivec_from_i_to_j)
from gcge_tpu_torch.solvers.orth import (bgs_orth, mgs_orth, orth_against,
                                         orth_block, orth_block_against,
                                         orth_within)
from gcge_tpu_torch.solvers.pas import AugmentedOperator, PASResult, pas_solve

__all__ = ["BlockPCGInfo", "BlockPCGParams", "block_pcg", "block_pcg_t",
           "pcg", "GCGParams", "GCGResult", "gcg_solve", "MGHierarchy",
           "MGLevel", "bamg_preconditioner", "bamg_solve", "build_hierarchy",
           "chebyshev_smooth", "multivec_from_i_to_j", "orth_against",
           "orth_block", "orth_block_against", "orth_within", "bgs_orth",
           "mgs_orth", "AugmentedOperator", "PASResult", "pas_solve"]
