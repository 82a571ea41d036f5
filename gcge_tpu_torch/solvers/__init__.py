"""Solvers of the port: GCG (phased path), block PCG, block orthonormalization."""

from gcge_tpu_torch.solvers.bpcg import (BlockPCGInfo, BlockPCGParams,
                                         block_pcg, block_pcg_t)
from gcge_tpu_torch.solvers.gcg import GCGParams, GCGResult, gcg_solve
from gcge_tpu_torch.solvers.orth import (orth_against, orth_block,
                                         orth_block_against, orth_within)

__all__ = ["BlockPCGInfo", "BlockPCGParams", "block_pcg", "block_pcg_t",
           "GCGParams", "GCGResult", "gcg_solve", "orth_against",
           "orth_block", "orth_block_against", "orth_within"]
