"""Row-sharded distribution on ``torch.distributed`` — the counterpart of
``gcge_tpu/parallel``: one process a card (NCCL) or a CPU worker (gloo),
each holding its rows of the operators and multivectors."""

from gcge_tpu_torch.parallel.dist_ops import (RowShardedOperator,
                                              shard_operator)
from gcge_tpu_torch.parallel.mesh import (RowMesh, gather_rows, grid_mesh,
                                          pad_problem, row_mesh, shard_rows)
from gcge_tpu_torch.parallel.multihost import (bootstrap,
                                               check_host_major,
                                               csr_from_host_blocks,
                                               dia_from_host_blocks,
                                               hybrid_row_mesh,
                                               mv_from_host_blocks)
from gcge_tpu_torch.parallel.dist_mg import (ProlongOperator,
                                             RestrictOperator,
                                             shard_hierarchy)

__all__ = ["RowMesh", "row_mesh", "grid_mesh", "shard_rows", "gather_rows",
           "pad_problem", "RowShardedOperator", "shard_operator",
           "shard_hierarchy", "ProlongOperator", "RestrictOperator",
           "bootstrap", "hybrid_row_mesh", "check_host_major",
           "mv_from_host_blocks", "dia_from_host_blocks",
           "csr_from_host_blocks"]
