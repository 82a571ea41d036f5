from gcge_tpu_torch.io.fem import cube_fem_laplacian
from gcge_tpu_torch.io.loaders import load_matrix_market, load_petsc_binary
from gcge_tpu_torch.io.stencil import build_3d27, smallest_eigs_3d27

__all__ = ["cube_fem_laplacian", "load_matrix_market", "load_petsc_binary",
           "build_3d27", "smallest_eigs_3d27"]
