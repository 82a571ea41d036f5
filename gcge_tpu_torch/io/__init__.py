from gcge_tpu_torch.io.fem import cube_fem_laplacian
from gcge_tpu_torch.io.loaders import load_matrix_market, load_petsc_binary

__all__ = ["cube_fem_laplacian", "load_matrix_market", "load_petsc_binary"]
