"""The 3-D 27-point Laplacian stencil: the banded test and benchmark matrix
of the package, with its spectrum in closed form."""

from __future__ import annotations

import numpy as np


def build_3d27(nx: int):
    """3-D 27-point Laplacian stencil on an nx^3 grid (COO, symmetric):
    ``(rows, cols, vals, n)``."""
    n = nx ** 3
    idx = np.arange(n)
    i, j, k = idx // (nx * nx), (idx // nx) % nx, idx % nx
    rows, cols, vals = [], [], []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                ii, jj, kk = i + di, j + dj, k + dk
                ok = (ii >= 0) & (ii < nx) & (jj >= 0) & (jj < nx) & \
                    (kk >= 0) & (kk < nx)
                w = 26.0 if (di == 0 and dj == 0 and dk == 0) else -1.0
                rows.append(idx[ok])
                cols.append((ii * nx * nx + jj * nx + kk)[ok])
                vals.append(np.full(ok.sum(), w))
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n


def smallest_eigs_3d27(nx: int, k: int) -> np.ndarray:
    """The k smallest eigenvalues of the stencil in closed form:
    A = 27 I - J(x)J(x)J with J = tridiag(1, 1, 1), eig(J) = 1 + 2 cos(t pi/(nx+1))."""
    mu = 1.0 + 2.0 * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
    lam = 27.0 - np.einsum("i,j,k->ijk", mu, mu, mu).ravel()
    return np.sort(lam)[:k]
