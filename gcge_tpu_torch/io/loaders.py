"""Matrix loaders: MatrixMarket and PETSc binary — the port's own copy of
``gcge_tpu/io/loaders.py`` (pure numpy).

The reference's benchmark rig consumes SuiteSparse matrices stored as PETSc
binary files (``-filename_matA``, the reference's
``test/test_app_slepc.c:416-440``; conversion utilities in
``test/mat_convert.c``).  This module reads both that format and the
upstream MatrixMarket ``.mtx`` files directly, so the
same experiments run without PETSc.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

PETSC_MAT_CLASSID = 1211216


def load_matrix_market(path: str):
    """Read a (possibly gzipped) MatrixMarket coordinate file.

    Returns ``(rows, cols, vals, shape)`` with symmetric/skew/hermitian
    storage expanded to the full pattern.
    """
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        header = f.readline().strip().split()
        assert header[0] == "%%MatrixMarket" and header[1] == "matrix"
        fmt, field, symmetry = header[2], header[3], header[4]
        assert fmt == "coordinate", "dense MatrixMarket not supported"
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nr, nc, nnz = map(int, line.split())
        data = np.loadtxt(f, max_rows=nnz)
    if data.ndim == 1:
        data = data[None, :]
    rows = data[:, 0].astype(np.int64) - 1
    cols = data[:, 1].astype(np.int64) - 1
    if field == "pattern":
        vals = np.ones(len(rows))
    else:
        vals = data[:, 2].astype(np.float64)
    if symmetry in ("symmetric", "hermitian", "skew-symmetric"):
        off = rows != cols
        sgn = -1.0 if symmetry == "skew-symmetric" else 1.0
        rows = np.concatenate([rows, cols[off]])
        cols = np.concatenate([cols, data[:, 0].astype(np.int64)[off] - 1])
        vals = np.concatenate([vals, sgn * vals[off]])
    return rows, cols, vals, (nr, nc)


def load_petsc_binary(path: str):
    """Read a PETSc binary Mat (big-endian AIJ format).

    Layout: int32 MAT_FILE_CLASSID, nrows, ncols, nnz; int32 row nnz counts;
    int32 column indices; float64 values.
    Returns ``(rows, cols, vals, shape)``.
    """
    with open(path, "rb") as f:
        classid, nr, nc, nnz = struct.unpack(">4i", f.read(16))
        assert classid == PETSC_MAT_CLASSID, f"not a PETSc Mat file: {classid}"
        row_nnz = np.fromfile(f, dtype=">i4", count=nr).astype(np.int64)
        cols = np.fromfile(f, dtype=">i4", count=nnz).astype(np.int64)
        vals = np.fromfile(f, dtype=">f8", count=nnz).astype(np.float64)
    rows = np.repeat(np.arange(nr, dtype=np.int64), row_nnz)
    return rows, cols, vals, (nr, nc)


def save_petsc_binary(path: str, rows, cols, vals, shape):
    """Write a PETSc binary Mat (row-sorted AIJ), for interop tests."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    nr, nc = shape
    row_nnz = np.bincount(rows, minlength=nr)
    with open(path, "wb") as f:
        f.write(struct.pack(">4i", PETSC_MAT_CLASSID, nr, nc, len(vals)))
        row_nnz.astype(">i4").tofile(f)
        cols.astype(">i4").tofile(f)
        vals.astype(">f8").tofile(f)


def write_ccs_binary(path: str, rows, cols, vals, n: int):
    """Write a CSC matrix in the plain binary format ``native/ref_bench.c``
    reads (``-matA``/``-matB``): int64 n, int64 nnz, int64 j_col[n+1],
    int32 i_row[nnz], f64 data[nnz].  Used to hand the reference library the
    SAME matrices the port solves (BASELINE.md: reference numbers must be
    measured, not cited)."""
    import numpy as np

    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals, np.float64)
    order = np.lexsort((rows, cols))        # CSC: sort by column, then row
    rows, cols, vals = rows[order], cols[order], vals[order]
    j_col = np.zeros(n + 1, np.int64)
    np.add.at(j_col, cols + 1, 1)
    j_col = np.cumsum(j_col)
    with open(path, "wb") as f:
        np.asarray([n, len(vals)], np.int64).tofile(f)
        j_col.astype(np.int64).tofile(f)
        rows.astype(np.int32).tofile(f)
        vals.tofile(f)
