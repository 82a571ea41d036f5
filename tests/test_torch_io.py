"""The port's own copies of the host-side io modules (gcge_tpu_torch/io)
give outputs equal to gcge_tpu/io on the same inputs.  Both are pure
numpy/scipy/ctypes, so "equal" is exact equality."""

import numpy as np
import pytest
import scipy.sparse as sps

import gcge_tpu.io.fem as jfem
import gcge_tpu.io.loaders as jloaders
import gcge_tpu.io.native as jnative
import gcge_tpu_torch.io.fem as tfem
import gcge_tpu_torch.io.loaders as tloaders
import gcge_tpu_torch.io.native as tnative
from gcge_tpu_torch import io as tio


def _assert_same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def test_fem_structured_cube_equal():
    _assert_same(tfem.cube_mesh(3), jfem.cube_mesh(3))
    _assert_same(tfem.cube_fem_laplacian(5), jfem.cube_fem_laplacian(5))
    _assert_same(tio.cube_fem_laplacian(4, dtype=np.float32),
                 jfem.cube_fem_laplacian(4, dtype=np.float32))
    np.testing.assert_array_equal(tfem.cube_exact_eigenvalues(20),
                                  jfem.cube_exact_eigenvalues(20))


def test_fem_delaunay_mesh_and_assembly_equal():
    """The irregular slice's matrix generator at a 7^3 mesh: the same mesh
    and the same assembled pair, symmetric, with vertex degrees that vary
    (an unstructured pattern)."""
    mesh_t = tfem.random_delaunay_mesh(7 ** 3, seed=1)
    mesh_j = jfem.random_delaunay_mesh(7 ** 3, seed=1)
    _assert_same(mesh_t, mesh_j)
    got = tfem.assemble_p1(*mesh_t)
    _assert_same(got, jfem.assemble_p1(*mesh_j))
    rows, cols, av, bv, n = got
    a = sps.coo_matrix((av, (rows, cols)), shape=(n, n)).tocsr()
    assert abs(a - a.T).max() <= 1e-12 * abs(a).max()
    deg = np.bincount(rows, minlength=n)
    assert n == 6 ** 3 and deg.max() > deg.min() + 4


ALBERT = """DIM: 3
DIM_OF_WORLD: 3
number of vertices: 5
number of elements: 2

vertex coordinates:
0 0 0
1 0 0
0 1 0
0 0 1
1 1 1

element vertices:
0 1 2 3
1 2 3 4

element boundaries:
1 0 0 0
0 0 0 1
"""


def test_albert_mesh_loader_equal(tmp_path):
    path = tmp_path / "mesh.dat"
    path.write_text(ALBERT)
    got = tfem.load_albert_mesh(str(path))
    _assert_same(got, jfem.load_albert_mesh(str(path)))
    assert got[0].shape == (5, 3) and got[1].shape == (2, 4)
    assert got[2].tolist() == [False, True, True, True, False]


@pytest.fixture
def coo():
    rng = np.random.default_rng(0)
    m = sps.random(40, 40, density=0.1, random_state=1)
    m = sps.triu(m + sps.eye(40)).tocoo()
    return m.row.astype(np.int64), m.col.astype(np.int64), \
        rng.standard_normal(m.nnz), m.shape


def test_loaders_equal(tmp_path, coo):
    """PETSc binary and CCS binary written by either copy are the same
    bytes, and both loaders read them and a symmetric MatrixMarket file
    (plain and gzipped) to the same triplets."""
    import gzip

    rows, cols, vals, shape = coo
    pt, pj = tmp_path / "t.petsc", tmp_path / "j.petsc"
    tloaders.save_petsc_binary(str(pt), rows, cols, vals, shape)
    jloaders.save_petsc_binary(str(pj), rows, cols, vals, shape)
    assert pt.read_bytes() == pj.read_bytes()
    got = tloaders.load_petsc_binary(str(pt))
    ref = jloaders.load_petsc_binary(str(pj))
    _assert_same(got[:3], ref[:3])
    assert got[3] == ref[3] == shape
    ct, cj = tmp_path / "t.ccs", tmp_path / "j.ccs"
    tloaders.write_ccs_binary(str(ct), rows, cols, vals, shape[0])
    jloaders.write_ccs_binary(str(cj), rows, cols, vals, shape[0])
    assert ct.read_bytes() == cj.read_bytes()
    text = "%%MatrixMarket matrix coordinate real symmetric\n% comment\n" \
        f"{shape[0]} {shape[1]} {len(vals)}\n" + "".join(
            f"{c + 1} {r + 1} {float(v)!r}\n" for r, c, v in zip(rows, cols, vals))
    mm = tmp_path / "a.mtx"
    mm.write_text(text)
    gz = tmp_path / "a.mtx.gz"
    with gzip.open(gz, "wt") as f:
        f.write(text)
    for path in (mm, gz):
        got = tio.load_matrix_market(str(path))
        ref = jloaders.load_matrix_market(str(path))
        _assert_same(got[:3], ref[:3])
        assert got[3] == ref[3] == shape
    assert len(got[0]) == 2 * len(vals) - int((rows == cols).sum())


def test_native_toolkit_equal(tmp_path, coo):
    """RCM ordering, permutation, structure statistics and the native
    MatrixMarket reader: the same library (or the same scipy path) behind
    both copies."""
    rows, cols, vals, shape = coo
    n = shape[0]
    rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    vals = np.concatenate([vals, vals])
    assert tnative.available() == jnative.available()
    perm = tnative.rcm_permutation(rows, cols, n)
    np.testing.assert_array_equal(perm, jnative.rcm_permutation(rows, cols, n))
    assert sorted(perm.tolist()) == list(range(n))
    _assert_same(tnative.apply_permutation(rows, cols, vals, perm),
                 jnative.apply_permutation(rows, cols, vals, perm))
    r2, c2, _ = tnative.apply_permutation(rows, cols, vals, perm)
    stats = tnative.structure_stats(r2, c2, n)
    assert stats == jnative.structure_stats(r2, c2, n)
    assert stats["bandwidth"] <= tnative.structure_stats(rows, cols,
                                                         n)["bandwidth"]
    mm = tmp_path / "a.mtx"
    mm.write_text("%%MatrixMarket matrix coordinate real general\n"
                  f"{n} {n} {len(vals)}\n" + "".join(
                      f"{r + 1} {c + 1} {float(v)!r}\n"
                      for r, c, v in zip(rows, cols, vals)))
    got = tnative.load_matrix_market_native(str(mm))
    ref = jnative.load_matrix_market_native(str(mm))
    _assert_same(got[:3], ref[:3])
    assert got[3] == ref[3] == shape
