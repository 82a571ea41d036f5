"""P1 tetrahedral FEM assembly of the 3D Laplacian + mass pair on the cube —
the port's own copy of ``gcge_tpu/io/fem.py`` (pure numpy/scipy).

The reference builds its FEM test pair with the external PHG library from the
ALBERT mesh ``data/cube4.dat`` (125 vertices, 384 tets of the unit cube) —
the reference's ``test/get_mat_phg.c:29-73``: stiffness A = ∫ grad(phi_i)·
grad(phi_j), mass B = ∫ phi_i phi_j, homogeneous Dirichlet BC, with
``pre_refines`` controlling size.

Here the same problem family is assembled self-contained in vectorized numpy:
a structured (nx+1)^3 vertex grid with each cube cell split into 6 tets (Kuhn
triangulation) — ``nx=4`` reproduces cube4.dat's 125/384 mesh sizes; larger
``nx`` plays the role of ``pre_refines``.  The analytic Dirichlet spectrum of
the continuous problem, ``pi^2 (i^2+j^2+k^2)``, provides the oracle the
reference gets from known model problems (SURVEY.md §4).
"""

from __future__ import annotations

import numpy as np

# the 6 tets of the Kuhn split of the unit cube, as vertex-offset indices
# into the (dx, dy, dz) corner numbering c = dx + 2*dy + 4*dz
_KUHN_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 1, 5, 7],
        [0, 2, 3, 7],
        [0, 2, 6, 7],
        [0, 4, 5, 7],
        [0, 4, 6, 7],
    ],
    dtype=np.int64,
)

_CORNER_OFFSETS = np.array(
    [[dx, dy, dz] for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
)[np.argsort([dx + 2 * dy + 4 * dz for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)])]


def cube_mesh(nx: int):
    """Structured tet mesh of the unit cube: vertices ((nx+1)^3, 3) and
    tets (6*nx^3, 4)."""
    nv1 = nx + 1
    g = np.arange(nv1)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    verts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1) / nx

    def vid(ix, iy, iz):
        return (iz * nv1 + iy) * nv1 + ix

    cz, cy, cx = np.meshgrid(np.arange(nx), np.arange(nx), np.arange(nx), indexing="ij")
    cx, cy, cz = cx.ravel(), cy.ravel(), cz.ravel()
    corners = np.stack(
        [vid(cx + dx, cy + dy, cz + dz) for dx, dy, dz in _CORNER_OFFSETS], axis=1
    )  # (ncells, 8) in c = dx+2dy+4dz order
    tets = corners[:, _KUHN_TETS].reshape(-1, 4)
    return verts, tets


def _element_matrices(verts, tets):
    """Vectorized P1 element stiffness and mass matrices."""
    p = verts[tets]                      # (ne, 4, 3)
    e = p[:, 1:] - p[:, :1]              # (ne, 3, 3) edge matrix rows p_i - p_0
    det = np.linalg.det(e)
    vol = np.abs(det) / 6.0
    einv = np.linalg.inv(e)              # (ne, 3, 3)
    # gradients: lambda_i (i=1..3) has ref-gradient e_i, lambda_0 = -(sum)
    g123 = np.transpose(einv, (0, 2, 1))             # (ne, 3, 3): rows grad_i
    g0 = -g123.sum(axis=1, keepdims=True)            # (ne, 1, 3)
    grads = np.concatenate([g0, g123], axis=1)       # (ne, 4, 3)
    ke = np.einsum("eid,ejd->eij", grads, grads) * vol[:, None, None]
    me = (np.ones((4, 4)) + np.eye(4))[None] / 20.0 * vol[:, None, None]
    return ke, me


def assemble_p1(verts, tets, dirichlet_mask, dtype=np.float64):
    """P1 FEM assembly of (stiffness A, mass B) on an arbitrary tet mesh,
    eliminating Dirichlet vertices — the general form of the reference's PHG
    assembly (the reference's ``test/get_mat_phg.c:29-73``).

    Returns ``(rows, cols, a_vals, b_vals, n)`` with both matrices sharing
    one sparsity pattern over the ``n`` interior (non-Dirichlet) vertices.
    """
    ke, me = _element_matrices(verts, tets)
    interior = ~np.asarray(dirichlet_mask, bool)
    new_id = -np.ones(len(verts), dtype=np.int64)
    new_id[interior] = np.arange(interior.sum())
    n = int(interior.sum())

    t_new = new_id[tets]                              # (ne, 4), -1 on boundary
    ii = np.repeat(t_new[:, :, None], 4, axis=2).ravel()
    jj = np.repeat(t_new[:, None, :], 4, axis=1).ravel()
    keep = (ii >= 0) & (jj >= 0)
    rows, cols = ii[keep], jj[keep]
    a_vals = ke.ravel()[keep].astype(dtype)
    b_vals = me.ravel()[keep].astype(dtype)

    # coalesce duplicates
    lin = rows * n + cols
    order = np.argsort(lin, kind="stable")
    lin, a_vals, b_vals = lin[order], a_vals[order], b_vals[order]
    uniq, start = np.unique(lin, return_index=True)
    a_out = np.add.reduceat(a_vals, start)
    b_out = np.add.reduceat(b_vals, start)
    return uniq // n, uniq % n, a_out, b_out, n


def cube_fem_laplacian(nx: int, dtype=np.float64):
    """Assemble (A, B) in COO over *interior* vertices (Dirichlet BC).

    Returns ``(rows, cols, a_vals, b_vals, n)`` with both matrices sharing one
    sparsity pattern.  The smallest exact eigenvalues of the discrete pencil
    converge to ``pi^2 (i^2 + j^2 + k^2)``, i,j,k >= 1.
    """
    verts, tets = cube_mesh(nx)
    on_bnd = np.any((verts <= 0.0) | (verts >= 1.0 - 1e-12), axis=1)
    return assemble_p1(verts, tets, on_bnd, dtype=dtype)


def random_delaunay_mesh(n_points: int, seed: int = 0):
    """Unstructured tet mesh: Delaunay triangulation of quasi-random points
    in the unit cube (plus the 8 corners so the hull is the cube).

    This produces a GENUINELY irregular sparsity pattern — vertex degrees
    vary, neighbors land on no lattice — standing in for the SuiteSparse
    production matrices of the reference's benchmark rig
    (the reference's ``test/submit.sh:9-15``: SiO2 etc., which need a
    download).  Points are jittered-grid (not iid uniform) so tet
    quality stays bounded and the assembled stiffness matrix is not
    dominated by sliver elements.

    Returns ``(verts, tets, dirichlet_mask)`` ready for
    :func:`assemble_p1`."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    g = int(round(n_points ** (1 / 3)))
    side = np.linspace(0.0, 1.0, g + 1)
    zz, yy, xx = np.meshgrid(side, side, side, indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1)
    h = 1.0 / g
    jitter = rng.uniform(-0.45 * h, 0.45 * h, pts.shape)
    interior = np.all((pts > 1e-12) & (pts < 1 - 1e-12), axis=1)
    pts = pts + jitter * interior[:, None]     # boundary vertices stay put
    tri = Delaunay(pts)
    tets = tri.simplices.astype(np.int64)
    # drop degenerate tets (qhull can emit near-flat boundary slivers)
    p = pts[tets]
    vol6 = np.abs(np.linalg.det(p[:, 1:] - p[:, :1]))
    tets = tets[vol6 > 1e-12 * h ** 3]
    on_bnd = np.any((pts <= 1e-12) | (pts >= 1 - 1e-12), axis=1)
    return pts, tets, on_bnd


def load_albert_mesh(path: str):
    """Read an ALBERT/ALBERTA macro-triangulation file (the format of the
    reference's ``data/cube4.dat``: 125 vertices / 384 tets of the unit
    cube consumed by PHG, the reference's ``test/get_mat_phg.c:135``).

    Returns ``(verts (nv,3), tets (ne,4), dirichlet_mask (nv,))`` where the
    mask marks vertices on faces with a nonzero boundary code (face i of an
    element is opposite its vertex i).
    """
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    nv = ne = None
    sections = {}
    i = 0
    while i < len(lines):
        ln = lines[i]
        if ln.startswith("number of vertices:"):
            nv = int(ln.split(":")[1])
        elif ln.startswith("number of elements:"):
            ne = int(ln.split(":")[1])
        elif ln.endswith(":"):
            sections[ln[:-1]] = i + 1
        i += 1
    assert nv and ne, "missing ALBERT header counts"

    def block(name, count, dtype, ncol):
        start = sections[name]
        rows = [lines[start + k].split() for k in range(count)]
        return np.asarray(rows, dtype=dtype).reshape(count, ncol)

    verts = block("vertex coordinates", nv, np.float64, 3)
    tets = block("element vertices", ne, np.int64, 4)
    dirichlet = np.zeros(nv, bool)
    if "element boundaries" in sections:
        bnd = block("element boundaries", ne, np.int64, 4)
        for face in range(4):
            marked = tets[bnd[:, face] != 0]
            others = [v for v in range(4) if v != face]
            dirichlet[marked[:, others].ravel()] = True
    return verts, tets, dirichlet


def cube_exact_eigenvalues(count: int) -> np.ndarray:
    """Smallest Dirichlet-Laplacian eigenvalues of the unit cube:
    pi^2 (i^2+j^2+k^2)."""
    r = int(np.ceil(count ** (1 / 3))) + 3
    ijk = np.arange(1, r + 1)
    vals = (
        np.add.outer(np.add.outer(ijk ** 2, ijk ** 2), ijk ** 2).ravel()
        * np.pi ** 2
    )
    return np.sort(vals)[:count]
