"""The port's operators, multivector ops, eigensolver and operator
conversion, held against gcge_tpu and scipy on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import gcge_tpu.ops.multivec as jmv
from gcge_tpu.ops.eighs import safe_eigh as j_safe_eigh
from gcge_tpu.ops.operators import DiaDF64Operator as JDiaDF64
from gcge_tpu.ops.operators import DiagOperator as JDiag
from gcge_tpu.ops.operators import DiaOperator as JDia
from gcge_tpu.ops.operators import SparseOperator as JSparse
import gcge_tpu_torch.ops.multivec as tmv
from gcge_tpu_torch.ops.eighs import eigh, safe_eigh
from gcge_tpu_torch.ops.onehot import CsrOperator
from gcge_tpu_torch.ops.operators import (DenseOperator, DiagOperator,
                                          DiaOperator, FunctionOperator,
                                          HybridOperator, IdentityOperator,
                                          ShiftedOperator, SparseOperator,
                                          make_operator)
from gcge_tpu_torch.utils.convert import operator_from_numpy

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _random_sym_coo(n, density, seed):
    m = sps.random(n, n, density=density, random_state=seed)
    m = (m + m.T + sps.eye(n) * n).tocoo()
    return m.row, m.col, m.data, m


def _banded_coo(n, offsets, seed):
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in offsets:
        r = np.arange(max(0, -off), min(n, n - off))
        rows.append(r)
        cols.append(r + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return rows, cols, rng.standard_normal(len(rows))


# ---- operators ---------------------------------------------------------


def test_ops_export_eigh_and_safe_eigh_as_jax_does():
    """``gcge_tpu_torch.ops`` exports ``eigh`` and ``safe_eigh``, as
    ``gcge_tpu.ops`` does, and gcge_tpu's other eighs (``eigh_jacobi``,
    ``eigh_newton``, ``jacobi_polish``, ported since); the rest of
    gcge_tpu's list is the port's but for ``DiaDF64Operator``, a TPU
    workaround that is not ported."""
    import gcge_tpu.ops as j_ops
    import gcge_tpu_torch.ops as t_ops
    from gcge_tpu_torch.ops import eighs as t_eighs

    tpu_only = {"DiaDF64Operator"}
    assert set(j_ops.__all__) - tpu_only <= set(t_ops.__all__)
    assert {"eigh", "safe_eigh"} <= set(t_ops.__all__) & set(j_ops.__all__)
    assert t_ops.eigh is eigh and t_ops.safe_eigh is safe_eigh
    for name in ("eigh_jacobi", "eigh_newton", "jacobi_polish"):
        assert getattr(t_ops, name) is getattr(t_eighs, name)


def test_dia_operator_matches_scipy_both_layouts():
    """DIA from COO: to_dense equals the scipy matrix; matvec and matvec_t
    equal scipy's product to 1e-13 relative."""
    n = 200
    rows, cols, vals = _banded_coo(n, (-37, -3, 0, 1, 5, 60), 0)
    a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n))
    op = DiaOperator.from_coo(rows, cols, vals, (n, n), device="cpu")
    assert op.offsets == (-37, -3, 0, 1, 5, 60)
    assert DiaOperator.n_diagonals(rows, cols) == 6
    assert op.nnz == len(vals)
    np.testing.assert_array_equal(op.to_dense().numpy(), a.toarray())
    x = np.random.default_rng(1).standard_normal((n, 4))
    ref = a @ x
    tol = 1e-13 * np.abs(ref).max()
    assert np.abs(op.matvec(_t(x)).numpy() - ref).max() <= tol
    assert np.abs(op.matvec_t(_t(x.T.copy())).numpy() - ref.T).max() <= tol


@pytest.mark.parametrize("m", [1, 10])
def test_dia_spmm_returns_the_memory_order_of_x(m):
    """The plain DIA version returns ``y`` in the memory order of a dense
    ``x`` (like ``torch.empty_like(x)``) and contiguous for any other ``x``,
    in both layouts, as the kernels do; the values do not depend on it."""
    n = 211
    rows, cols, vals = _banded_coo(n, (-7, -1, 0, 1, 2, 30), 5)
    op = DiaOperator.from_coo(rows, cols, vals, (n, n), device="cpu")
    base = _t(np.random.default_rng(m).standard_normal((n, m + 3)))
    dense = base[:, 1:1 + m].contiguous()
    want = None
    for name, x, transposed, col_major in [
            ("(n, m)", dense, False, False),
            ("(n, m) column-major", dense.T.contiguous().T, False, m > 1),
            ("(m, n) contiguous", dense.T.contiguous(), True, False),
            ("(m, n), (n, m) memory", dense.T, True, m > 1),
            ("column slice", base[:, 1:1 + m], False, False),
            ("view of a column slice", base[:, 1:1 + m].T, True, False)]:
        y = op.matvec_t(x) if transposed else op.matvec(x)
        assert y.shape == x.shape, name
        if col_major:
            assert y.stride() == x.stride() == (1, y.shape[0]), name
        else:
            assert y.is_contiguous(), name
        yn = y.T if transposed else y
        want = yn if want is None else want
        assert torch.equal(yn, want), name


def test_sparse_operator_matches_scipy():
    """ELL from COO and from scipy: to_dense exact, matvec to 1e-13."""
    rows, cols, vals, m = _random_sym_coo(150, 0.05, 2)
    op = SparseOperator.from_coo(rows, cols, vals, m.shape, device="cpu")
    op2 = SparseOperator.from_scipy(m, device="cpu")
    np.testing.assert_allclose(op.to_dense().numpy(), m.toarray(),
                               rtol=0, atol=1e-14)
    x = np.random.default_rng(3).standard_normal((150, 3))
    ref = m @ x
    for o in (op, op2):
        assert np.abs(o.matvec(_t(x)).numpy() - ref).max() <= \
            1e-13 * np.abs(ref).max()


def test_make_operator_branches():
    """DIA for few diagonals, CSR for scattered square patterns, ELL for
    rectangular matrices, Hybrid where gcge_tpu builds a Hybrid."""
    n = 300
    rows, cols, vals = _banded_coo(n, (-2, 0, 2), 0)
    assert isinstance(make_operator(rows, cols, vals, (n, n), device="cpu"),
                      DiaOperator)
    r, c, v, _ = _random_sym_coo(n, 0.05, 4)
    assert isinstance(make_operator(r, c, v, (n, n), device="cpu"),
                      CsrOperator)
    rect = make_operator(np.array([0, 1]), np.array([0, 5]),
                         np.array([1.0, 2.0]), (2, 6), device="cpu")
    assert isinstance(rect, SparseOperator) and rect.shape == (2, 6)
    # 120 full diagonals plus one outlier per row spread over 20 far
    # diagonals: the top 128 cover >85% and the remainder is one entry wide
    # -> the Hybrid layout in gcge_tpu
    n = 1000
    rows, cols, vals = _banded_coo(n, tuple(range(-60, 60)), 1)
    r = np.arange(n - 400)
    rows = np.concatenate([rows, r])
    cols = np.concatenate([cols, r + 300 + r % 20])
    vals = np.concatenate([vals, np.ones(len(r))])
    hyb = make_operator(rows, cols, vals, (n, n), device="cpu")
    assert isinstance(hyb, HybridOperator)
    assert len(hyb.dia.offsets) == 128 and isinstance(hyb.rest, CsrOperator)
    assert hyb.nnz == len(vals)


def test_small_operators():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((6, 6))
    a = a + a.T
    d = rng.uniform(1, 2, 6)
    x = rng.standard_normal((6, 2))
    dense, diag = DenseOperator(_t(a)), DiagOperator(_t(d))
    np.testing.assert_allclose(dense(_t(x)).numpy(), a @ x, rtol=1e-14)
    np.testing.assert_allclose(diag.matvec(_t(x)).numpy(), d[:, None] * x,
                               rtol=1e-15)
    ident = IdentityOperator(6, device="cpu")
    assert ident.shape == (6, 6) and ident.matvec(_t(x)) is not None
    np.testing.assert_array_equal(ident.matvec(_t(x)).numpy(), x)
    sh = ShiftedOperator(dense, diag, 0.5)
    np.testing.assert_allclose(sh.matvec(_t(x)).numpy(),
                               a @ x + 0.5 * d[:, None] * x, rtol=1e-14)
    assert ShiftedOperator(dense, None, 2.0).matvec(_t(x)).shape == (6, 2)
    fop = FunctionOperator(lambda y: 3.0 * y, 6, device="cpu")
    np.testing.assert_array_equal(fop.matvec(_t(x)).numpy(), 3.0 * x)


# ---- multivector ops ------------------------------------------------------


@pytest.mark.parametrize("n", [100, 256, 1000])
def test_gram_and_col_dots_match_jax(n):
    """Chunked Gram (one chunk, exact chunks, padded chunks) and column dots
    against gcge_tpu: within 1e-14 of ||x_i|| ||y_j||."""
    rng = np.random.default_rng(n)
    x, y = rng.standard_normal((n, 7)), rng.standard_normal((n, 5))
    scale = np.linalg.norm(x, axis=0)[:, None] * np.linalg.norm(y, axis=0)
    got = tmv.gram(_t(x), _t(y)).numpy()
    ref = np.asarray(jmv.gram(jnp.asarray(x), jnp.asarray(y)))
    assert np.max(np.abs(got - ref) / scale) < 1e-14
    dots = tmv.col_dots(_t(x[:, :5]), _t(y)).numpy()
    ref_d = np.asarray(jmv.col_dots(jnp.asarray(x[:, :5]), jnp.asarray(y)))
    assert np.max(np.abs(dots - ref_d) / np.diag(scale[:5])) < 1e-14


def test_gram_grouped_path_matches_one_shot(monkeypatch):
    """Past the partial-product budget the chunks are summed in groups; the
    result equals the one-shot sum to 1e-14 relative."""
    rng = np.random.default_rng(9)
    x = _t(rng.standard_normal((3000, 6)))
    one_shot = tmv.gram(x, x)
    monkeypatch.setattr(tmv, "GRAM_PART_BYTES", 6 * 6 * 8 * 3)
    grouped = tmv.gram(x, x)
    assert float((grouped - one_shot).abs().max()) <= \
        1e-14 * float(one_shot.abs().max())


def test_block_ops_match_jax():
    rng = np.random.default_rng(11)
    x, y = rng.standard_normal((300, 4)), rng.standard_normal((300, 4))
    coef, beta = rng.standard_normal((4, 4)), rng.standard_normal(4)
    a = np.diag(rng.uniform(1, 2, 300))
    pairs = [
        (tmv.block_inner(_t(x), _t(y), "S"),
         jmv.block_inner(jnp.asarray(x), jnp.asarray(y), "S")),
        (tmv.block_inner(_t(x), _t(y), "D"),
         jmv.block_inner(jnp.asarray(x), jnp.asarray(y), "D")),
        (tmv.axpby(2.0, _t(x), _t(beta), _t(y)),
         jmv.axpby(2.0, jnp.asarray(x), jnp.asarray(beta), jnp.asarray(y))),
        (tmv.axpby(None, None, 3.0, _t(y)),
         jmv.axpby(None, None, 3.0, jnp.asarray(y))),
        (tmv.linear_comb(_t(x), _t(coef), _t(y), _t(beta)),
         jmv.linear_comb(jnp.asarray(x), jnp.asarray(coef), jnp.asarray(y),
                         jnp.asarray(beta))),
        (tmv.qtap(_t(x), lambda v: _t(a) @ v, _t(y)),
         jmv.qtap(jnp.asarray(x), lambda v: jnp.asarray(a) @ v,
                  jnp.asarray(y))),
        (tmv.column_mask(6, 4), jmv.column_mask(6, 4)),
        (tmv.range_mask(6, 1, 4), jmv.range_mask(6, 1, 4)),
    ]
    for got, ref in pairs:
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-13 * max(
            np.abs(ref).max(), 1.0)
    with pytest.raises(ValueError, match="nothing to compute"):
        tmv.linear_comb(None, None, _t(y))


def test_set_random_is_seeded_and_in_range():
    g1 = torch.Generator().manual_seed(4)
    g2 = torch.Generator().manual_seed(4)
    a = tmv.set_random(g1, (500, 3))
    b = tmv.set_random(g2, (500, 3))
    assert torch.equal(a, b) and a.dtype == torch.float64
    assert float(a.min()) >= -1.0 and float(a.max()) < 1.0
    assert float(a.min()) < -0.9 and float(a.max()) > 0.9


# ---- projected eigensolver ------------------------------------------------


@pytest.mark.parametrize("kind", ["spd", "rank_deficient", "clustered"])
def test_safe_eigh_matches_jax(kind):
    """Eigenvalues equal gcge_tpu's safe_eigh to 1e-13 of the spectral
    scale; eigenvectors orthonormal and eigen-residuals small (1e-13)."""
    rng = np.random.default_rng(len(kind))
    m = 30
    q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    if kind == "spd":
        w = rng.uniform(0.1, 5.0, m)
    elif kind == "rank_deficient":
        w = np.concatenate([rng.uniform(1, 2, 20), np.zeros(10)])
    else:
        w = np.repeat([1.0, 1.0 + 1e-12, 3.0], 10)
    h = (q * w) @ q.T
    h = 0.5 * (h + h.T)
    wt, ut = safe_eigh(_t(h))
    wj, _ = j_safe_eigh(jnp.asarray(h))
    scale = np.abs(w).max()
    assert np.abs(wt.numpy() - np.asarray(wj)).max() <= 1e-13 * scale
    u = ut.numpy()
    assert np.abs(u.T @ u - np.eye(m)).max() <= 1e-13
    assert np.abs(h @ u - u * wt.numpy()).max() <= 1e-13 * scale


def test_eigh_backends():
    h = _t(np.diag([3.0, 1.0, 2.0]))
    w, _ = eigh(h, "device")
    np.testing.assert_allclose(w.numpy(), [1.0, 2.0, 3.0], rtol=1e-12)
    # gcge_tpu's other backends run since they were ported
    # (tests/test_torch_eighs.py holds them to gcge_tpu's)
    for backend in ("jacobi", "newton", "host"):
        w, _ = eigh(h, backend)
        np.testing.assert_allclose(w.numpy(), [1.0, 2.0, 3.0], rtol=1e-12)
    with pytest.raises(ValueError):
        eigh(h, "nope")


# ---- operator_from_numpy --------------------------------------------------


def _state_of(jop):
    """Read a gcge_tpu operator into the dict operator_from_numpy takes."""
    if isinstance(jop, JDia):            # DiaDF64Operator.values is f64
        return {"kind": "dia", "values": np.asarray(jop.values),
                "offsets": np.asarray(jop.offsets), "n_cols": jop.n_cols}
    if isinstance(jop, JSparse):
        return {"kind": "ell", "values": np.asarray(jop.values),
                "indices": np.asarray(jop.indices), "n_cols": jop.n_cols}
    if isinstance(jop, JDiag):
        return {"kind": "diag", "d": np.asarray(jop.d)}
    raise TypeError(type(jop))


@pytest.mark.parametrize("kind", ["dia", "df64", "ell", "diag"])
def test_operator_from_numpy_matches_jax_matvec(kind):
    """An operator read out of gcge_tpu gives the port's operator of the
    same kind, with the same matvec to 1e-14 relative (df64: 1e-13, the
    hi/lo planes' representation error)."""
    n = 240
    rows, cols, vals = _banded_coo(n, (-20, -1, 0, 1, 20), 6)
    if kind == "dia":
        jop = JDia.from_coo(rows, cols, vals, (n, n))
    elif kind == "df64":
        jop = JDiaDF64.from_coo(rows, cols, vals, (n, n))
    elif kind == "ell":
        jop = JSparse.from_coo(rows, cols, vals, (n, n))
    else:
        jop = JDiag(jnp.asarray(np.random.default_rng(2).uniform(1, 2, n)))
    top = operator_from_numpy(_state_of(jop), device="cpu")
    expected = {"dia": DiaOperator, "df64": DiaOperator,
                "ell": SparseOperator, "diag": DiagOperator}[kind]
    assert isinstance(top, expected)
    x = np.random.default_rng(8).standard_normal((n, 3))
    ref = np.asarray(jop.matvec(jnp.asarray(x)))
    got = top.matvec(_t(x)).numpy()
    tol = (1e-13 if kind == "df64" else 1e-14) * np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol


def test_operator_from_numpy_dense_and_unknown():
    a = np.arange(9.0).reshape(3, 3)
    op = operator_from_numpy({"kind": "dense", "a": a}, device="cpu")
    assert isinstance(op, DenseOperator)
    np.testing.assert_array_equal(op.a.numpy(), a)
    with pytest.raises(ValueError):
        operator_from_numpy({"kind": "nope"}, device="cpu")
