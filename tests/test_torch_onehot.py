"""The port's irregular SpMM module (ops/onehot.py), its operators and the
operator conversion, held against gcge_tpu's one-hot kernels (run in
interpret mode, as tests/test_onehot.py runs them) and scipy on the same
numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from gcge_tpu.ops.onehot_pallas import OneHotOperator as JOneHot
from gcge_tpu.ops.onehot_pallas import _onehot_mask
from gcge_tpu.ops.operators import EllOneHotOperator as JEllOneHot
from gcge_tpu.ops.operators import HybridOperator as JHybrid
from gcge_tpu.ops.operators import make_operator as j_make_operator
from gcge_tpu_torch.ops import onehot
from gcge_tpu_torch.ops.onehot import (CsrOperator, bf16_mask_supported,
                                       csr_spmm, csr_spmm_reference,
                                       onehot_mask_probe,
                                       onehot_mask_reference, pack_csr)
from gcge_tpu_torch.ops.operators import (DiaOperator, HybridOperator,
                                          make_operator)
from gcge_tpu_torch.utils.convert import operator_from_numpy

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _random_banded(rng, n, k, band):
    """k entries a row within +-band of the diagonal (duplicates kept), as
    tests/test_onehot.py builds its patterns."""
    idx = np.clip(np.arange(n)[:, None] + rng.integers(-band, band + 1,
                                                       (n, k)), 0, n - 1)
    return (np.repeat(np.arange(n), k), idx.reshape(-1),
            rng.standard_normal(n * k))


HYB_N, HYB_DIAGS = 600, 24


def hybrid_pattern(seed=1):
    """n = 600: 20 full diagonals plus one outlier a row over 20 far
    diagonals.  With ``max_diags=24`` the top diagonals cover > 85 % and the
    remainder is one entry wide: the Hybrid layout (a small ``max_diags``
    keeps the unrolled JAX DIA product quick to compile)."""
    rng = np.random.default_rng(seed)
    n = HYB_N
    rows, cols = [], []
    for off in range(-10, 10):
        r = np.arange(max(0, -off), min(n, n - off))
        rows.append(r)
        cols.append(r + off)
    r = np.arange(n - 300)
    rows = np.concatenate(rows + [r])
    cols = np.concatenate(cols + [r + 200 + r % 20])
    return rows, cols, rng.standard_normal(len(rows))


def _csr_tensors(rows, cols, vals, n, dtype):
    rowptr, colidx, values = pack_csr(rows, cols, vals, (n, n))
    return _t(rowptr), _t(colidx), _t(values).to(dtype)


# ---- csr_spmm_reference ----------------------------------------------------


@pytest.mark.parametrize("n,k,band,cfg", [
    (1000, 7, 300, (256, 256, 128)),
    (513, 11, 80, (256, 512, 128)),      # n not a tile multiple
])
def test_csr_spmm_f32_matches_scipy_and_onehot_kernel(n, k, band, cfg):
    """f32, both layouts: within 1e-5 of max |A||x| of scipy's f64 product
    and of the JAX one-hot f32 kernel (sums of <= 11 f32 terms a row)."""
    rng = np.random.default_rng(n)
    rows, cols, vals = _random_banded(rng, n, k, band)
    a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    x = rng.standard_normal((n, 6)).astype(np.float32)
    scale = (abs(a) @ np.abs(x).astype(np.float64)).max()
    jop = JOneHot.from_coo(rows, cols, vals, (n, n), r_tile=cfg[0],
                           w_tile=cfg[1], j_max=cfg[2])
    y_j = np.asarray(jop.matvec_t(jnp.asarray(x.T)))
    rowptr, colidx, values = _csr_tensors(rows, cols, vals, n, torch.float32)
    y = csr_spmm(rowptr, colidx, values, _t(x)).numpy()
    yt = csr_spmm(rowptr, colidx, values, _t(x.T.copy()), True).numpy()
    assert y.dtype == np.float32 and yt.shape == (6, n)
    ref = a @ x.astype(np.float64)
    assert np.abs(y - ref).max() <= 1e-5 * scale
    assert np.abs(yt.T - ref).max() <= 1e-5 * scale
    assert np.abs(yt - y_j).max() <= 1e-5 * scale


@pytest.mark.parametrize("n,k,band,cfg", [
    (1000, 7, 300, (256, 256, 128)),
    (513, 11, 80, (256, 512, 128)),
])
def test_csr_spmm_f64_matches_scipy_and_onehot_df64_kernel(n, k, band, cfg):
    """f64, both layouts: within 1e-14 of max |A||x| of scipy, and within
    1e-11 of the scale of the JAX df64 one-hot kernel (that kernel's own
    limit in tests/test_onehot.py)."""
    rng = np.random.default_rng(n + 1)
    rows, cols, vals = _random_banded(rng, n, k, band)
    a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    x = rng.standard_normal((n, 6))
    ref = a @ x
    jop = JOneHot.from_coo(rows, cols, vals, (n, n), r_tile=cfg[0],
                           w_tile=cfg[1], j_max=cfg[2])
    y_j = np.asarray(jop.matvec_t_df64(jnp.asarray(x.T, jnp.float64)))
    rowptr, colidx, values = _csr_tensors(rows, cols, vals, n, torch.float64)
    y = csr_spmm_reference(rowptr, colidx, values, _t(x)).numpy()
    yt = csr_spmm_reference(rowptr, colidx, values, _t(x.T.copy()),
                            True).numpy()
    tight = 1e-14 * (abs(a) @ np.abs(x)).max()
    assert np.abs(y - ref).max() <= tight
    assert np.abs(yt.T - ref).max() <= tight
    assert np.abs(yt - y_j).max() <= 1e-11 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_csr_spmm_strided_views_and_edge_rows(dtype):
    """Non-contiguous x (a column slice of a wider basis and a transposed
    view), empty rows, a one-entry row and m = 1 give the product of the
    contiguous copy exactly."""
    rng = np.random.default_rng(3)
    n = 257
    rows, cols, vals = _random_banded(rng, n, 4, 40)
    drop = np.isin(rows, (0, 5, n - 1))              # three empty rows
    rows, cols, vals = rows[~drop], cols[~drop], vals[~drop]
    rows = np.concatenate([rows, [5]])               # row 5: one entry
    cols = np.concatenate([cols, [200]])
    vals = np.concatenate([vals, [2.5]])
    rowptr, colidx, values = _csr_tensors(rows, cols, vals, n, dtype)
    assert int(rowptr[1]) == 0 and int(rowptr[6] - rowptr[5]) == 1
    basis = _t(rng.standard_normal((n, 9))).to(dtype)
    x = basis[:, 2:7]
    assert not x.is_contiguous()
    ref = csr_spmm(rowptr, colidx, values, x.contiguous())
    assert torch.equal(csr_spmm(rowptr, colidx, values, x), ref)
    assert torch.equal(csr_spmm(rowptr, colidx, values, x.T, True), ref.T)
    assert torch.equal(ref[0], torch.zeros(5, dtype=dtype))
    assert torch.equal(ref[5], 2.5 * x[200])
    one = csr_spmm(rowptr, colidx, values, basis[:, 3:4])
    assert one.shape == (n, 1) and torch.equal(one[:, 0], ref[:, 1])


def test_csr_wrappers_raise_on_bad_input():
    rowptr, colidx, values = _csr_tensors([0, 1], [1, 0], [1.0, 2.0], 2,
                                          torch.float64)
    with pytest.raises(ValueError, match="2-D"):
        csr_spmm(rowptr, colidx, values, torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="expected"):
        csr_spmm(rowptr, colidx[:1], values, torch.zeros((2, 1)))
    with pytest.raises(ValueError, match="outside"):
        pack_csr([0, 2], [0, 0], [1.0, 1.0], (2, 2))
    with pytest.raises(ValueError, match="int32"):
        pack_csr([0], [0], [1.0], (2 ** 31, 2))
    op = CsrOperator(rowptr, colidx, values, 2)
    with pytest.raises(ValueError, match="does not match"):
        op.matvec(torch.zeros((3, 1), dtype=torch.float64))
    with pytest.raises(TypeError):
        op.matvec(torch.zeros((2, 1), dtype=torch.float16))


# ---- operators -------------------------------------------------------------


def test_csr_operator_matches_ellonehot_operator():
    """CsrOperator against the JAX EllOneHotOperator on f64 (1e-13 of the
    scale, both layouts) and against its f32 one-hot planes on f32 (1e-5)."""
    rng = np.random.default_rng(7)
    n = 600
    rows, cols, vals = _random_banded(rng, n, 5, 200)
    jop = JEllOneHot.from_coo(rows, cols, vals, (n, n))
    top = CsrOperator.from_coo(rows, cols, vals, (n, n), device="cpu")
    a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    assert top.shape == (n, n) and top.dtype == torch.float64
    assert top.device.type == "cpu" and top.nnz == len(vals)
    np.testing.assert_allclose(top.to_dense().numpy(), a.toarray(), rtol=0,
                               atol=1e-14)
    x = rng.standard_normal((n, 4))
    ref = np.asarray(jop.matvec(jnp.asarray(x)))
    ref_t = np.asarray(jop.matvec_t(jnp.asarray(x.T.copy())))
    tol = 1e-13 * np.abs(ref).max()
    assert np.abs(top.matvec(_t(x)).numpy() - ref).max() <= tol
    assert np.abs(top.matvec_t(_t(x.T.copy())).numpy() - ref_t).max() <= tol
    x32 = x.astype(np.float32)
    y32 = top.matvec_t(_t(x32.T.copy()))
    assert y32.dtype == torch.float32 and top._values32 is not None
    ref32 = np.asarray(jop.oh.matvec_t(jnp.asarray(x32.T)))
    assert np.abs(y32.numpy() - ref32).max() <= 1e-5 * np.abs(ref).max()
    top2 = CsrOperator.from_scipy(a, device="cpu")
    assert np.abs(top2.matvec(_t(x)).numpy() - ref).max() <= tol


def test_hybrid_operator_matches_jax():
    """HybridOperator against the JAX HybridOperator: the same split (DIA
    offsets and remainder size), to_dense exact, matvec to 1e-13."""
    rows, cols, vals = hybrid_pattern()
    n = HYB_N
    jop = JHybrid.from_coo(rows, cols, vals, (n, n), max_diags=HYB_DIAGS)
    top = HybridOperator.from_coo(rows, cols, vals, (n, n), device="cpu",
                                  max_diags=HYB_DIAGS)
    assert isinstance(top.dia, DiaOperator) and isinstance(top.rest,
                                                           CsrOperator)
    assert top.dia.offsets == tuple(jop.dia.offsets)
    assert top.rest.nnz == jop.ell.nnz and top.nnz == jop.nnz == len(vals)
    assert top.shape == (n, n) and top.dtype == torch.float64
    a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n))
    np.testing.assert_allclose(top.to_dense().numpy(), a.toarray(), rtol=0,
                               atol=1e-14)
    x = np.random.default_rng(2).standard_normal((n, 3))
    ref = np.asarray(jop.matvec(jnp.asarray(x)))
    assert np.abs(top.matvec(_t(x)).numpy() - ref).max() <= \
        1e-13 * np.abs(ref).max()
    banded = HybridOperator.from_coo(rows[:500], rows[:500], vals[:500],
                                     (n, n), device="cpu")
    assert banded.rest is None and banded.nnz == 500


def _patterns():
    rng = np.random.default_rng(4)
    n = 300
    r = np.arange(n)
    dia = (np.concatenate([r, r[:-2]]), np.concatenate([r, r[:-2] + 2]))
    m = sps.random(n, n, density=0.05, random_state=4)
    m = (m + m.T + sps.eye(n) * n).tocoo()
    hyb = hybrid_pattern()[:2]
    return {"dia": (dia[0], dia[1], n), "hybrid": (hyb[0], hyb[1], HYB_N),
            "irregular": (m.row, m.col, n), "rng": rng}


@pytest.mark.parametrize("kind,jname,tcls", [
    ("dia", "DiaOperator", DiaOperator),
    ("hybrid", "HybridOperator", HybridOperator),
    ("irregular", "SparseOperator", CsrOperator),
])
def test_make_operator_picks_the_layout_gcge_tpu_picks(kind, jname, tcls):
    """The three branches choose the same layout class as gcge_tpu on the
    same pattern; where gcge_tpu off the TPU gives plain ELL, the port gives
    CSR."""
    pats = _patterns()
    rows, cols, n = pats[kind]
    vals = pats["rng"].standard_normal(len(rows))
    jop = j_make_operator(rows, cols, vals, (n, n), max_diags=HYB_DIAGS)
    top = make_operator(rows, cols, vals, (n, n), device="cpu",
                        max_diags=HYB_DIAGS)
    assert type(jop).__name__ == jname and type(top) is tcls
    x = np.random.default_rng(5).standard_normal((n, 2))
    ref = np.asarray(jop.matvec(jnp.asarray(x)))
    assert np.abs(top.matvec(_t(x)).numpy() - ref).max() <= \
        1e-13 * np.abs(ref).max()


# ---- the mask probe ----------------------------------------------------------


def test_onehot_mask_reference_matches_jax_mask():
    """Bit for bit the JAX bf16 mask build, for ids inside and outside the
    iota range; the probe's answer on the CPU is True."""
    rng = np.random.default_rng(0)
    for ids0 in (np.arange(128) % 8, rng.integers(0, 300, 128)):
        ids = np.zeros((8, 128), np.int32)
        ids[0] = ids0
        ids[1:] = rng.integers(0, 8, (7, 128))       # other rows are ignored
        ref = np.asarray(_onehot_mask(jnp.asarray(ids[0]), (8, 128), 0,
                                      "bf16").astype(jnp.float32))
        got = onehot_mask_reference(_t(ids))
        assert got.dtype == torch.bfloat16 and got.shape == (8, 128)
        np.testing.assert_array_equal(got.float().numpy(), ref)
        assert torch.equal(onehot_mask_probe(_t(ids)), got)
    assert bf16_mask_supported("cpu") is True
    assert onehot.LAUNCHES["mask_probe"] == 0        # no launch on the CPU
    with pytest.raises(TypeError):
        onehot_mask_probe(torch.zeros((8, 128), dtype=torch.int64))


# ---- operator_from_numpy ---------------------------------------------------


def _onehot_state(oh):
    return {"kind": "onehot", "n": oh.n, "r_tile": oh.r_tile,
            "w_tile": oh.w_tile,
            **{k: np.asarray(getattr(oh, k)) for k in (
                "t_ids", "w_ids", "rloc", "cloc", "pvals", "pvals_lo")}}


@pytest.mark.parametrize("group", [1, 8])
def test_operator_from_numpy_roundtrips_onehot(group):
    """The pair arrays of a JAX OneHotOperator (plain and regrouped) give a
    CsrOperator with the same dense matrix: exact against the pairs' own
    hi + lo values, 1e-14 relative against the f64 input (the two f32 planes
    hold 48 bits)."""
    rng = np.random.default_rng(11)
    n = 700
    rows, cols, vals = _random_banded(rng, n, 5, 650)
    jop = JOneHot.from_coo(rows, cols, vals, (n, n), r_tile=128, w_tile=256,
                           group=group)
    top = operator_from_numpy(_onehot_state(jop), device="cpu")
    assert isinstance(top, CsrOperator) and top.dtype == torch.float64
    a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).toarray()
    dense = top.to_dense().numpy()
    assert np.abs(dense - a).max() <= 1e-14 * np.abs(a).max()
    eye = np.eye(n)
    ref = np.asarray(jop.matvec_reference(jnp.asarray(eye)))
    np.testing.assert_allclose(dense, ref, rtol=0, atol=1e-15)


def test_operator_from_numpy_hybrid():
    rows, cols, vals = hybrid_pattern()
    n = HYB_N
    jop = JHybrid.from_coo(rows, cols, vals, (n, n), max_diags=HYB_DIAGS)
    state = {"kind": "hybrid",
             "dia": {"kind": "dia", "values": np.asarray(jop.dia.values),
                     "offsets": np.asarray(jop.dia.offsets),
                     "n_cols": jop.dia.n_cols},
             "ell": {"kind": "ell", "values": np.asarray(jop.ell.values),
                     "indices": np.asarray(jop.ell.indices),
                     "n_cols": jop.ell.n_cols}}
    top = operator_from_numpy(state, device="cpu")
    assert isinstance(top, HybridOperator) and isinstance(top.rest,
                                                          CsrOperator)
    a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).toarray()
    np.testing.assert_array_equal(top.to_dense().numpy(), a)
    x = np.random.default_rng(3).standard_normal((n, 2))
    ref = np.asarray(jop.matvec(jnp.asarray(x)))
    assert np.abs(top.matvec(_t(x)).numpy() - ref).max() <= \
        1e-13 * np.abs(ref).max()
    state["ell"] = None
    assert operator_from_numpy(state, device="cpu").rest is None
