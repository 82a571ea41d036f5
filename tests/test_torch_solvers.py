"""The port's orthonormalization and block CG against gcge_tpu on the same
numpy inputs (f64 on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcge_tpu.solvers.bpcg import BlockPCGParams as JParams
from gcge_tpu.solvers.bpcg import block_pcg as j_block_pcg
from gcge_tpu.solvers.bpcg import block_pcg_t as j_block_pcg_t
from gcge_tpu.solvers.bpcg import pcg as j_pcg
from gcge_tpu.solvers.orth import bgs_orth as j_bgs_orth
from gcge_tpu.solvers.orth import mgs_orth as j_mgs_orth
from gcge_tpu.solvers.orth import orth_block_against as j_orth_against
from gcge_tpu.solvers.orth import orth_within as j_orth_within
from gcge_tpu_torch.solvers.bpcg import (BlockPCGParams, block_pcg,
                                         block_pcg_t, pcg)
from gcge_tpu_torch.solvers.orth import (bgs_orth, mgs_orth, orth_against,
                                         orth_block_against, orth_within)

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _projector(x, rank):
    x = np.asarray(x)[:, :rank]
    return x @ x.T


def _b_orth_err(x, rank, d=None):
    x = np.asarray(x)[:, :rank]
    bx = x if d is None else d[:, None] * x
    return np.abs(x.T @ bx - np.eye(rank)).max()


def _basis_with_rank_drop(n, k, seed, d=None):
    """q: k B-orthonormal columns (B = diag(d), or I); x: 6 columns of which
    the last two are combinations of the others and of q (rank 4 after
    projection)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, k)))
    if d is not None:
        q = q / np.sqrt(d)[:, None]
    x = rng.standard_normal((n, 6))
    x[:, 4] = x[:, 0] - 2.0 * x[:, 1] + 3.0 * q[:, 0]
    x[:, 5] = q @ rng.standard_normal(k)
    return q, x


@pytest.mark.parametrize("generalized", [False, True])
def test_orth_block_against_matches_jax(generalized):
    """Equal rank; orthonormal to 1e-13 within the block and against q;
    the same span as gcge_tpu's result to 1e-12 (bases differ by a
    rotation: the two eigh's order degenerate directions differently)."""
    n, k = 400, 5
    d = np.random.default_rng(2).uniform(0.5, 2.0, n) if generalized \
        else None
    q, x = _basis_with_rank_drop(n, k, 1, d)
    jb = None if d is None else (lambda v: jnp.asarray(d)[:, None] * v)
    tb = None if d is None else (lambda v: _t(d)[:, None] * v)
    xj, rj = j_orth_against(jnp.asarray(x), jnp.asarray(q), jb)
    xt, rt = orth_block_against(_t(x), _t(q), tb)
    assert int(rt) == int(rj) == 4
    assert _b_orth_err(xt, 4, d) <= 1e-13
    bq = q if d is None else d[:, None] * q
    assert np.abs(bq.T @ xt.numpy()[:, :4]).max() <= 1e-13
    assert np.all(xt.numpy()[:, 4:] == 0.0)
    assert np.abs(_projector(xt, 4) - _projector(xj, 4)).max() <= 1e-12


@pytest.mark.parametrize("dup", [0, 2])
def test_orth_within_matches_jax(dup):
    """EVP orthonormalization with ``dup`` dependent columns: equal rank,
    orthonormal to 1e-13, the same span as gcge_tpu to 1e-12."""
    rng = np.random.default_rng(dup + 10)
    x = rng.standard_normal((300, 7))
    for i in range(dup):
        x[:, 6 - i] = x[:, i] + 0.5 * x[:, i + 1]
    xj, rj = j_orth_within(jnp.asarray(x))
    xt, rt = orth_within(_t(x))
    rank = 7 - dup
    assert int(rt) == int(rj) == rank
    assert _b_orth_err(xt, rank) <= 1e-13
    assert np.abs(_projector(xt, rank) - _projector(xj, rank)).max() <= 1e-12


def test_orth_against_removes_the_projection():
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.standard_normal((200, 4)))
    x = rng.standard_normal((200, 3)) + 1e3 * q[:, :3]
    y = orth_against(_t(x), _t(q)).numpy()
    assert np.abs(q.T @ y).max() <= 1e-13 * np.abs(x).max()


def test_orth_rejects_what_is_not_ported():
    """The TPU's emulated-f64 precisions raise for every method (bgs and
    mgs, ported since, run: see the tests below); an unknown method
    raises."""
    x = _t(np.eye(4))
    with pytest.raises(ValueError, match="precision"):
        orth_within(x, precision="mixed")
    with pytest.raises(ValueError, match="precision"):
        orth_block_against(x, x, precision="osgemm")
    for method in ("bgs", "mgs"):
        with pytest.raises(ValueError, match="precision"):
            orth_within(x, method=method, precision="osgemm")
        q, rank = orth_within(x, method=method)
        assert int(rank) == 4
        np.testing.assert_allclose(q.T @ q, np.eye(4), atol=1e-15)
    with pytest.raises(ValueError, match="unknown"):
        orth_within(x, method="qr")


@pytest.mark.parametrize("method,m,generalized", [
    ("mgs", 6, False), ("mgs", 6, True), ("bgs", 6, False),
    ("bgs", 40, False), ("bgs", 40, True)])
def test_mgs_and_bgs_match_jax(method, m, generalized):
    """``mgs_orth`` and ``bgs_orth`` (40 columns: two levels of the binary
    split over leaves of 10) against ``gcge_tpu``'s on the same block, with
    B = I or diagonal: equal rank, B-orthonormal to 1e-12, the same span to
    1e-10; the dependent column is zeroed where ``gcge_tpu`` zeroes it."""
    n = 300
    rng = np.random.default_rng(8)
    d = rng.uniform(0.5, 2.0, n) if generalized else None
    x = rng.standard_normal((n, m))
    x[:, 3] = x[:, 1] - 0.5 * x[:, 0]           # dependent: deflates
    jb = None if d is None else (lambda v: jnp.asarray(d)[:, None] * v)
    tb = None if d is None else (lambda v: _t(d)[:, None] * v)
    if method == "mgs":
        qj, rj = j_mgs_orth(jnp.asarray(x), jb, zero_tol=1e-20)
        qt, rt = mgs_orth(_t(x), tb, zero_tol=1e-20)
    else:
        qj, rj = j_bgs_orth(jnp.asarray(x), jb)
        qt, rt = bgs_orth(_t(x), tb)
    assert int(rt) == int(rj) == m - 1
    qt, qj = qt.numpy(), np.asarray(qj)
    # mgs zeroes column 3; bgs zeroes the last column of its leaf (the EVP
    # kernel compacts within a leaf), as gcge_tpu's does
    keep = [k for k in range(m) if np.abs(qt[:, k]).max() > 0]
    assert keep == [k for k in range(m) if np.abs(qj[:, k]).max() > 0]
    assert len(keep) == m - 1 and (method == "bgs" or 3 not in keep)
    assert _b_orth_err(qt[:, keep], m - 1, d) <= 1e-12
    np.testing.assert_allclose(_projector(qt[:, keep], m - 1),
                               _projector(qj[:, keep], m - 1), atol=1e-10)


def test_orth_within_compacts_deflated_columns_as_jax():
    """The case of ``tests/test_orth.py``: two dependent columns in a block
    of 8; every method gives ``gcge_tpu``'s rank, orthonormal leading
    columns, exact zeros behind them and ``gcge_tpu``'s span."""
    rng = np.random.default_rng(42)
    x = rng.standard_normal((200, 8))
    x[:, 3] = x[:, 1]
    x[:, 6] = 2 * x[:, 0]
    for method in ("evp", "bgs", "mgs"):
        qj, rj = j_orth_within(jnp.asarray(x), method=method, zero_tol=1e-10)
        qt, rt = orth_within(_t(x), method=method, zero_tol=1e-10)
        r = int(rt)
        assert r == int(rj) == 6, method
        qt = qt.numpy()
        np.testing.assert_allclose(qt[:, :r].T @ qt[:, :r], np.eye(r),
                                   atol=5e-12, err_msg=method)
        assert np.abs(qt[:, r:]).max() == 0.0, method
        np.testing.assert_allclose(_projector(qt, r),
                                   _projector(np.asarray(qj), r), atol=1e-10,
                                   err_msg=method)


@pytest.mark.parametrize("rate,max_iter", [(1e-9, 60), (1e-2, 40)])
def test_pcg_matches_jax(rate, max_iter):
    """One-column CG against ``gcge_tpu``'s ``pcg``, to a tight and to the
    default relative decrease: x to 1e-12 of max |x|, equal step counts."""
    n = 150
    a = _spd(n, 3)
    rng = np.random.default_rng(9)
    b, x0 = rng.standard_normal(n), 0.1 * rng.standard_normal(n)
    kw = dict(max_iter=max_iter, rate=rate, tol=1e-13)
    xj, ij = j_pcg(lambda v: jnp.asarray(a) @ v, jnp.asarray(b),
                   jnp.asarray(x0), **kw)
    xt, it = pcg(lambda v: _t(a) @ v, _t(b), _t(x0), **kw)
    assert xt.shape == (n,)
    assert int(it.niters) == int(ij.niters) > 0
    ref = np.asarray(xj)
    assert np.abs(xt.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def _spd(n, seed):
    """1-D Laplacian plus a random diagonal: SPD, moderately conditioned."""
    d = 2.0 + np.random.default_rng(seed).uniform(0.0, 0.5, n)
    return np.diag(d) - np.eye(n, k=1) - np.eye(n, k=-1)


@pytest.mark.parametrize("tol_type,precond,masked", [
    ("abs", False, False), ("rel", False, True), ("user", True, False),
    ("abs", True, True)])
def test_block_pcg_matches_jax(tol_type, precond, masked):
    """Equal iteration counts; x within 1e-10 of max |x|."""
    n, m = 120, 4
    a = _spd(n, 0)
    rng = np.random.default_rng(1)
    b = rng.standard_normal((n, m))
    x0 = rng.standard_normal((n, m)) * 0.1
    act = np.array([True, True, False, True]) if masked else None
    norm_b = np.linalg.norm(b, axis=0) if tol_type == "user" else None
    kw = dict(max_iter=40, rate=1e-6, tol=1e-12, tol_type=tol_type)
    dinv = 1.0 / np.diag(a)
    xj, ij = j_block_pcg(
        lambda v: jnp.asarray(a) @ v, jnp.asarray(b), jnp.asarray(x0),
        JParams(**kw), active0=None if act is None else jnp.asarray(act),
        norm_b=None if norm_b is None else jnp.asarray(norm_b),
        precond=(lambda r: jnp.asarray(dinv)[:, None] * r) if precond
        else None)
    xt, it = block_pcg(
        lambda v: _t(a) @ v, _t(b), _t(x0), BlockPCGParams(**kw),
        active0=None if act is None else _t(act),
        norm_b=None if norm_b is None else _t(norm_b),
        precond=(lambda r: _t(dinv)[:, None] * r) if precond else None)
    assert it.niters == int(ij.niters) > 0
    ref = np.asarray(xj)
    assert np.abs(xt.numpy() - ref).max() <= 1e-10 * np.abs(ref).max()
    np.testing.assert_allclose(it.init_res.numpy(), np.asarray(ij.init_res),
                               rtol=1e-12)
    if masked:
        np.testing.assert_array_equal(xt.numpy()[:, 2], x0[:, 2])


@pytest.mark.parametrize("precond", [False, True])
def test_block_pcg_t_matches_jax(precond):
    """Transposed layout, shifted (indefinite) operator as in GCG's inner
    solve: equal iteration counts, x within 1e-10 of max |x|."""
    n, m = 150, 5
    a = _spd(n, 2) - 0.3 * np.eye(n)
    rng = np.random.default_rng(4)
    bt = rng.standard_normal((m, n))
    act = np.array([True, False, True, True, True])
    kw = dict(max_iter=25, rate=1e-2, tol=1e-14)
    dinv = 1.0 / np.diag(a)
    xj, ij = j_block_pcg_t(
        lambda v: v @ jnp.asarray(a), jnp.asarray(bt), jnp.zeros((m, n)),
        JParams(**kw), active0=jnp.asarray(act),
        precond=(lambda r: r * jnp.asarray(dinv)[None, :]) if precond
        else None)
    xt, it = block_pcg_t(
        lambda v: v @ _t(a), _t(bt), torch.zeros((m, n), dtype=torch.float64),
        BlockPCGParams(**kw), active0=_t(act),
        precond=(lambda r: r * _t(dinv)[None, :]) if precond else None)
    assert it.niters == int(ij.niters) > 0
    ref = np.asarray(xj)
    assert np.abs(xt.numpy() - ref).max() <= 1e-10 * np.abs(ref).max()
    np.testing.assert_allclose(it.final_res.numpy(),
                               np.asarray(ij.final_res), rtol=1e-8)
    assert np.all(xt.numpy()[1] == 0.0)


def test_block_pcg_user_tol_needs_norm_b():
    with pytest.raises(ValueError, match="norm_b"):
        block_pcg(lambda v: v, _t(np.ones((3, 1))), _t(np.zeros((3, 1))),
                  BlockPCGParams(tol_type="user"))


def test_compute_p_orthogonalizes_on_plain_products(monkeypatch):
    """The P-coefficient block (120 x 10 at the headline) is orthogonalized
    on plain products (precision 'f64'), as gcge_tpu pins it, never through
    kernels 3/4: with the tall-GEMM wrappers made to raise, _compute_p
    still runs and gives gcge_tpu's P block (same rank, same span to 1e-10,
    the same eigenvalues of P^T A P)."""
    from gcge_tpu.solvers.gcg import _compute_p as j_compute_p
    from gcge_tpu_torch.ops import osgemm
    from gcge_tpu_torch.solvers.gcg import _compute_p

    n, size_x, bs = 300, 8, 4
    m = size_x + 2 * bs
    rng = np.random.default_rng(11)
    v, _ = np.linalg.qr(rng.standard_normal((n, m)))
    h = rng.standard_normal((m, m))
    h = h + h.T
    _, ss_evec = np.linalg.eigh(h)
    act_idx = np.arange(2, 2 + bs)
    p_ref = j_compute_p(jnp.asarray(v), jnp.asarray(ss_evec), jnp.asarray(h),
                        jnp.asarray(act_idx), bs, size_x, bs, 1e-13, 2)
    vj, _, rank_j, h_pp_j = (np.asarray(t) for t in p_ref)

    def no_kernel(*args):
        raise AssertionError("the P coefficients went through a tall kernel")

    monkeypatch.setattr(osgemm, "tall_gram", no_kernel)
    monkeypatch.setattr(osgemm, "tall_expand", no_kernel)
    p, rank, h_pp = _compute_p(_t(v), _t(ss_evec), _t(h),
                               torch.as_tensor(act_idx), bs, size_x, bs,
                               1e-13, 2)
    r = int(rank)
    assert r == int(rank_j)
    pj = vj[:, size_x:size_x + bs]
    np.testing.assert_allclose(_projector(p.numpy(), r), _projector(pj, r),
                               atol=1e-10)
    np.testing.assert_allclose(np.linalg.eigvalsh(h_pp.numpy()[:r, :r]),
                               np.linalg.eigvalsh(h_pp_j[:r, :r]), atol=1e-10)


@pytest.mark.parametrize("precision,through_kernels", [("auto", True),
                                                       ("f64", False)])
def test_orth_precision_routes_the_tall_products(monkeypatch, precision,
                                                 through_kernels):
    """'auto' sends the orthogonalization's Grams and recombinations through
    the tall-GEMM wrappers (kernels 3/4 on a card), 'f64' through the plain
    products; on the CPU both give the same bits."""
    from gcge_tpu_torch.ops import osgemm

    calls = []
    for name in ("tall_gram", "tall_expand"):
        fn = getattr(osgemm, name)
        monkeypatch.setattr(osgemm, name, lambda *a, fn=fn, name=name:
                            calls.append(name) or fn(*a))
    q, x = _basis_with_rank_drop(200, 5, 4)
    got, rank = orth_block_against(_t(x), _t(q), precision=precision)
    assert bool(calls) == through_kernels
    monkeypatch.undo()
    other = "f64" if precision == "auto" else "auto"
    ref, rank_ref = orth_block_against(_t(x), _t(q), precision=other)
    assert int(rank) == int(rank_ref) and torch.equal(got, ref)
