"""The port's fused iteration (``fuse > 0``) on the CPU: the traced
convergence logic against ``gcge_tpu``'s and against the port's host
version, the fixed-count CG against the early-exit CG, fused solves against
the port's phased solves and against ``gcge_tpu``'s fused solves, and a
check that a chunk reads no solver state back.

Both packages get the same full-width starting block from numpy.  Fused
against phased in the port: the same arithmetic in f64, so equal converged
counts, equal iteration counts and eigenvalues within 1e-10 relative.
Against ``gcge_tpu``'s fused path: eigenvalues within 1e-10, equal converged
counts, iterations within 2 (``gcge_tpu`` tests its stopping condition
before an iteration and so runs one more after the last check; degenerate
clusters make the two ``eigh``s return other eigenbases).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcge_tpu.ops.operators import DenseOperator as JDense
from gcge_tpu.ops.operators import DiagOperator as JDiag
from gcge_tpu.ops.operators import DiaOperator as JDia
from gcge_tpu.ops.operators import SparseOperator as JSparse
from gcge_tpu.solvers import gcg as jgcg
from gcge_tpu_torch import (CsrOperator, DenseOperator, DiagOperator,
                            DiaOperator, GCGParams, gcg_solve)
from gcge_tpu_torch.ops import eighs
from gcge_tpu_torch.solvers import gcg
from gcge_tpu_torch.solvers.bpcg import (BlockPCGParams, block_pcg,
                                         block_pcg_t)

torch.set_num_threads(2)

TOL_ABS, TOL_REL, GAP_MIN = 1e-1, 1e-8, 0.01


# --------------------------------------------------------------------------
# _check_convergence_traced
# --------------------------------------------------------------------------


def _window_case(kind: str, seed: int):
    """Ritz values, a residual window and the counts for one branch of the
    convergence logic: ``(res, ss_eval, nev_conv_prev, size_x, bs, cw,
    multi_max)``."""
    rng = np.random.default_rng(seed)
    size_x, bs = 24, 4
    cw, multi_max = 2 * bs, bs
    lam = np.cumsum(rng.uniform(0.5, 1.5, size_x + 2 * bs))     # real gaps
    nev_conv_prev = int(rng.integers(0, 8))
    good = lambda k: rng.uniform(1e-12, 1e-10, k)     # converged residuals
    bad = lambda k: rng.uniform(1e-4, 1e-2, k)
    if kind == "all_converged":
        res = good(cw)
    elif kind == "none_converged":
        res = bad(cw)
    elif kind == "mixed":
        res = np.where(rng.random(cw) < 0.5, good(cw), bad(cw))
    elif kind == "cluster_across_idx":
        # the first unconverged column sits inside a cluster of three
        # nearly equal values: nev_conv backs off to the cluster's start
        res = np.concatenate([good(5), bad(cw - 5)])
        c = nev_conv_prev + 3
        lam[c + 1:c + 3] = lam[c] * (1 + 1e-4 * np.arange(1, 3))
    elif kind == "multi_max_binding":
        # a cluster wider than multi_max below the first unconverged column
        multi_max = 2
        res = np.concatenate([good(6), bad(cw - 6)])
        c = nev_conv_prev
        lam[c + 1:c + 7] = lam[c] * (1 + 1e-4 * np.arange(1, 7))
    elif kind == "c0_clipped":
        # nev_conv near the end of X: the window is clipped to end at
        # size_x and the scan starts inside it
        nev_conv_prev = size_x - 3
        res = np.concatenate([good(cw - 2), bad(2)])
    elif kind == "fallback_window":
        # everything in a window that ends at size_x has converged: no
        # column is active and the window falls back to nev_conv
        nev_conv_prev = size_x - cw
        res = good(cw)
    elif kind == "tail_extends":
        # fewer than bs unconverged columns in the window: the active set
        # is filled from the columns behind it
        res = np.concatenate([good(cw - 1), bad(1)])
    elif kind == "zero_eigenvalue":
        lam = lam - lam[nev_conv_prev]          # a Ritz value that is 0
        res = np.concatenate([good(2), bad(cw - 2)])
    else:
        raise ValueError(kind)
    return res, np.sort(lam), nev_conv_prev, size_x, bs, cw, multi_max


@pytest.mark.parametrize("kind", [
    "all_converged", "none_converged", "mixed", "cluster_across_idx",
    "multi_max_binding", "c0_clipped", "fallback_window", "tail_extends",
    "zero_eigenvalue"])
def test_check_convergence_traced_matches_jax_and_host(kind):
    """The device form of the convergence and window logic gives what
    ``gcge_tpu``'s traced form and the port's host form give, over seeded
    windows of every branch (with the one exception noted below)."""
    for seed in range(6):
        res, lam, prev, size_x, bs, cw, multi_max = _window_case(kind, seed)
        c0 = min(prev, size_x - cw)
        scan_from = prev - c0
        want = gcg._check_convergence_host(
            res, lam, c0, scan_from, prev, size_x, bs, TOL_ABS, TOL_REL,
            GAP_MIN, multi_max)
        jax_out = jgcg._check_convergence_traced(
            jnp.asarray(res), jnp.asarray(lam), jnp.int32(c0),
            jnp.int32(scan_from), jnp.int32(prev), size_x, bs, TOL_ABS,
            TOL_REL, GAP_MIN, multi_max)
        got = gcg._check_convergence_traced(
            torch.as_tensor(res), torch.as_tensor(lam), torch.tensor(c0),
            torch.tensor(scan_from), torch.tensor(prev), size_x, bs, TOL_ABS,
            TOL_REL, GAP_MIN, multi_max)
        for other in (want, jax_out):
            assert int(got[0]) == int(other[0]), (kind, seed)
            assert got[1].tolist() == np.asarray(other[1]).tolist(), \
                (kind, seed)
        assert int(got[2]) == want[2], (kind, seed)
        # gcge_tpu's own two forms differ in one corner: in the fallback
        # window its traced form counts bs columns (the index list repeats
        # the last one), its host form the columns that exist.  The port's
        # two forms agree, on the host form's count.
        assert int(jax_out[2]) == (bs if kind == "fallback_window"
                                   else want[2]), (kind, seed)
        assert got[1].dtype == torch.int64 and got[0].dim() == 0


def test_window_cases_hit_their_branches():
    """The cases above are what their names say."""
    def run(kind):
        res, lam, prev, size_x, bs, cw, multi_max = _window_case(kind, 0)
        c0 = min(prev, size_x - cw)
        nev, act, cnt = gcg._check_convergence_host(
            res, lam, c0, prev - c0, prev, size_x, bs, TOL_ABS, TOL_REL,
            GAP_MIN, multi_max)
        return nev, act, cnt, prev, c0, size_x, bs, cw

    nev, act, cnt, prev, c0, size_x, bs, cw = run("all_converged")
    assert nev == c0 + cw and act[0] == c0 + cw
    nev, *_ = run("none_converged")
    assert nev == _window_case("none_converged", 0)[2]
    nev, act, cnt, prev, c0, *_ = run("cluster_across_idx")
    assert nev == prev + 3 < c0 + 5          # backed off below the first bad
    nev, act, cnt, prev, c0, *_ = run("multi_max_binding")
    assert nev == c0 + 6 - 2                  # capped at multi_max = 2
    nev, act, cnt, prev, c0, size_x, bs, cw = run("c0_clipped")
    assert c0 < prev and cnt == 2
    nev, act, cnt, prev, c0, size_x, bs, cw = run("fallback_window")
    assert nev == size_x and cnt == 1 and act.tolist() == [size_x - 1] * bs
    nev, act, cnt, prev, c0, size_x, bs, cw = run("tail_extends")
    assert cnt == bs and act.tolist() == [c0 + cw - 1, c0 + cw, c0 + cw + 1,
                                          c0 + cw + 2]


# --------------------------------------------------------------------------
# fixed-count CG
# --------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["columns", "rows"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fixed_count_cg_equals_early_exit(layout, dtype):
    """The fixed-count form runs all its steps; a step on which no column
    is active changes nothing, so the solution, the residuals and the count
    of active steps equal the early-exit form's, bit for bit."""
    rng = np.random.default_rng(3)
    n, m = 120, 5
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = torch.as_tensor((q * np.geomspace(1.0, 30.0, n)) @ q.T, dtype=dtype)
    b = torch.as_tensor(rng.standard_normal((n, m)), dtype=dtype)
    b[:, 3] = 0.0                         # a column that starts converged
    x0 = torch.zeros_like(b)
    active0 = torch.tensor([True, True, False, True, True])
    params = BlockPCGParams(max_iter=60, rate=1e-3, tol=1e-30)
    if layout == "columns":
        early = block_pcg(lambda y: a @ y, b, x0, params, active0=active0)
        fixed = block_pcg(lambda y: a @ y, b, x0, params, active0=active0,
                          fixed=True)
    else:
        early = block_pcg_t(lambda y: y @ a, b.T, x0.T, params,
                            active0=active0)
        fixed = block_pcg_t(lambda y: y @ a, b.T, x0.T, params,
                            active0=active0, fixed=True)
    assert 0 < early[1].niters < params.max_iter     # it did exit early
    assert torch.equal(fixed[0], early[0])
    assert torch.equal(fixed[1].final_res, early[1].final_res)
    assert torch.equal(fixed[1].init_res, early[1].init_res)
    assert torch.is_tensor(fixed[1].niters) and fixed[1].niters.dim() == 0
    assert int(fixed[1].niters) == early[1].niters


# --------------------------------------------------------------------------
# fused solves
# --------------------------------------------------------------------------


def _laplacian_1d(n):
    return (np.diag(np.full(n, 2.0)) - np.diag(np.ones(n - 1), 1)
            - np.diag(np.ones(n - 1), -1))


def _case(name):
    """``(torch operators, jax operators, params, x0)`` of a fused case."""
    rng = np.random.default_rng(11)
    if name in ("plain", "restart_growth"):
        n = 300
        a = _laplacian_1d(n)
        ops = (DenseOperator(torch.as_tensor(a)), None)
        jops = (JDense(jnp.asarray(a)), None)
        if name == "plain":
            kw = dict(nev=8, max_iter=80, fuse=8)
            width = 16
        else:
            kw = dict(nev=8, block_size=3, nev_max=16, nev_init=9,
                      max_iter=100, fuse=4)
            width = 9
    elif name == "mixed_dia":
        n = 400
        a = _laplacian_1d(n)
        rows, cols = np.nonzero(a)
        ops = (DiaOperator.from_coo(rows, cols, a[rows, cols], (n, n),
                                    device="cpu"), None)
        jops = (JDia.from_coo(rows, cols, a[rows, cols], (n, n)), None)
        kw = dict(nev=8, block_size=4, max_iter=100, cg_mixed=True,
                  cg_refine=2, fuse=4)
        width = 16
    elif name in ("csr", "diagonal_b"):
        # a random symmetric sparse matrix, diagonally dominant
        n = 250
        dense = np.where(rng.random((n, n)) < 0.03,
                         rng.standard_normal((n, n)), 0.0)
        dense = dense + dense.T
        dense += np.diag(np.abs(dense).sum(axis=1) + rng.uniform(0.1, 4, n))
        rows, cols = np.nonzero(dense)
        vals = dense[rows, cols]
        d = rng.uniform(0.5, 1.5, n) if name == "diagonal_b" else None
        ops = (CsrOperator.from_coo(rows, cols, vals, (n, n), device="cpu"),
               None if d is None else DiagOperator(torch.as_tensor(d)))
        jops = (JSparse.from_coo(rows, cols, vals, (n, n)),
                None if d is None else JDiag(jnp.asarray(d)))
        kw = dict(nev=6, block_size=3, max_iter=150, fuse=5)
        if name == "diagonal_b":
            kw.update(cg_mixed=True, cg_refine=3, cg_auto_shift=True)
        width = 12
    else:
        raise ValueError(name)
    x0 = rng.uniform(-1, 1, (n, width))
    return ops, jops, dict(kw, verbose=0), x0


def _rel(ev, ref, nev):
    ev, ref = np.asarray(ev)[:nev], np.asarray(ref)[:nev]
    return np.max(np.abs(ev - ref) / np.abs(ref))


@pytest.mark.parametrize("name", ["plain", "restart_growth", "mixed_dia",
                                  "csr", "diagonal_b"])
def test_fused_matches_phased_and_jax_fused(name):
    (a_op, b_op), (ja_op, jb_op), kw, x0 = _case(name)
    nev = kw["nev"]
    fused = gcg_solve(a_op, b_op, GCGParams(**kw), x0=x0)
    phased = gcg_solve(a_op, b_op, GCGParams(**{**kw, "fuse": 0}), x0=x0)
    assert fused.nev_conv == phased.nev_conv >= nev
    assert fused.num_iter == phased.num_iter
    assert len(fused.eval) == len(phased.eval)
    assert _rel(fused.eval, phased.eval, nev) <= 1e-10
    # one history entry per chunk, the last one the result
    assert fused.history[-1][1] == fused.nev_conv
    assert len(fused.history) < len(phased.history)
    if name == "restart_growth":
        assert len(fused.eval) > x0.shape[1]            # the basis grew
    jfused = jgcg.gcg_solve(ja_op, jb_op, jgcg.GCGParams(**kw),
                            x0=jnp.asarray(x0))
    assert fused.nev_conv == jfused.nev_conv
    assert _rel(fused.eval, jfused.eval, nev) <= 1e-10
    assert abs(fused.num_iter - jfused.num_iter) <= 2


def test_fused_budget_and_frontend():
    """The iteration budget ends a fused solve where it ends a phased one,
    and ``solve(..., fuse=k)`` reaches the fused loop."""
    import gcge_tpu_torch

    (a_op, _), _, kw, x0 = _case("plain")
    # 19: the first pair converges at the budget's last check
    kw = dict(kw, max_iter=19, fuse=5)
    fused = gcg_solve(a_op, None, GCGParams(**kw), x0=x0)
    phased = gcg_solve(a_op, None, GCGParams(**{**kw, "fuse": 0}), x0=x0)
    assert fused.num_iter == phased.num_iter == 19
    assert [h[0] for h in fused.history] == [5, 10, 15, 19]
    assert np.array_equal(fused.eval, phased.eval)
    # the budget's last check is made: the count and the residual window are
    # those of the last iterate, not of the one before
    assert fused.nev_conv == phased.nev_conv == 1
    assert fused.history[-1] == phased.history[-1]
    assert np.array_equal(fused.res_norms, phased.res_norms)
    ev, evec, conv = gcge_tpu_torch.solve(a_op, None, nev=8, device="cpu",
                                          x0=x0, max_iter=80, fuse=8,
                                          verbose=0)
    assert conv >= 8 and evec.shape == (300, 16)


# --------------------------------------------------------------------------
# no host read inside a chunk
# --------------------------------------------------------------------------

_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
          "__float__", "__index__")


def test_chunk_reads_nothing_back(monkeypatch):
    """Inside ``_gcg_chunk`` every way of reading a tensor's value on the
    host raises, except inside ``safe_eigh``'s own region: the solve still
    runs, so the port's code reads nothing back between a chunk's start and
    its end."""
    armed = {"on": False, "chunks": 0}

    def guarded(name, method):
        def read(self, *args, **kwargs):
            if armed["on"]:
                raise AssertionError(f"Tensor.{name} inside a fused chunk")
            return method(self, *args, **kwargs)
        return read

    for name in _READS:
        monkeypatch.setattr(torch.Tensor, name,
                            guarded(name, getattr(torch.Tensor, name)))

    @contextlib.contextmanager
    def lifted(device):
        was, armed["on"] = armed["on"], False
        try:
            yield
        finally:
            armed["on"] = was

    chunk = gcg._gcg_chunk

    def armed_chunk(*args, **kwargs):
        armed["on"] = True
        try:
            return chunk(*args, **kwargs)
        finally:
            armed["on"] = False
            armed["chunks"] += 1

    monkeypatch.setattr(eighs, "host_read_allowed", lifted)
    monkeypatch.setattr(gcg, "_gcg_chunk", armed_chunk)
    # the guard works
    armed["on"] = True
    with pytest.raises(AssertionError, match="__bool__"):
        bool(torch.ones(()))
    with pytest.raises(AssertionError, match="item"):
        torch.ones(()).item()
    armed["on"] = False
    for name in ("diagonal_b", "restart_growth"):
        (a_op, b_op), _, kw, x0 = _case(name)
        before = armed["chunks"]
        res = gcg_solve(a_op, b_op, GCGParams(**kw), x0=x0)
        assert res.nev_conv >= kw["nev"]
        assert armed["chunks"] - before == len(res.history) > 1
