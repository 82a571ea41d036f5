"""The port's projected-problem eigensolvers (``gcge_tpu_torch.ops.eighs``:
``jacobi_polish``, ``eigh_jacobi``, ``eigh_newton``, ``eigh`` by backend),
GCG's structural Rayleigh-Ritz warm start and ``orth_block``'s wide-Gram
rule, held against gcge_tpu on the same numpy inputs (the matrices of
``tests/test_eighs.py``), and the Jacobi kernel's schedule against the plain
round it replaces.  GCG solves with the new backends against gcge_tpu's are
in ``tests/test_torch_gcg.py``.

Tolerances: eigenvalues within 1e-10 of gcge_tpu's (relative to the largest
|eigenvalue|), eigenvectors by their residual ``||HU - UW|| <= 1e-10 ||H||``
and orthonormality to 1e-10: both packages refine to about 1e-15, but
eigenvectors inside a degenerate cluster are any basis of it, so they are
held by residual and not entry by entry.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcge_tpu.ops import eighs as J
from gcge_tpu.solvers.gcg import _rr_struct_warm as j_struct_warm
from gcge_tpu.solvers.orth import orth_block as j_orth_block
from gcge_tpu_torch import DenseOperator, GCGParams, gcg_solve
from gcge_tpu_torch.ops import eighs as T
from gcge_tpu_torch.solvers import gcg
from gcge_tpu_torch.solvers import orth as t_orth

torch.set_num_threads(2)


def _clustered_sym(rng, m, clusters):
    """Symmetric matrix with prescribed multiplicities
    (``tests/test_eighs.py``)."""
    lam = []
    v = 0.1
    for mult, gap in clusters:
        lam += [v + 1e-10 * i for i in range(mult)]
        v += gap
    if len(lam) < m:
        lam += list(np.linspace(v, v + 10.0, m - len(lam)))
    lam = np.sort(np.asarray(lam[:m]))
    q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    h = q @ np.diag(lam) @ q.T
    return 0.5 * (h + h.T), lam


def _corrupt(rng, u, size):
    """``u`` rotated by a random skew of ``size``: a warm start with the
    error level of the TPU's f32-accurate back-transform."""
    m = u.shape[0]
    noise = size * rng.standard_normal((m, m))
    return u @ np.linalg.qr(np.eye(m) + 0.5 * (noise - noise.T))[0]


def _check(h, w, u, w_ref, tol=1e-10):
    """Eigenvalues to ``w_ref``, residual and orthonormality, all within
    ``tol`` (relative to the largest |eigenvalue|)."""
    w, u = np.asarray(w), np.asarray(u)
    scale = np.abs(w_ref).max()
    assert np.all(np.diff(w) >= 0)
    assert np.abs(w - np.asarray(w_ref)).max() <= tol * scale
    assert np.abs(h @ u - u * w[None, :]).max() <= tol * scale
    assert np.abs(u.T @ u - np.eye(u.shape[1])).max() <= tol


M_NEWTON = 160   # one order for every case: gcge_tpu compiles two programs


def _newton_case(name):
    """``(h, exact eigenvalues, keyword arguments)`` of an eigh_newton
    case (the spectra of ``tests/test_eighs.py`` at one order), the warm
    start as numpy arrays."""
    rng = np.random.default_rng(7)
    m = M_NEWTON
    if name == "clustered":
        h, lam = _clustered_sym(rng, m, [(6, 0.5), (3, 0.2), (1, 1.0)] * 8)
        return h, lam, {}
    if name == "over_cap":              # a cluster wider than the 64 cap
        h, lam = _clustered_sym(rng, m, [(80, 2.0), (1, 0.3)])
        return h, lam, {}
    if name == "identity":
        return 3.0 * np.eye(m), np.full(m, 3.0), {}
    if name == "f32_warm":              # the f32 eigh's warm start, 3 passes
        h, lam = _clustered_sym(rng, m, [(4, 0.3), (1, 0.6)] * 10)
        return h, lam, {"warm_dtype": "f32"}
    if name == "corrupted_warm":
        h, lam = _clustered_sym(rng, m, [(5, 0.4), (2, 0.1), (1, 0.8)] * 8)
        w_ex, u_ex = np.linalg.eigh(h)
        return h, lam, {"warm": (w_ex, _corrupt(rng, u_ex, 3e-6))}
    # coarse_warm: an over-cap run of 100 eigenvalues 1e-6 apart, the warm
    # start mixed inside it and rotated at 2e-5 (the closing stage runs)
    nc = 100
    lam = np.sort(np.concatenate([1.0 + 1e-6 * np.arange(nc),
                                  np.linspace(2.0, 50.0, m - nc)]))
    q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    h = 0.5 * ((q * lam) @ q.T + ((q * lam) @ q.T).T)
    u0 = q.copy()
    u0[:, :nc] = u0[:, :nc] @ np.linalg.qr(rng.standard_normal((nc, nc)))[0]
    u0 = _corrupt(rng, u0, 2e-5)
    return h, lam, {"warm": (np.sort(np.diag(u0.T @ h @ u0)), u0)}


@pytest.mark.parametrize("name", ["clustered", "over_cap", "identity",
                                  "corrupted_warm", "coarse_warm",
                                  "f32_warm"])
def test_eigh_newton_matches_jax(name):
    """``eigh_newton`` on ``tests/test_eighs.py``'s spectra (clusters, a
    cluster over the cap, a fully degenerate one, a corrupted warm start,
    an over-cap near-degenerate run mixed inside a coarse warm start, the
    f32 eigh's warm start) against gcge_tpu's: eigenvalues 1e-10 of its and
    of the exact ones, residual and orthonormality 1e-10; the closing stage
    adds no eigh wait of its own (each of its rounds, counted in
    ``NEWTON``, is one batched block eigh)."""
    h, lam, kw = _newton_case(name)
    T.CALLS["safe_eigh"] = T.NEWTON["closing_rounds"] = 0

    def args(to):
        return {k: tuple(to(a) for a in v) if k == "warm" else v
                for k, v in kw.items()}

    wt, ut = T.eigh_newton(torch.as_tensor(h), **args(torch.as_tensor))
    wj, _ = J.eigh_newton(jnp.asarray(h), **args(jnp.asarray))
    _check(h, wt.numpy(), ut.numpy(), np.asarray(wj))
    _check(h, wt.numpy(), ut.numpy(), lam)
    # the warm eigh (none with a warm start) and one batched block eigh a
    # cluster stage: one a pass, plus the cluster-first stage with a warm
    # start, plus the closing rounds
    f32 = kw.get("warm_dtype") == "f32"
    stages = 1 + ("warm" in kw or f32) + 2 * f32
    closing = T.NEWTON["closing_rounds"]
    assert closing <= 3
    assert T.CALLS["safe_eigh"] == ("warm" not in kw) + stages + closing


@pytest.mark.parametrize("m,kind", [(40, "corrupted"), (33, "odd"),
                                    (48, "clustered")])
def test_jacobi_polish_matches_jax(m, kind):
    """``jacobi_polish`` from a warm start carrying 1e-6 of error (odd m
    pads a dummy slot), ``eigh_jacobi`` cold: both against gcge_tpu's,
    eigenvalues 1e-10, residual and orthonormality 1e-10."""
    rng = np.random.default_rng(m)
    if kind == "clustered":
        h, _ = _clustered_sym(rng, m, [(4, 0.5), (2, 0.2), (1, 1.0)] * 5)
    else:
        a = rng.standard_normal((m, m))
        h = 0.5 * (a + a.T)
    w_ex, u_ex = np.linalg.eigh(h)
    u0 = _corrupt(rng, u_ex, 1e-6)
    assert np.abs(h @ u0 - u0 * w_ex).max() > 1e-8 * np.abs(w_ex).max()
    wt, ut = T.jacobi_polish(torch.as_tensor(h), torch.as_tensor(w_ex),
                             torch.as_tensor(u0), sweeps=3)
    wj, _ = J.jacobi_polish(jnp.asarray(h), jnp.asarray(w_ex),
                            jnp.asarray(u0), sweeps=3)
    _check(h, wt.numpy(), ut.numpy(), np.asarray(wj))
    wt, ut = T.eigh_jacobi(torch.as_tensor(h))
    wj, _ = J.eigh_jacobi(jnp.asarray(h))
    _check(h, wt.numpy(), ut.numpy(), np.asarray(wj))


@pytest.mark.parametrize("backend", list(T.BACKENDS))
def test_eigh_backend_matches_jax(backend):
    """``eigh(h, backend)`` for each of the five backends against gcge_tpu's
    dispatch of the same name (off the TPU its ``'auto'`` is ``'device'``,
    and so is the port's: the same bits as ``safe_eigh``)."""
    h, lam = _clustered_sym(np.random.default_rng(1), M_NEWTON,
                            [(1, 1.0)] * 10)
    wt, ut = T.eigh(torch.as_tensor(h), backend)
    wj, _ = J.eigh(jnp.asarray(h), backend)
    _check(h, wt.numpy(), ut.numpy(), np.asarray(wj))
    _check(h, wt.numpy(), ut.numpy(), lam)
    if backend == "auto":
        ws, us = T.safe_eigh(torch.as_tensor(h))
        assert torch.equal(ws, wt) and torch.equal(us, ut)
    with pytest.raises(ValueError, match="unknown"):
        T.eigh(torch.as_tensor(h), "lapack")


def _kernel_schedule(h1, sweeps, cluster=1):
    """The Jacobi kernel's schedule (``csrc/jacobi.cu``) in numpy: a
    cluster of ``cluster`` blocks, block j owning the rows ``[j R, (j+1)
    R)``, ``R = ceil(me / cluster)`` (the last blocks may own fewer or
    none); positions stay put, round r pairs the indices ``pi_r(i)`` and
    ``pi_r(me-1-i)``; H double-buffered: every block forms all the round's
    rotations (``_schur_cs``) from the current buffer, then computes the
    new values of its own rows only, each from its old row and its
    partner's old row fetched from the owner (row rotation, then the
    column rotations within the row), into the other buffer; V's rows never
    leave their block.  The stop test is the max over the blocks of each
    block's max over its rows."""
    h, me = h1.copy(), h1.shape[0]
    m2 = me // 2
    rows = -(-me // cluster)
    owned = [np.arange(j * rows, min(me, (j + 1) * rows))
             for j in range(cluster)]
    v = np.eye(me)

    def cluster_max(a):
        return max([np.abs(a[o]).max() for o in owned if o.size] + [0.0])

    scale = max(cluster_max(h), 1e-300)
    p, q = np.arange(m2), me - 1 - np.arange(m2)     # pi_0: the identity
    pos = np.arange(me)
    k = 0
    while k < sweeps and cluster_max(h - np.diag(np.diag(h))) > \
            1e-13 * scale:
        for _ in range(me - 1):
            new = np.empty_like(h)
            for o in owned:
                if not o.size:
                    continue
                c, s = (x.numpy() for x in T._schur_cs(
                    torch.as_tensor(h[p, p]), torch.as_tensor(h[q, q]),
                    torch.as_tensor(h[p, q])))
                pside = pos[o] < m2
                a = np.where(pside, pos[o], me - 1 - pos[o])
                partner = np.where(pside, q[a], p[a])
                ca, sa = c[a][:, None], s[a][:, None]
                cb, sb = c[None, :], s[None, :]
                x0, x1 = h[o][:, p], h[o][:, q]
                y0, y1 = h[partner][:, p], h[partner][:, q]
                ps = pside[:, None]
                r0 = np.where(ps, ca * x0 - sa * y0, sa * y0 + ca * x0)
                r1 = np.where(ps, ca * x1 - sa * y1, sa * y1 + ca * x1)
                new[o[:, None], p] = cb * r0 - sb * r1
                new[o[:, None], q] = sb * r0 + cb * r1
                vp, vq = v[o][:, p], v[o][:, q]
                v[o[:, None], p] = cb * vp - sb * vq
                v[o[:, None], q] = sb * vp + cb * vq
            h = new
            # the next round's maps, advanced without division
            p = np.where(p == 0, 0, np.where(p == 1, me - 1, p - 1))
            q = np.where(q == 0, 0, np.where(q == 1, me - 1, q - 1))
            pos = np.where(pos == 0, 0, np.where(pos == me - 1, 1, pos + 1))
        k += 1
    return h, v, k


def _warm_operand(me, noise):
    rng = np.random.default_rng(me)
    a = rng.standard_normal((me, me))
    _, q = np.linalg.eigh(a + a.T)
    qn = q + noise * rng.standard_normal(q.shape)
    h1 = qn.T @ (a + a.T) @ qn
    return 0.5 * (h1 + h1.T)


@pytest.mark.parametrize("me,noise", [(2, 1.0), (8, 1e-3), (20, 1e-2),
                                      (30, 1.0), (64, 1e-6)])
def test_jacobi_kernel_schedule_has_the_plain_bits(me, noise):
    """The kernel's in-place schedule gives the systolic round's bits and
    sweep count (the permutations sigma compose to the index map pi_r, and
    a sweep restores the identity), and pairs in each round the indices
    that ``_round_robin_rounds`` pairs; one block a matrix here, clusters
    in ``test_jacobi_cluster_schedule_has_the_plain_bits``."""
    h1 = _warm_operand(me, noise)
    hk, vk, kk = _kernel_schedule(h1, 6)
    hp, vp, kp = T.jacobi_sweeps(torch.as_tensor(h1), 6)
    # the index map pairs what the circle method pairs, round by round
    for r, (lo, hi) in enumerate(T._round_robin_rounds(me)):
        pi = np.r_[0, 1 + (np.arange(me - 1) - r) % (me - 1)]
        p, q = pi[:me // 2], pi[::-1][:me // 2]
        assert sorted(zip(np.minimum(p, q), np.maximum(p, q))) == \
            sorted(zip(lo, hi))
    assert kk == int(kp) > 0
    assert np.array_equal(hk, hp.numpy()) and np.array_equal(vk, vp.numpy())


@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("me,noise", [(2, 1.0), (10, 1e-2), (30, 1e-6)])
def test_jacobi_cluster_schedule_has_the_plain_bits(me, noise, cluster):
    """The cluster partition of the kernel (rows by physical index over C
    blocks, each block computing its own rows from its partners' old rows,
    every block its own rotations) gives the plain version's bits and
    sweep counts, also where C does not divide me and where blocks own no
    rows (me = 2 over 3, 4 or 16 blocks; me = 30 over 16: 15 blocks of 2
    and one of none)."""
    h1 = _warm_operand(me, noise)
    hk, vk, kk = _kernel_schedule(h1, 6, cluster)
    hp, vp, kp = T.jacobi_sweeps_plain(torch.as_tensor(h1), 6)
    assert kk == int(kp) > 0
    assert np.array_equal(hk, hp.numpy()) and np.array_equal(vk, vp.numpy())


@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("me", [64, 80, 120, 160, 240, 480, 512, 960])
def test_jacobi_plan_fits_the_card(me, batch):
    """The launch plan at the solves' operands: a cluster of at most 16
    blocks, batch x C within the H100's 132 SMs, every block owning rows
    and together all of them, at most 227 KB of shared memory a block,
    threads a multiple of 32 (at most 1,024), one thread for each column
    pair and row group; H's two buffers in shared memory where they fit,
    else V where it fits; a single matrix on the largest cluster; a forced
    cluster size keeps its empty blocks; the batches of the closing stage
    on the cluster size of least cost where the card holds fewer clusters
    than the batch."""
    plan = T.jacobi_plan(me, batch)
    c, rows = plan.cluster, plan.rows
    assert 1 <= c <= T.JACOBI_MAX_CLUSTER and batch * c <= T.JACOBI_SMS \
        or c == 1
    assert rows * (c - 1) < me <= rows * c
    assert plan.smem <= T.JACOBI_SMEM
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert plan.threads >= min(me // 2, 512)
    mat = 8 * rows * me
    base = plan.smem - mat * (2 * plan.h_shared + plan.v_shared)
    assert plan.h_shared == (base + 2 * mat <= T.JACOBI_SMEM)
    assert plan.v_shared == (base + mat * (2 * plan.h_shared + 1)
                             <= T.JACOBI_SMEM)
    if batch == 1:
        assert c == -(-me // -(-me // 16))
    forced = T.jacobi_plan(me, batch, cluster=16)
    assert forced.cluster == 16 and forced.rows == -(-me // 16)
    # a card that holds 7 clusters of 10 to 16 blocks: 8 blocks of 480 on
    # clusters of 9 in one wave (V in shared memory), 8 of 512 on 16 in two
    # (V would not fit on 9)
    held = T.jacobi_plan(me, batch, resident=lambda p: 7 if p.cluster >= 10
                         else T.JACOBI_SMS // p.cluster)
    if (me, batch) == (480, 8):
        assert (held.cluster, held.v_shared) == (9, True)
    if (me, batch) == (512, 8):
        assert (held.cluster, held.v_shared) == (16, True)


def test_jacobi_plan_raises_where_the_card_holds_no_cluster():
    """A plan the card cannot launch raises: no silent second path."""
    with pytest.raises(RuntimeError, match="holds no cluster"):
        T.jacobi_plan(240, 1, resident=lambda p: 0)
    with pytest.raises(RuntimeError, match="holds no cluster"):
        T.jacobi_plan(240, 1, cluster=16, resident=lambda p: 0)
    with pytest.raises(ValueError, match="cluster of 1 to 16"):
        T.jacobi_plan(240, 1, cluster=17)
    with pytest.raises(ValueError, match="even order"):
        T.jacobi_plan(15, 1)
    # the largest orders: a cluster of 16 holds the tables one block
    # cannot, and past that the plan refuses
    assert T.jacobi_plan(4466, 1).cluster == 16
    with pytest.raises(ValueError, match="bytes of tables"):
        T.jacobi_plan(7200, 1)


def _struct_matrix(rng, size_x, bs, coupling):
    """A projected matrix with the Rayleigh-Ritz structure
    (``tests/test_eighs.py``): X block diagonal, X-P coupling 0, X-W
    coupling of size ``coupling``."""
    m = size_x + 2 * bs
    h = np.zeros((m, m))
    h[np.arange(size_x), np.arange(size_x)] = np.sort(
        0.1 + rng.uniform(0, 5.0, size_x))
    hpp = rng.standard_normal((bs, bs))
    hww = rng.standard_normal((bs, bs))
    h[size_x:size_x + bs, size_x:size_x + bs] = 0.5 * (hpp + hpp.T) + \
        5 * np.eye(bs)
    h[size_x + bs:, size_x + bs:] = 0.5 * (hww + hww.T) + 8 * np.eye(bs)
    cpw = rng.standard_normal((bs, bs)) * 0.5
    h[size_x:size_x + bs, size_x + bs:] = cpw
    h[size_x + bs:, size_x:size_x + bs] = cpw.T
    cxw = rng.standard_normal((size_x, bs)) * coupling
    h[:size_x, size_x + bs:] = cxw
    h[size_x + bs:, :size_x] = cxw.T
    return h


@pytest.mark.parametrize("coupling,premise", [(1e-4, True), (0.5, False),
                                              ("below", True),
                                              ("above", False)])
def test_rr_struct_warm_matches_jax(coupling, premise):
    """``_rr_struct_warm`` against gcge_tpu's: ``d0`` to 1e-12, ``u0`` and
    ``h1`` to 1e-12 up to the signs of the trailing block's eigenvectors;
    ``h1`` is ``u0^T h u0``; the premise (``||H1 offdiag|| < 0.02
    spread``) is gcge_tpu's, also at couplings a relative 1e-12 below and
    above the threshold (``'below'``, ``'above'``; the X-W coupling scales
    ``||H1 offdiag||`` and leaves the spread as it is); where it holds, the
    warm Newton eigh reaches LAPACK's eigenvalues to 1e-11."""
    size_x, bs = 80, 10
    if isinstance(coupling, str):
        h = _struct_matrix(np.random.default_rng(5), size_x, bs, 1.0)
        _, _, hj = (np.asarray(a) for a in j_struct_warm(jnp.asarray(h),
                                                         size_x, bs))
        ratio = np.linalg.norm(hj - np.diag(np.diag(hj))) / np.ptp(
            np.diag(hj))
        coupling = 0.02 / ratio * (1.0 + (1e-12 if coupling == "above"
                                          else -1e-12))
    h = _struct_matrix(np.random.default_rng(5), size_x, bs, coupling)
    d0, u0, h1, ok = gcg._rr_struct_warm(torch.as_tensor(h), size_x, bs)
    dj, uj, hj = (np.asarray(a) for a in j_struct_warm(jnp.asarray(h),
                                                       size_x, bs))
    d0, u0, h1 = d0.numpy(), u0.numpy(), h1.numpy()
    scale = np.abs(h).max()
    assert np.abs(d0 - dj).max() <= 1e-12 * scale
    sign = np.sign(np.sum(u0 * uj, axis=0))
    assert np.abs(u0 * sign - uj).max() <= 1e-12
    assert np.abs(sign[:, None] * h1 * sign[None, :] - hj).max() <= \
        1e-12 * scale
    assert np.abs(h1 - u0.T @ h @ u0).max() <= 1e-12 * scale
    off = hj - np.diag(np.diag(hj))
    assert ok == premise == bool(np.linalg.norm(off) < 0.02 * np.ptp(dj))
    if ok:
        w, u = T.eigh_newton(torch.as_tensor(h), warm=(
            torch.as_tensor(d0), torch.as_tensor(u0)),
            warm_h1=torch.as_tensor(h1), cluster_first=False)
        _check(h, w.numpy(), u.numpy(), np.linalg.eigh(h)[0], tol=1e-11)


def test_orth_block_wide_gram_matches_jax():
    """``orth_block`` on a block of 768 columns (``F32_WARM_MIN_M``, the
    width from which both packages take ``eigh_newton``; InitializeX's
    random block at nev=384), its columns scaled from 1 to 2, against
    gcge_tpu's: the same rank, ``Q^T Q = I`` to 1e-12 and the same span to
    1e-10 (the sine of the largest principal angle).  The earlier rule
    (``safe_eigh`` at every width) meets these bounds too: the rules differ
    in rounding only on such a block.  The Gram's eigenvalues lie apart by
    far more than the f32 warm start's error, so neither package's cluster
    stage sweeps: columns graded over three decades make gcge_tpu's
    program run hundreds of Jacobi rounds, which took 505 s on a CPU
    shared with the rest of the suite (12 s alone); the clustered spectra
    are held at 160 rows by :func:`test_eigh_newton_matches_jax`."""
    n, m = 800, 768
    r = m
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, m)) * np.linspace(1.0, 2.0, m)
    calls = []
    newton = t_orth.eigh_newton
    t_orth.eigh_newton = lambda g: calls.append(g.shape) or newton(g)
    try:
        qt, rt = t_orth.orth_block(torch.as_tensor(x))
    finally:
        t_orth.eigh_newton = newton
    qj, rj = j_orth_block(jnp.asarray(x))
    qt, qj = qt.numpy(), np.asarray(qj)
    assert calls == [(m, m)] * 2            # both passes
    assert int(rt) == int(rj) == r
    assert np.abs(qt[:, :r].T @ qt[:, :r] - np.eye(r)).max() <= 1e-12
    sine = np.linalg.norm(qj[:, :r] - qt[:, :r] @ (qt[:, :r].T @ qj[:, :r]),
                          2)
    assert sine <= 1e-10


_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
          "__float__", "__index__")


@pytest.mark.parametrize("backend,warm", [("newton", "struct"),
                                          ("jacobi", "auto")])
def test_fused_chunk_reads_nothing_back(monkeypatch, backend, warm):
    """``tests/test_torch_fused.py``'s guard with the new backends: inside
    a fused chunk every read of a tensor's value on the host raises except
    in ``host_read_allowed``'s region (the eighs' waits, which carry the
    structural warm start's premise and the closing stage's flags) and in
    the Jacobi sweeps' plain version, which stands for the kernel here (on a
    card the kernel's loop exits on the device)."""
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

    sweeps = T.jacobi_sweeps

    def kernel(*args):
        with lifted(None):
            return sweeps(*args)

    chunk = gcg._gcg_chunk

    def armed_chunk(*args, **kwargs):
        armed["on"] = True
        try:
            return chunk(*args, **kwargs)
        finally:
            armed["on"] = False
            armed["chunks"] += 1

    monkeypatch.setattr(T, "host_read_allowed", lifted)
    monkeypatch.setattr(T, "jacobi_sweeps", kernel)
    monkeypatch.setattr(gcg, "_gcg_chunk", armed_chunk)
    n = 300
    a = 2.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    x0 = np.random.default_rng(11).uniform(-1, 1, (n, 16))
    res = gcg_solve(DenseOperator(torch.as_tensor(a)), None, GCGParams(
        nev=8, max_iter=80, fuse=8, rr_backend=backend, rr_warm=warm,
        verbose=0), x0=x0)
    assert res.nev_conv >= 8
    assert armed["chunks"] == len(res.history) > 1
