#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gcge_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each of which raises on failure:

1. build — print the card's name and power limit, build the CUDA kernels from
   ``gcge_tpu_torch/ops/csrc`` and print the build time;
2. kernels 1-4 — run each wrapper on the card at the shapes of the headline
   solve, hold it against its plain PyTorch version on the same inputs
   (stated tolerance), and time it (CUDA events, median of 20, each after
   a flush of the L2 cache) beside the plain version and beside the one PyTorch call that computes the same
   function (``torch.sparse.mm`` on a CSR tensor, ``a.T @ b``, ``a @ c``);
3. headline solve — ``gcge_tpu_torch.solve`` on the 3-D 27-point Laplacian at
   nx=54 (n=157,464), nev=50 at tol_rel 1e-8, block 10, inner CG budget 30;
   checks the converged count, the eigenvalues against the closed-form
   spectrum, the residuals with scipy on the host, and that kernels 1-4 were
   launched during the solve;
4. irregular matrix — the P1 FEM stiffness matrix on an unstructured Delaunay
   tet mesh of 64^3 jittered points (n=250,047), built on the host with the
   port's own ``io.fem``, and its RCM ordering; host times printed;
5. kernels 5-7 — the CSR SpMM kernels on the RCM-ordered matrix (block 10 in
   both layouts, block 40 transposed) against the plain version and beside
   ``torch.sparse.mm``; the mask probe against its plain version bit for bit;
   kernels 3 and 4 again at this matrix's n;
6. Hybrid check — a banded matrix plus a thin scatter of outliers (n=50,000)
   through ``make_operator``: DIA core and CSR remainder applied together in
   f64 and f32 against scipy;
7. irregular solve — ``gcge_tpu_torch.solve(a, None, nev=50, rcm=True,
   block_size=10, max_iter=300, cg_max_iter=60, cg_refine=3)``; checks the
   layout, the converged count, the residuals with scipy in the caller's
   ordering, that kernels 3-7 were launched (the mask probe by
   ``CsrOperator.from_coo``), and the eigenvalues against a
   second solve that goes through no hand-written SpMM (A as a prebuilt ELL
   operator, plain gather route).

``--profile`` adds 30 iterations of the irregular solve under
``torch.profiler`` and prints the device's busy and idle share, the device
time by kernel and the host synchronisations.

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the package beside this script, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
NX, NEV, BS = 54, 50, 10
MESH = 64                    # jittered-grid resolution of the Delaunay mesh
REPS = 20
DEVICE = "cuda"
T_START = time.perf_counter()

# the card's published peaks (H100 SXM data sheet): device memory rate, and
# the f64 tensor-core and f32 rates, both 67 TFLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = 67e12

IRREGULAR_KWARGS = dict(nev=NEV, block_size=BS, max_iter=300, cg_max_iter=60,
                        cg_refine=3)


def build_3d27(nx: int):
    """3-D 27-point Laplacian stencil on an nx^3 grid (COO, symmetric)."""
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


def smallest_eigs(nx: int, k: int) -> np.ndarray:
    """The k smallest eigenvalues of the stencil in closed form:
    A = 27 I - J(x)J(x)J with J = tridiag(1, 1, 1), eig(J) = 1 + 2 cos(t pi/(nx+1))."""
    mu = 1.0 + 2.0 * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
    lam = 27.0 - np.einsum("i,j,k->ijk", mu, mu, mu).ravel()
    return np.sort(lam)[:k]


def median_ms(torch, fn, reps: int = REPS, flush=None) -> float:
    """Median time of fn() on the card over reps runs, by CUDA events.
    ``flush``: a buffer larger than the L2 cache, overwritten before each
    timed run.  fn() then finds the cache cold, as a solve's next SpMM does,
    and is queued while the card is still busy, so the time between the
    events holds none of the host's launch latency (about 25 microseconds
    when the card waits for the host, as it does without the flush)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: float, flops: float):
    """The least time the card could take, in ms, and what sets it: the
    bytes the function must move (each input read once, each output written
    once) over the memory rate, or its operations over the peak rate."""
    t_bytes, t_flops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S
    return 1e3 * max(t_bytes, t_flops), \
        "bytes" if t_bytes >= t_flops else "operations"


def residuals(a_csr, ev, x):
    """Host residuals ||A x - lambda x|| / (|lambda| ||x||) per pair."""
    r = a_csr @ x - x * ev[None, :]
    return np.linalg.norm(r, axis=0) / (np.abs(ev) * np.linalg.norm(x, axis=0))


class KernelLog:
    """Runs each kernel against its plain version, times it, and keeps one
    entry per kernel for the ``kernels`` line: the largest absolute error
    over all shapes, and the times and the bound of its ``primary`` shape.
    Every time is a median of 20 runs, each after a flush of the L2 cache
    (see :func:`median_ms`)."""

    def __init__(self, torch):
        self.torch = torch
        self.entries = {}

    def run(self, key, label, kernel, plain, scale, tol, nbytes, flops,
            library=None, primary=False):
        """scale: the error's reference size, a scalar or per entry;
        tol 0 demands equal bits."""
        torch = self.torch
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        if tol == 0:
            abs_err = rel = 0.0 if torch.equal(got, ref) else float("inf")
        else:
            diff = (got - ref).abs()
            abs_err = float(diff.max())
            rel = float((diff / scale).max())
        # five times the 50 MB L2 cache; freed on return, so that it does
        # not count towards a solve's peak memory
        flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
        ms = median_ms(torch, kernel, flush=flush)
        plain_ms = median_ms(torch, plain, flush=flush)
        lib_ms = None if library is None else \
            median_ms(torch, library, flush=flush)
        back_to_back_ms = median_ms(torch, kernel)
        bound_ms, bound_by = bound(nbytes, flops)
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"kernel {label}: max rel err {rel:.3e} (tol {tol:.0e}), "
              f"{ms:.4f} ms ({back_to_back_ms:.4f} ms back to back, host "
              f"launch latency included) vs plain {plain_ms:.4f} ms, library "
              f"call {lib}, bound {bound_ms:.4g} ms by {bound_by}")
        if not rel <= tol:
            raise AssertionError(f"{label}: relative error {rel:.3e} > {tol}")
        entry = self.entries.setdefault(key, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], abs_err)
        if primary:
            entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib_ms, shape=label)


def cg_operand(torch, apply_t, n, m, gen):
    """An ``(m, n)`` f32 operand with the strides the mixed inner CG hands
    the transposed SpMM: built the way ``_mixed_inner_solve`` and
    ``block_pcg_t`` build their first search direction from the f64
    residual."""
    r = torch.randn((n, m), generator=gen, dtype=torch.float64,
                    device=DEVICE)
    rt = r.T.float()
    active = torch.ones(m, dtype=torch.bool, device=DEVICE)[:, None]
    res = torch.where(active, rt - apply_t(torch.zeros_like(rt)), 0.0)
    return torch.where(active, res + 0.0 * torch.zeros_like(res), 0.0)


def csr_tensor(torch, a_csr, dtype):
    """A scipy CSR matrix as a torch CSR tensor on the card: the operand of
    the library call timed beside the SpMM kernels, used nowhere in the
    port."""
    return torch.sparse_csr_tensor(
        torch.as_tensor(a_csr.indptr, device=DEVICE),
        torch.as_tensor(a_csr.indices, device=DEVICE),
        torch.as_tensor(a_csr.data, device=DEVICE).to(dtype),
        size=a_csr.shape, check_invariants=False)


def reset_counters():
    from gcge_tpu_torch.ops import onehot, osgemm, spmm

    for counters in (spmm.LAUNCHES, osgemm.LAUNCHES, onehot.LAUNCHES):
        for key in counters:
            counters[key] = 0


def read_counters() -> dict:
    from gcge_tpu_torch.ops import onehot, osgemm, spmm

    return {**spmm.LAUNCHES, **osgemm.LAUNCHES, **onehot.LAUNCHES}


def phase_build():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    card = out.splitlines()[0]
    print(card)
    from gcge_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(path, HERE)}")
    return card


def kernels_tall(torch, log, n, gen, primary):
    """Kernels 3 and 4 against their plain versions at the shapes a nev=50,
    block-10 solve of size n gives them."""
    from gcge_tpu_torch.ops import osgemm

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           device=DEVICE)

    # kernel 3: tall Gram; error relative to ||a_i|| ||b_j|| per entry
    basis = randn(n, 120)
    for p, q in ((120, 10), (100, 100)):
        a, b = basis[:, :p], randn(n, q)
        norms = a.norm(dim=0)[:, None] * b.norm(dim=0)[None, :]
        log.run("gram", f"tall_gram n={n} ({p}x{q})",
                lambda a=a, b=b: osgemm.tall_gram(a, b),
                lambda a=a, b=b: osgemm.tall_gram_reference(a, b), norms,
                1e-13, 8 * (n * p + n * q + p * q), 2.0 * n * p * q,
                library=lambda a=a, b=b: a.T @ b,
                primary=(primary and q == 10))
    # kernel 4: tall expand; error relative to max (|a| |c|)
    a, c = basis, randn(120, 100)
    scale = (a.abs() @ c.abs()).max()
    log.run("expand", f"tall_expand n={n} (n x 120)(120 x 100)",
            lambda: osgemm.tall_expand(a, c),
            lambda: osgemm.tall_expand_reference(a, c), scale, 1e-13,
            8 * (n * 120 + 120 * 100 + n * 100), 2.0 * n * 120 * 100,
            library=lambda: a @ c, primary=primary)


def phase_kernels_headline(torch, log, rows, cols, vals, n):
    """Kernels 1-4 against their plain versions at the headline shapes."""
    import scipy.sparse as sps

    from gcge_tpu_torch import make_operator
    from gcge_tpu_torch.ops import spmm

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float64):
        return torch.randn(shape, generator=gen, dtype=dtype, device=dev)

    op = make_operator(rows, cols, vals, (n, n), device=dev)
    v64, offs = op.values, op.offsets_t
    v32 = v64.float()
    a_csr = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    lib64 = csr_tensor(torch, a_csr, torch.float64)
    lib32 = csr_tensor(torch, a_csr, torch.float32)
    ndiag = v64.shape[0]

    def dia_cost(m, item):
        return ((ndiag * n + 2 * n * m) * item + 4 * ndiag,
                2.0 * a_csr.nnz * m)

    # kernel 1: f64 DIA, both layouts; error relative to max (|A| |x|).  The
    # library call takes the (n, m) layout in every case.
    for m in (10, 100):
        for transposed in (False, True):
            x = randn(m, n) if transposed else randn(n, m)
            x_nm = x.T.contiguous() if transposed else x
            scale = spmm.dia_spmm_reference(v64.abs(), offs, x.abs(),
                                            transposed).max()
            log.run("dia_f64", f"dia_f64 m={m} transposed={transposed}",
                    lambda: spmm.dia_spmm(v64, offs, x, transposed),
                    lambda: spmm.dia_spmm_reference(v64, offs, x, transposed),
                    scale, 1e-14, *dia_cost(m, 8),
                    library=lambda: torch.sparse.mm(lib64, x_nm),
                    primary=(m == 10 and not transposed))
    # kernel 2: f32 DIA, transposed (the mixed inner CG): a contiguous
    # operand, and one with the strides the CG hands it
    for xt in (randn(BS, n, dtype=torch.float32),
               cg_operand(torch, lambda z: spmm.dia_spmm(v32, offs, z, True),
                          n, BS, gen)):
        xt_nm = xt.T.contiguous()
        scale = spmm.dia_spmm_reference(v32.abs(), offs, xt.abs(), True).max()
        log.run("dia_f32", f"dia_f32 m={BS} transposed=True strides "
                f"{tuple(xt.stride())}",
                lambda: spmm.dia_spmm(v32, offs, xt, True),
                lambda: spmm.dia_spmm_reference(v32, offs, xt, True), scale,
                1e-5, *dia_cost(BS, 4),
                library=lambda: torch.sparse.mm(lib32, xt_nm),
                primary=not xt.is_contiguous())
    kernels_tall(torch, log, n, gen, primary=True)


def phase_headline(torch, rows, cols, vals, n):
    """The headline solve through the public entry point."""
    import scipy.sparse as sps

    import gcge_tpu_torch

    a_csr = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    kwargs = dict(nev=NEV, device=DEVICE, block_size=BS, max_iter=120,
                  cg_max_iter=30)
    # the first solve in the process also pays the one-time set-up of the
    # CUDA libraries (cuBLAS, cuSOLVER handles); the second is the one
    # checked and counted
    t0 = time.perf_counter()
    gcge_tpu_torch.solve(a_csr, None, verbose=0, **kwargs)
    torch.cuda.synchronize()
    print(f"headline: first solve in the process "
          f"{time.perf_counter() - t0:.3f} s")
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ev, evec, nev_conv = gcge_tpu_torch.solve(a_csr, None, verbose=1,
                                              **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    print(f"headline: wall {wall:.3f} s, nev_conv {nev_conv}, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {launches}")
    if nev_conv < NEV:
        raise AssertionError(f"nev_conv {nev_conv} < {NEV}")
    exact = smallest_eigs(NX, NEV)
    ev_err = float(np.max(np.abs(ev[:NEV] - exact) / np.abs(exact)))
    res = residuals(a_csr, ev[:NEV], evec[:, :NEV].cpu().numpy())
    print(f"headline: eigenvalues vs closed form max rel err {ev_err:.3e} "
          f"(tol 1e-9); host residuals max {res.max():.3e} (tol 2e-8)")
    if not ev_err <= 1e-9:
        raise AssertionError(f"eigenvalue error {ev_err:.3e} > 1e-9")
    if not res.max() <= 2e-8:
        raise AssertionError(f"residual {res.max():.3e} > 2e-8")
    idle = [k for k in ("dia_f64", "dia_f32", "gram", "expand")
            if launches[k] <= 0]
    if idle:
        raise AssertionError(f"kernels not launched by the solve: {idle}")
    return launches


def build_delaunay(g: int):
    """The irregular matrix: P1 stiffness on a Delaunay tet mesh of g^3
    jittered points (seed 1), in the mesh's own ordering, and its RCM
    permutation.  All on the host."""
    import scipy.sparse as sps
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from gcge_tpu_torch.io.fem import assemble_p1, random_delaunay_mesh

    t0 = time.perf_counter()
    verts, tets, bnd = random_delaunay_mesh(g ** 3, seed=1)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows, cols, av, _, n = assemble_p1(verts, tets, bnd)
    a = sps.coo_matrix((av, (rows, cols)), shape=(n, n)).tocsr()
    t_asm = time.perf_counter() - t0
    t0 = time.perf_counter()
    perm = np.ascontiguousarray(reverse_cuthill_mckee(a, symmetric_mode=True),
                                dtype=np.int64)
    t_rcm = time.perf_counter() - t0
    a_rcm = a[perm][:, perm].tocsr()
    coo = a_rcm.tocoo()
    uniq, counts = np.unique(coo.col - coo.row, return_counts=True)
    cover = np.sort(counts)[::-1][:128].sum() / a.nnz
    print(f"irregular matrix (mesh {g}^3): n={n} nnz={a.nnz} "
          f"({a.nnz / n:.1f}/row, max {np.diff(a_rcm.indptr).max()}); after "
          f"RCM {len(uniq)} diagonals, top-128 cover {cover:.2f}; host times: "
          f"mesh {t_mesh:.1f} s, assembly {t_asm:.1f} s, RCM {t_rcm:.1f} s")
    if n != (g - 1) ** 3:
        raise AssertionError(f"n = {n}, expected {(g - 1) ** 3}")
    return a, a_rcm


def phase_kernels_irregular(torch, log, a_rcm):
    """Kernels 5-7, and kernels 3 and 4 again, against their plain versions
    at the irregular solve's shapes (n = 250,047 is odd: the tall kernels'
    last chunk is a partial one).  Returns the operator ``make_operator``
    picked."""
    from gcge_tpu_torch import make_operator
    from gcge_tpu_torch.ops import onehot

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    n = a_rcm.shape[0]
    coo = a_rcm.tocoo()
    op = make_operator(coo.row, coo.col, coo.data, (n, n), device=dev)
    if not isinstance(op, onehot.CsrOperator):
        raise AssertionError(f"make_operator picked {type(op).__name__}, "
                             "not CsrOperator")
    rowptr, colidx = op.rowptr, op.colidx
    nnz = int(op.values.shape[0])
    values = {torch.float64: op.values, torch.float32: op.values.float()}
    lib = {dt: csr_tensor(torch, a_rcm, dt) for dt in values}
    # kernel 6 (f64) and kernel 5 (f32); error relative to max (|A| |x|)
    for dtype, key, tol, item, main in (
            (torch.float64, "csr_f64", 1e-14, 8, (10, False, True)),
            (torch.float32, "csr_f32", 1e-5, 4, (10, True, False))):
        vals = values[dtype]
        for m, transposed in ((10, False), (10, True), (40, True),
                              (10, "cg")):
            if transposed == "cg":          # the f32 stages' own operand
                if dtype != torch.float32:
                    continue
                x = cg_operand(torch, lambda z: onehot.csr_spmm(
                    rowptr, colidx, vals, z, True), n, m, gen)
                transposed = True
            else:
                x = torch.randn((m, n) if transposed else (n, m),
                                generator=gen, dtype=dtype, device=dev)
            x_nm = x.T.contiguous() if transposed else x
            scale = onehot.csr_spmm_reference(rowptr, colidx, vals.abs(),
                                              x.abs(), transposed).max()
            log.run(key, f"{key} m={m} transposed={transposed} strides "
                    f"{tuple(x.stride())}",
                    lambda: onehot.csr_spmm(rowptr, colidx, vals, x,
                                            transposed),
                    lambda: onehot.csr_spmm_reference(rowptr, colidx, vals, x,
                                                      transposed),
                    scale, tol,
                    nnz * (4 + item) + 4 * (n + 1) + 2 * n * m * item,
                    2.0 * nnz * m,
                    library=lambda: torch.sparse.mm(lib[dtype], x_nm),
                    primary=((m, transposed, x.is_contiguous()) == main))
    # kernel 7: the mask probe, bit for bit
    rng = np.random.default_rng(0)
    for name, ids0 in (("ids=arange%8", np.arange(128) % 8),
                       ("ids random < 300", rng.integers(0, 300, 128))):
        ids = np.zeros(onehot.MASK_SHAPE, np.int32)
        ids[0] = ids0
        ids_t = torch.as_tensor(ids, device=dev)
        log.run("mask_probe", f"onehot_mask_probe {name}",
                lambda: onehot.onehot_mask_probe(ids_t),
                lambda: onehot.onehot_mask_reference(ids_t), 1.0, 0,
                4 * 128 + 2 * 8 * 128, 8 * 128,
                primary=(name == "ids=arange%8"))
    kernels_tall(torch, log, n, gen, primary=False)
    return op


def phase_hybrid(torch):
    """A Hybrid operator on the card: 13 full diagonals plus 20,000 scattered
    outliers at n=50,000, applied in f64 and f32 against scipy."""
    import scipy.sparse as sps

    from gcge_tpu_torch import DiaOperator, HybridOperator, make_operator

    n, m = 50_000, 10
    rng = np.random.default_rng(2)
    band = sps.diags([rng.standard_normal(n - abs(k)) for k in range(-6, 7)],
                     list(range(-6, 7)), format="coo")
    out = sps.coo_matrix((rng.standard_normal(20_000),
                          (rng.integers(0, n, 20_000),
                           rng.integers(0, n, 20_000))), shape=(n, n))
    a = (band + out).tocoo()
    op = make_operator(a.row, a.col, a.data, (n, n), device=DEVICE)
    if not isinstance(op, HybridOperator) or op.rest is None:
        raise AssertionError(f"make_operator picked {type(op).__name__}, "
                             "not a HybridOperator with a remainder")
    x = rng.standard_normal((n, m))
    ref = a @ x
    scale = (abs(a) @ np.abs(x)).max()
    reset_counters()
    x64 = torch.as_tensor(x, device=DEVICE)
    y64 = op.matvec(x64)
    op32 = HybridOperator(DiaOperator(op.dia.values.float(), op.dia.offsets,
                                      op.dia.n_cols), op.rest)
    y32 = op32.matvec(x64.float())
    torch.cuda.synchronize()
    err64 = np.abs(y64.cpu().numpy() - ref).max() / scale
    err32 = np.abs(y32.double().cpu().numpy() - ref).max() / scale
    launches = read_counters()
    print(f"hybrid (n={n}, {len(op.dia.offsets)} diagonals + {op.rest.nnz} "
          f"outliers): f64 err {err64:.3e} (tol 1e-14), f32 err {err32:.3e} "
          f"(tol 1e-5) of max |A||x|; launches {launches}")
    if not (err64 <= 1e-14 and err32 <= 1e-5):
        raise AssertionError("hybrid matvec disagrees with scipy")
    if [launches[k] for k in ("dia_f64", "dia_f32", "csr_f64",
                              "csr_f32")] != [1, 1, 1, 1]:
        raise AssertionError(f"hybrid matvec launches: {launches}")


def phase_irregular(torch, a, a_rcm):
    """The irregular solve through the public entry point, checked, and
    compared with a solve on the plain gather route."""
    import gcge_tpu_torch
    from gcge_tpu_torch import SparseOperator

    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ev, evec, nev_conv = gcge_tpu_torch.solve(
        a, None, device=DEVICE, rcm=True, verbose=1, **IRREGULAR_KWARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    print(f"irregular: wall {wall:.3f} s (host RCM and packing included), "
          f"nev_conv {nev_conv}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {launches}")
    if nev_conv < NEV:
        raise AssertionError(f"nev_conv {nev_conv} < {NEV}")
    # residuals on the caller's (un-permuted) matrix: the eigenvectors came
    # back in the caller's ordering
    res = residuals(a, ev[:NEV], evec[:, :NEV].cpu().numpy())
    print(f"irregular: host residuals in the caller's ordering max "
          f"{res.max():.3e} (tol 2e-8)")
    if not res.max() <= 2e-8:
        raise AssertionError(f"residual {res.max():.3e} > 2e-8")
    idle = [k for k in ("gram", "expand", "csr_f32", "csr_f64", "mask_probe")
            if launches[k] <= 0]
    if idle:
        raise AssertionError(f"kernels not launched by the solve: {idle}")

    # the same problem through no hand-written SpMM: a prebuilt ELL operator
    # (one PyTorch gather per ELL column), at full width: about twice the
    # kernel route's wall
    coo = a_rcm.tocoo()
    ell = SparseOperator.from_coo(coo.row, coo.col, coo.data, coo.shape,
                                  device=DEVICE)
    reset_counters()
    t0 = time.perf_counter()
    ev_plain, _, conv_plain = gcge_tpu_torch.solve(
        ell, None, device=DEVICE, verbose=0, **IRREGULAR_KWARGS)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    spmm_launches = {k: v for k, v in read_counters().items()
                     if k.startswith(("csr", "dia"))}
    rel = float(np.max(np.abs(ev[:NEV] - ev_plain[:NEV])
                       / np.abs(ev_plain[:NEV])))
    print(f"irregular vs plain gather route (mesh {MESH}^3, ELL width "
          f"{ell.values.shape[1]}): eigenvalues max rel diff {rel:.3e} "
          f"(tol 1e-9); plain-route wall {wall_plain:.3f} s, nev_conv "
          f"{conv_plain}; kernel-route wall {wall:.3f} s")
    if conv_plain < NEV or not rel <= 1e-9:
        raise AssertionError("the plain-route solve disagrees")
    if any(spmm_launches.values()):
        raise AssertionError(f"the plain route launched {spmm_launches}")
    return launches


def phase_profile(torch, op):
    """30 iterations of the irregular solve under torch.profiler, on the
    operator already packed on the card (no host RCM or packing in the
    window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import gcge_tpu_torch

    kwargs = dict(IRREGULAR_KWARGS, max_iter=30)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gcge_tpu_torch.solve(op, None, device=DEVICE, verbose=1, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    syncs = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:      # kernels, copies, memsets
            rows.append((e.self_device_time_total, e.count, e.key))
        elif e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                       "cudaMemcpyAsync", "cudaEventSynchronize"):
            syncs += e.count
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) * 1e-6
    ops = sum(r[1] for r in rows)
    print(f"profile (30 iterations of the irregular solve): wall {wall:.4f} "
          f"s, device busy {busy:.4f} s, idle "
          f"{100 * (1 - busy / wall):.2f} % of the wall, {ops} device "
          f"operations, {syncs} host syncs/copies")
    for dev_us, count, key in rows[:14]:
        print(f"profile: {dev_us * 1e-3:10.3f} ms {count:8d} x  {key[:90]}")


KERNELS = (  # key, source, the TPU kernel it replaces
    ("dia_f64", "gcge_tpu_torch/ops/csrc/dia_spmm.cu",
     "gcge_tpu/ops/spmm_pallas.py:207"),
    ("dia_f32", "gcge_tpu_torch/ops/csrc/dia_spmm.cu",
     "gcge_tpu/ops/spmm_pallas.py:68"),
    ("gram", "gcge_tpu_torch/ops/csrc/tall_gemm.cu",
     "gcge_tpu/ops/osgemm_pallas.py:137"),
    ("expand", "gcge_tpu_torch/ops/csrc/tall_gemm.cu",
     "gcge_tpu/ops/osgemm_pallas.py:290"),
    ("csr_f32", "gcge_tpu_torch/ops/csrc/csr_spmm.cu",
     "gcge_tpu/ops/onehot_pallas.py:244"),
    ("csr_f64", "gcge_tpu_torch/ops/csrc/csr_spmm.cu",
     "gcge_tpu/ops/onehot_pallas.py:454"),
    ("mask_probe", "gcge_tpu_torch/ops/csrc/mask_probe.cu",
     "gcge_tpu/ops/onehot_pallas.py:200"),
)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import gcge_tpu_torch  # noqa: F401  (fails here, before any output, without the package)

    card = phase_build()
    log = KernelLog(torch)
    rows, cols, vals, n = build_3d27(NX)
    phase_kernels_headline(torch, log, rows, cols, vals, n)
    headline = phase_headline(torch, rows, cols, vals, n)
    a, a_rcm = build_delaunay(MESH)
    op = phase_kernels_irregular(torch, log, a_rcm)
    phase_hybrid(torch)
    irregular = phase_irregular(torch, a, a_rcm)
    if "--profile" in argv:
        phase_profile(torch, op)
    print(f"chip_smoke: {time.perf_counter() - T_START:.0f} s")
    print(card)
    print(json.dumps({"kernels": [
        {"name": key, "route": "cuda", "source": src, "replaces": rep,
         "launches": headline[key] + irregular[key],
         "launches_by_path": {"headline": headline[key],
                              "irregular": irregular[key]},
         **log.entries[key], "lib_ms": log.entries[key]["library_ms"]}
        for key, src, rep in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
