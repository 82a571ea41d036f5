#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gcge_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Nine kernels, four solves (the headline and the irregular problem, each by
the phased and by the fused loop), the two kernel measurement scripts, the
multilevel path on the cube FEM pair (GCG preconditioned by an AMG V-cycle,
standard and generalized, and the PAS solver), a check that a fused chunk
never waits for the device outside ``eigh``, kernels 1 and 2 on halo
windows, the row-sharded solves on a one-rank NCCL mesh, the utils, the
distributed multilevel path (AMG and PAS on a sharded hierarchy) on a
one-rank NCCL mesh, and the headline and AMG solves on a (1, 1) grid.
Phases, each of which raises on failure:

1. build — print the card's name and power limit, build the CUDA kernels from
   ``gcge_tpu_torch/ops/csrc`` and print the build time; check one 16 x 8 x 8
   tile of the f64 mma that kernels 3 and 4 use against ``a @ c`` (the
   fragment layout), and one 64 x 112 x 64 product through kernel 9's bf16
   wgmma against ``a.float() @ b.float().T`` (its operand and accumulator
   layouts);
2. kernels 1-4 — run each wrapper on the card at the shapes of the headline
   solve, hold it against its plain PyTorch version on the same inputs
   (stated tolerance), and time it (CUDA events, median of 20, each after
   a read of a buffer five times the L2 cache, which leaves the cache cold
   and clean) beside the plain version and beside the one
   PyTorch call that computes the same function (``torch.sparse.mm`` on a
   CSR tensor, ``a.T @ b``, ``a @ c``); kernel 1 at the operands a solve
   hands it (primary: ``V[:, 110:120]`` of an (n, 120) basis, the W
   coupling of every Rayleigh-Ritz step; then the residual window
   ``ritz[:, 41:51]``, the initial Rayleigh-Ritz ``V[:, :100]``) and in the
   contiguous and transposed layouts, kernel 2 at the f32 CG stage's operand
   and beside it, each SpMM row with equal bits across two launches and its
   product in the memory order of its operand; kernels 3 and 4 at every
   shape class a solve gives them (Gram (120 x 10), (110 x 10), (10 x 10),
   (100 x 100); expand (n x 120)(120 x 100), (n x 120)(120 x 10),
   (n x 110)(110 x 10), (n x 10)(10 x 10)), each also with equal bits across
   two launches;
3. headline solve — ``gcge_tpu_torch.solve`` on the 3-D 27-point Laplacian at
   nx=54 (n=157,464), nev=50 at tol_rel 1e-8, block 10, inner CG budget 30;
   checks the converged count, the eigenvalues against the closed-form
   spectrum, the residuals with scipy on the host, and that kernels 1-4 were
   launched during the solve; prints kernels 3 and 4's calls per iteration
   by shape class, and their summed time (the kernel phase's, at this n)
   against their summed bound (so for every checked solve);
4. irregular matrix — the P1 FEM stiffness matrix on an unstructured Delaunay
   tet mesh of 64^3 jittered points (n=250,047), built on the host with the
   port's own ``io.fem``, and its RCM ordering; host times printed;
5. kernels 5-7 — the CSR SpMM kernels on the RCM-ordered matrix against the
   plain version and beside ``torch.sparse.mm``, as kernels 1 and 2 (kernel
   6 at the solve's operands first, then block 10 in both layouts and block
   40 transposed; kernel 5 at the f32 CG stage's own operand first); both
   also on a matrix with rows longer than their tile budget, kernel 5 on the
   Hybrid check's CSR remainder; the mask probe against its plain version
   bit for bit; kernels 3 and 4 again at this matrix's n;
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
8. kernels 8 and 9 — the FMA probe (Dekker block bit for bit, block 0 equal
   to the exact error or to zero) and the four modes of the sliced-Gram
   isolation kernel (stated tolerance, equal bits across two launches,
   ``full`` also in runs of one chunk, bit for bit) against their plain
   versions, timed like the others (kernel 9's ``dot`` and ``full`` beside
   ``torch.mm`` of the bf16 stacks with f32 output); then the two
   measurement scripts ``gcge_tpu_torch.benchmarks.df64_push`` and
   ``.pallas_isolate`` through their ``main``, the path that launches these
   kernels;
9. fused solves — the headline with ``fuse=20`` and the irregular problem
   with ``fuse=10`` under the same gates as the phased solves, eigenvalues
   within 1e-9 of the phased solve of this run, kernels 1-6 launched (a
   replay of the captured CG stage counts the kernels it launches); each
   once more with no ``fuse`` given, the chunk length ``solve`` tunes on a
   card;
10. sync check — one fused chunk of the headline problem under
    ``torch.cuda.set_sync_debug_mode("error")``: any wait of the host for the
    device outside ``safe_eigh`` fails the run; after phase 12's AMG
    standard solve, the same for one fused chunk of the AMG-preconditioned
    standard solve (the V-cycle inside the captured f32 CG stage);
11. launch floor — an ``add_`` on a one-element tensor, timed as the kernel
    rows are, beside kernels 7 and 8.
12. multilevel path — the P1 FEM pair on the structured tet mesh of the unit
    cube at nx=54 (n=148,877), assembled once on the host.  AMG standard:
    ``solve(A, None, nev=50, multigrid=True)`` (the mixed f32 stage with the
    V-cycle captured in its graph) against a plain ``solve(A, None,
    nev=50)``; AMG generalized: ``solve(A, B, nev=50, multigrid=True)`` (the
    fused f64 CG with the V-cycle) against a plain ``solve(A, B, nev=50)``;
    PAS: ``solve(A, B, nev=50, method="pas")`` and the composite
    Rayleigh-Ritz (``pas_solve(..., composite_rr=True)`` on the PAS phase's
    hierarchy).  Each prints its hierarchy (n, nnz, layout, longest row and
    host set-up seconds by level), wall, iterations or sweeps and converged
    count, and holds its converged pairs to host residuals of 2e-8 (the
    solver's measure: ``||Ax - lambda Bx|| / |lambda|`` for B-orthonormal x,
    and ``X^T B X = I`` to 1e-10) and its 50 eigenvalues to 1e-9 of the plain
    solve; then kernel 6 at the coarse levels' own operands (rows past its
    tile budget), timed like the other rows.

13. halo kernels — right after phase 2: kernels 1 and 2 on the halo windows
    of the headline operator cut into 4 row blocks of 39,366 rows (hl = hr
    = 2,971, zeros past the ends), contiguous windows of 10 columns (kernel
    2 in the CG stage's (10, nw) / (nw, 10) layout), each against its plain
    version and against the block's rows of the unsharded product, timed
    beside the square product of the same rows; then halo (0, 0) against
    the product on x between zero halos, bit for bit;
14. distributed — a one-rank NCCL group (``parallel.multihost.bootstrap``
    on ``tcp://127.0.0.1:<free port>``, destroyed after the phase): the
    headline problem through ``gcg_solve(shard_operator(op, mesh),
    mesh=mesh)`` by the phased and the fused loop, and the RCM-ordered
    irregular problem through the sharded CSR operator by the phased loop,
    each beside the undistributed solve of the same run: the same converged
    count, eigenvalues within 1e-9, host residuals of 2e-8, kernels 1 and 2
    (5 and 6) launched through the window; the fused one with the
    undistributed fused solve's bits;
15. utils — on the headline fused solve: a checkpoint every 5 iterations,
    reloaded, and a resume from it in fewer iterations (under
    ``profile_dir``, whose trace it checks); ``MemWatch``'s peak;
    ``leak_check`` of a steady-state solve; ``python -m
    gcge_tpu_torch.utils.cli -fem_nx 12`` in a subprocess;
16. distributed multilevel — on a one-rank NCCL group each, right after
    the phase whose hierarchy it shards (no host set-up is paid twice):
    after phase 12's AMG standard solve, ``gcg_solve`` of the sharded
    operator with the parameters ``solve`` tunes on a card and
    ``linear_precond=bamg_preconditioner(shard_hierarchy(hier, mesh))``;
    after the PAS solve, ``pas_solve(shard_hierarchy(hier, mesh))`` with
    ``solve``'s PAS knobs.  Each against the undistributed solve of this
    run: the same iterations (sweeps by level) and converged count,
    eigenvalues within 1e-9, the host residuals of phase 12, kernel 1
    through level 0's window and both sharded transfers
    (``dist_ops.TRANSFERS``) launched; the AMG one also with the V-cycle in
    the captured f32 stage's graph, or the stage eager with the card's
    reason printed.  Each prints whether it has the undistributed solve's
    bits.  Then kernel 6 at the rank-local P rows and P^T columns of level
    0, timed like the other rows.
17. grid — ``parallel.grid_mesh(1, 1)`` on the one-rank NCCL group of
    phases 14 and 16 (one card holds no larger grid): the headline problem
    through ``gcg_solve(shard_operator(op, grid), mesh=grid)`` by the phased
    and the fused loop, right after phase 14's solves with the same
    parameters, and the AMG standard solve on ``shard_hierarchy(hier,
    grid)``, right after phase 16's, each against the undistributed solve
    of this run: its bits, iterations and converged count, kernels 1 and 2
    through the window; walls printed beside the undistributed and the
    row-mesh ones, with whether the f32 CG stage was captured or ran eager.
    The AMG phase also times kernels 1 and 2 at the FEM pair's level-0
    operand (15 diagonals, n=148,877, block 10: ``V[:, 110:120]`` and the
    f32 CG stage's operand), like the other rows.

``--profile`` adds ``torch.profiler`` runs (30 iterations of the irregular
solve and the whole headline solve, each phased and fused; 10 iterations of
each AMG-preconditioned solve and one PAS solve on the FEM pair) and prints
the
device's busy and idle share, the device operations, host launches and host
synchronisations per iteration, the device time by kernel, that of kernels
3 and 4 together, of kernels 1, 2, 5 and 6 and of PyTorch's f32 elementwise
and reduction kernels (the CG stage's); then the
walls of the headline solve, of a short solve and of the irregular solve,
phased and fused in chunks of 20 and 5, taken in turns.

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the package beside this script, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import collections
import contextlib
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

# the card's published peaks (H100 SXM data sheet): device memory rate, the
# f64 tensor-core and f32 rates, both 67 TFLOP/s, and the bf16 tensor-core
# rate, which bounds a product of bf16 values accumulated in f32 (kernel 9's
# slab) whatever unit a kernel runs it on
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = 67e12
PEAK_BF16_FLOP_S = 989e12
HEADLINE_KWARGS = dict(nev=NEV, block_size=BS, max_iter=120, cg_max_iter=30)
# the shape classes a nev=50, block-10 solve gives kernels 3 and 4 (projected
# size 120, 100 Ritz vectors): Gram (p x q) and expand (n x k)(k x q)
GRAM_CLASSES = ((120, 10), (110, 10), (10, 10), (100, 100))
EXPAND_CLASSES = ((120, 100), (120, 10), (110, 10), (10, 10))
HEADLINE_FUSE, IRREGULAR_FUSE = 20, 10

IRREGULAR_KWARGS = dict(nev=NEV, block_size=BS, max_iter=300, cg_max_iter=60,
                        cg_refine=3)
FEM_NX = 54                  # the cube FEM pair: n = (FEM_NX - 1)^3
# solve's PAS defaults, for the composite run on a prebuilt hierarchy
PAS_KWARGS = dict(sweeps_per_level=2, final_sweeps=16, bamg_cycles=8)


def median_ms(torch, fn, reps: int = REPS, flush=None) -> float:
    """Median time of fn() on the card over reps runs, by CUDA events.
    ``flush``: a buffer larger than the L2 cache, read (summed) before each
    timed run.  fn() then finds the cache cold, as a solve's next SpMM does;
    the lines the read evicts are clean, so no write-back of earlier work
    falls inside the timed window (overwriting the buffer instead leaves
    ~50 MB of dirty lines to be written back during fn()).  fn() is queued
    while the card is still busy with the read, so the time between the
    events holds none of the host's launch latency (about 25 microseconds
    when the card waits for the host, as it does without the flush)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.sum()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: float, flops):
    """The least time the card could take, in ms, and what sets it: the
    bytes the function must move (each input read once, each output written
    once) over the memory rate, or its operations over the peak rate of
    their type.  ``flops``: a count at the f64/f32 rate, or ``(count, rate)``
    pairs whose times add."""
    if not isinstance(flops, (list, tuple)):
        flops = [(flops, PEAK_FLOP_S)]
    t_bytes = nbytes / PEAK_BYTES_S
    t_flops = sum(count / rate for count, rate in flops)
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
    Every time is a median of 20 runs, each after a clean flush of the L2
    cache (see :func:`median_ms`)."""

    def __init__(self, torch):
        self.torch = torch
        self.entries = {}
        self.last = {}          # time and bound of the latest run
        self.by_class = {}      # (key, n, p, q) of kernels 3/4: time, bound

    def run(self, key, label, kernel, plain, scale, tol, nbytes, flops,
            library=None, primary=False, cls=None):
        """scale: the error's reference size, a scalar or per entry;
        tol 0 demands equal bits; cls: the key under which ``by_class``
        keeps this run's time and bound."""
        torch = self.torch
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        if tol == 0:
            abs_err = rel = 0.0 if torch.equal(got, ref) else float("inf")
        else:
            diff = (got - ref).abs()
            abs_err = float(diff.max())
            rel = float((diff / scale).max())
        # five times the 50 MB L2 cache, only ever read; freed on return, so
        # that it does not count towards a solve's peak memory
        flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
        ms = median_ms(torch, kernel, flush=flush)
        plain_ms = median_ms(torch, plain, flush=flush)
        lib_ms = None if library is None else \
            median_ms(torch, library, flush=flush)
        back_to_back_ms = median_ms(torch, kernel)
        bound_ms, bound_by = bound(nbytes, flops)
        self.last = {"ms": ms, "bound_ms": bound_ms}
        if cls is not None:
            self.by_class[cls] = dict(self.last, library_ms=lib_ms)
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
    the transposed SpMM, ``(1, m)``: ``(n, m)`` memory, built the way
    ``_mixed_inner_solve`` and ``block_pcg_t`` build their first search
    direction from the f64 residual.  The SpMM returns its product in the
    same order, so every tensor of the stage keeps it; the function checks
    that."""
    r = torch.randn((n, m), generator=gen, dtype=torch.float64,
                    device=DEVICE)
    rt = r.T.float()
    active = torch.ones(m, dtype=torch.bool, device=DEVICE)[:, None]
    res = torch.where(active, rt - apply_t(torch.zeros_like(rt)), 0.0)
    out = torch.where(active, res + 0.0 * torch.zeros_like(res), 0.0)
    if out.stride() != (1, m) or apply_t(out).stride() != (1, m):
        raise AssertionError(f"the CG operand's strides {out.stride()} are "
                             f"not (1, {m})")
    return out


def csr_tensor(torch, a_csr, dtype):
    """A scipy CSR matrix as a torch CSR tensor on the card: the operand of
    the library call timed beside the SpMM kernels, used nowhere in the
    port."""
    return torch.sparse_csr_tensor(
        torch.as_tensor(a_csr.indptr, device=DEVICE),
        torch.as_tensor(a_csr.indices, device=DEVICE),
        torch.as_tensor(a_csr.data, device=DEVICE).to(dtype),
        size=a_csr.shape, check_invariants=False)


def spmm_operand(torch, name, n, dtype, gen):
    """The operand of an SpMM row, as ``(x, transposed)``: a column view of
    a basis as a solve hands it to kernels 1 and 6 (``V[:, 110:120]``, the W
    coupling of every Rayleigh-Ritz step: rows 120 elements apart, on 16
    bytes; ``V[:, :100]``, the initial Rayleigh-Ritz; ``ritz[:, 41:51]``, a
    residual window at an odd offset: rows 8-byte aligned only), a
    contiguous ``(n, m)`` or a contiguous ``(m, n)`` of the transposed
    layout."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=DEVICE)

    if name == "V[:, 110:120]":
        return randn(n, 120)[:, 110:120], False
    if name == "V[:, :100]":
        return randn(n, 120)[:, :100], False
    if name == "ritz[:, 41:51]":
        return randn(n, 100)[:, 41:51], False
    rows, cols = name.strip("()").split(", ")
    if rows == "n":
        return randn(n, int(cols)), False
    return randn(int(rows), n), True


def follows(y, x) -> bool:
    """``y`` lies in the memory order of ``x``: x's strides where x is dense
    (and not a single row or column), else contiguous."""
    dense = x.is_contiguous() or x.T.is_contiguous()
    return y.stride() == x.stride() if dense and min(x.shape) > 1 \
        else y.is_contiguous()


def spmm_rows(torch, log, key, apply, plain, n, nnz, matrix_bytes, lib,
              cases, tol, gen, tag="", n_in=None):
    """An SpMM kernel (``apply(x, transposed)``) against its plain version
    (``plain(x, transposed, absolute)``, on |A| where ``absolute``) and
    beside ``torch.sparse.mm`` on ``lib`` (the same values, in the (n, m)
    layout), for each operand of ``cases`` (:func:`spmm_operand`, or ``cg``:
    the f32 CG stage's, :func:`cg_operand`).  Each row also gives equal bits
    twice and returns its product in the memory order of its operand; its
    bound counts the matrix's bytes, x and y once each.  The first case is
    the primary one where ``tag`` is empty.  ``n_in``: the rows of x where
    the matrix is rectangular (its columns; default ``n``)."""
    dtype = lib.dtype
    item = torch.empty((), dtype=dtype).element_size()
    n_in = n if n_in is None else n_in
    for name in cases:
        if name == "cg":
            x = cg_operand(torch, lambda z: apply(z, True), n_in, BS, gen)
            transposed = True
        else:
            x, transposed = spmm_operand(torch, name, n_in, dtype, gen)
        m = x.shape[0] if transposed else x.shape[1]
        x_nm = x.T.contiguous() if transposed else x.contiguous()
        label = f"{key}{tag} {name} m={m} strides {tuple(x.stride())}"

        def kernel():
            return apply(x, transposed)

        if not follows(kernel(), x):
            raise AssertionError(f"{label}: the product's strides "
                                 f"{kernel().stride()} do not follow x's")
        twice_equal(torch, kernel, label)
        scale = plain(x.abs(), transposed, True).max()
        log.run(key, label, kernel, lambda: plain(x, transposed, False),
                scale, tol, matrix_bytes + (n + n_in) * m * item,
                2.0 * nnz * m,
                library=lambda: torch.sparse.mm(lib, x_nm),
                primary=not tag and name == cases[0])


def launch_counters():
    from gcge_tpu_torch.ops import onehot, osgemm, probes, spmm

    return (spmm.LAUNCHES, osgemm.LAUNCHES, onehot.LAUNCHES, probes.LAUNCHES)


def reset_counters():
    for counters in launch_counters():
        for key in counters:
            counters[key] = 0


def read_counters() -> dict:
    return {k: v for counters in launch_counters()
            for k, v in counters.items()}


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


def phase_fragment_check(torch):
    """One 16 x 8 x 8 tile through the f64 mma of kernels 3 and 4, its
    fragments read straight from device memory, against ``a @ c``; one
    64 x 112 x 64 product through kernel 9's stack layout, descriptors and
    bf16 wgmma against ``a.float() @ b.float().T``: the layouts the kernels
    rely on, checked before any runs."""
    from gcge_tpu_torch.ops import osgemm

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    a = torch.randn((16, 8), generator=gen, dtype=torch.float64,
                    device=DEVICE)
    c = torch.randn((8, 8), generator=gen, dtype=torch.float64,
                    device=DEVICE)
    err = float((osgemm.dmma_tile_check(a, c) - a @ c).abs().max()
                / (a.abs() @ c.abs()).max())
    print(f"f64 mma fragment check (16 x 8 x 8 tile): max error {err:.3e} of "
          f"max |a| |c| (tol 1e-14)")
    if not err <= 1e-14:
        raise AssertionError("the f64 mma fragment layout is wrong")
    # kernel 9's bf16 wgmma: products of bf16 values are exact in f32, 64 of
    # them summed by the tensor cores to within a few units in the last
    # place of the largest partial sum
    from gcge_tpu_torch.ops import probes

    a = torch.randn((64, 64), generator=gen, device=DEVICE).bfloat16()
    b = torch.randn((112, 64), generator=gen, device=DEVICE).bfloat16()
    ref = a.float() @ b.float().T
    err = float((probes.bf16_mma_tile_check(a, b) - ref).abs().max()
                / (a.float().abs() @ b.float().abs().T).max())
    print(f"bf16 wgmma tile check (64 x 112 x 64, kernel 9's layout): max "
          f"error {err:.3e} of max |a| |b| (tol 1e-6)")
    if not err <= 1e-6:
        raise AssertionError("the bf16 wgmma operand or accumulator layout "
                             "is wrong")


def tall_cost(n: int, p: int, q: int):
    """Bytes and operations of one call of kernel 3 (``a^T b``, a (n, p),
    b (n, q)) or kernel 4 (``a c``, a (n, p), c (p, q)): each input read
    once, the output written once; the two move the same bytes."""
    return 8 * (n * p + n * q + p * q), 2.0 * n * p * q


def twice_equal(torch, fn, label):
    """Two launches of ``fn`` give the same bits."""
    if not torch.equal(fn(), fn()):
        raise AssertionError(f"{label}: two launches differ")


def kernels_tall(torch, log, n, gen, primary):
    """Kernels 3 and 4 against their plain versions at every shape class a
    nev=50, block-10 solve of size n gives them, with equal bits across two
    launches.  The tall operands are column views of a basis of 120
    columns, as the solver's are."""
    from gcge_tpu_torch.ops import osgemm

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           device=DEVICE)

    basis = randn(n, 120)
    # kernel 3: tall Gram; error relative to ||a_i|| ||b_j|| per entry
    for p, q in GRAM_CLASSES:
        a, b = basis[:, :p], randn(n, q)
        label = f"tall_gram n={n} ({p}x{q})"
        twice_equal(torch, lambda: osgemm.tall_gram(a, b), label)
        norms = a.norm(dim=0)[:, None] * b.norm(dim=0)[None, :]
        log.run("gram", label, lambda: osgemm.tall_gram(a, b),
                lambda: osgemm.tall_gram_reference(a, b), norms, 1e-13,
                *tall_cost(n, p, q), library=lambda: a.T @ b,
                primary=primary and (p, q) == (120, 10),
                cls=("gram", n, p, q))
    # kernel 4: tall expand; error relative to max (|a| |c|)
    for k, q in EXPAND_CLASSES:
        a, c = basis[:, :k], randn(k, q)
        label = f"tall_expand n={n} (n x {k})({k} x {q})"
        twice_equal(torch, lambda: osgemm.tall_expand(a, c), label)
        log.run("expand", label, lambda: osgemm.tall_expand(a, c),
                lambda: osgemm.tall_expand_reference(a, c),
                (a.abs() @ c.abs()).max(), 1e-13,
                *tall_cost(n, k, q), library=lambda: a @ c,
                primary=primary and (k, q) == (120, 100),
                cls=("expand", n, k, q))


def tall_host_cost(torch):
    """Host time of one call with the card idle (64 rows, 1,000 calls):
    each tall-GEMM wrapper beside the one PyTorch call for the same
    function.  The solves are bound by the host, so this is what a call
    costs them."""
    from gcge_tpu_torch.ops import osgemm

    a = torch.randn((64, 120), dtype=torch.float64, device=DEVICE)
    b = a[:, :10].contiguous()
    c = a[:10].T.contiguous()
    costs = []
    for name, fn in (("tall_gram", lambda: osgemm.tall_gram(a, b)),
                     ("a.T @ b", lambda: a.T @ b),
                     ("tall_expand", lambda: osgemm.tall_expand(a, c)),
                     ("a @ c", lambda: a @ c)):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        costs.append(f"{name} {1e3 * (time.perf_counter() - t0):.1f} us")
        torch.cuda.synchronize()
    print("host time a call (64 rows, the card idle): " + ", ".join(costs))


class TallCalls:
    """Counts the calls of kernels 3 and 4 by shape class, and the
    iterations, of the solves run inside it: the wrappers (where
    ``osgemm``, ``orth`` and ``gcg`` reach them) and ``gcg_solve`` (where
    ``solve`` reaches it) are wrapped for its duration."""

    def __init__(self):
        self.calls = collections.Counter()
        self.iterations = 0

    def __enter__(self):
        from gcge_tpu_torch import api
        from gcge_tpu_torch.ops import osgemm
        from gcge_tpu_torch.solvers import gcg

        gram, expand = osgemm.tall_gram, osgemm.tall_expand
        solve = api.gcg_solve

        def counted_gram(a, b):
            self.calls["gram", a.shape[1], b.shape[1]] += 1
            return gram(a, b)

        def counted_expand(a, c):
            self.calls["expand", a.shape[1], c.shape[1]] += 1
            return expand(a, c)

        def counted_solve(*args, **kwargs):
            res = solve(*args, **kwargs)
            self.iterations += res.num_iter
            return res

        self.saved = [(m, name, getattr(m, name)) for m, name in (
            (osgemm, "tall_gram"), (osgemm, "tall_expand"),
            (gcg, "tall_gram"), (gcg, "tall_expand"), (api, "gcg_solve"))]
        for m in (osgemm, gcg):
            m.tall_gram, m.tall_expand = counted_gram, counted_expand
        api.gcg_solve = counted_solve
        return self

    def __exit__(self, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)

    def report(self, tag: str, log, n: int) -> None:
        """Calls an iteration by shape class, and the sums of time x calls
        and of bound x calls an iteration over the classes the kernel phase
        timed at this n."""
        iters = max(self.iterations, 1)
        total = sum(self.calls.values())
        grams = sum(v for k, v in self.calls.items() if k[0] == "gram")
        t_sum = b_sum = 0.0
        timed = 0
        for (kind, p, q), count in self.calls.items():
            entry = log.by_class.get((kind, n, p, q))
            if entry is not None:
                t_sum += entry["ms"] * count
                b_sum += entry["bound_ms"] * count
                timed += count
        shapes = ", ".join(f"{kind} ({p}x{q}) {count / iters:.2f}"
                           for (kind, p, q), count in sorted(
                               self.calls.items()))
        print(f"{tag}: kernels 3/4 over {self.iterations} iterations: "
              f"{grams / iters:.2f} Grams and {(total - grams) / iters:.2f} "
              f"expands an iteration ({shapes}); the timed classes "
              f"({timed} of {total} calls): time x calls {t_sum / iters:.4f}"
              f" ms an iteration against bound x calls {b_sum / iters:.4f} "
              f"ms")


def phase_kernels_headline(torch, log, rows, cols, vals, n):
    """Kernels 1-4 against their plain versions at the headline shapes."""
    import scipy.sparse as sps

    from gcge_tpu_torch import make_operator
    from gcge_tpu_torch.ops import spmm

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    op = make_operator(rows, cols, vals, (n, n), device=dev)
    v64, offs = op.values, op.offsets_t
    v32 = v64.float()
    a_csr = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    lib64 = csr_tensor(torch, a_csr, torch.float64)
    lib32 = csr_tensor(torch, a_csr, torch.float32)
    ndiag = v64.shape[0]

    def dia(values):
        return (lambda x, t: spmm.dia_spmm(values, offs, x, t),
                lambda x, t, absolute: spmm.dia_spmm_reference(
                    values.abs() if absolute else values, offs, x, t))

    # kernel 1: f64 DIA; error relative to max (|A| |x|).  Primary: the W
    # coupling's column view of V, then the solve's other operands and the
    # other layouts
    spmm_rows(torch, log, "dia_f64", *dia(v64), n, a_csr.nnz,
              8 * ndiag * n + 4 * ndiag, lib64,
              ["V[:, 110:120]", "ritz[:, 41:51]", "V[:, :100]", "(n, 10)",
               "(10, n)", "(100, n)"], 1e-14, gen)
    # kernel 2: f32 DIA.  Primary: the operand the mixed inner CG hands it,
    # (m, n) with strides (1, m); besides, a contiguous (m, n) operand and
    # the (n, m) layout
    spmm_rows(torch, log, "dia_f32", *dia(v32), n, a_csr.nnz,
              4 * ndiag * n + 4 * ndiag, lib32,
              ["cg", f"({BS}, n)", f"(n, {BS})"], 1e-5, gen)
    kernels_tall(torch, log, n, gen, primary=True)
    tall_host_cost(torch)


def phase_headline(torch, log, a_csr, fuse: int, ev_phased=None):
    """The headline solve through the public entry point, by the phased loop
    (``fuse=0``) or the fused one; the fused solve is also held against the
    phased solve's eigenvalues.  Returns ``(launches, eigenvalues)``."""
    import gcge_tpu_torch
    from gcge_tpu_torch.io.stencil import smallest_eigs_3d27
    from gcge_tpu_torch.solvers import gcg

    tag = "headline" if fuse == 0 else f"fused headline (fuse={fuse})"
    kwargs = dict(HEADLINE_KWARGS, device=DEVICE, fuse=fuse)
    if fuse == 0:
        # the first solve in the process also pays the one-time set-up of
        # the CUDA libraries (cuBLAS, cuSOLVER handles); the second is the
        # one checked and counted
        t0 = time.perf_counter()
        gcge_tpu_torch.solve(a_csr, None, verbose=0, **kwargs)
        torch.cuda.synchronize()
        print(f"headline: first solve in the process "
              f"{time.perf_counter() - t0:.3f} s")
    reset_counters()
    gcg.GRAPH_REPLAYS["cg_stage"] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with TallCalls() as tall:
        ev, evec, nev_conv = gcge_tpu_torch.solve(a_csr, None, verbose=1,
                                                  **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    tall.report(tag, log, a_csr.shape[0])
    print(f"{tag}: wall {wall:.3f} s, nev_conv {nev_conv}, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {launches} (a replay of the captured CG stage counts "
          f"the kernels it launches), replays {gcg.GRAPH_REPLAYS['cg_stage']}")
    if nev_conv < NEV:
        raise AssertionError(f"nev_conv {nev_conv} < {NEV}")
    exact = smallest_eigs_3d27(NX, NEV)
    ev_err = float(np.max(np.abs(ev[:NEV] - exact) / np.abs(exact)))
    res = residuals(a_csr, ev[:NEV], evec[:, :NEV].cpu().numpy())
    print(f"{tag}: eigenvalues vs closed form max rel err {ev_err:.3e} "
          f"(tol 1e-9); host residuals max {res.max():.3e} (tol 2e-8)")
    if not ev_err <= 1e-9:
        raise AssertionError(f"eigenvalue error {ev_err:.3e} > 1e-9")
    if not res.max() <= 2e-8:
        raise AssertionError(f"residual {res.max():.3e} > 2e-8")
    idle = [k for k in ("dia_f64", "dia_f32", "gram", "expand")
            if launches[k] <= 0]
    if idle:
        raise AssertionError(f"kernels not launched by the solve: {idle}")
    if fuse > 0:
        rel = float(np.max(np.abs(ev[:NEV] - ev_phased[:NEV])
                           / np.abs(ev_phased[:NEV])))
        print(f"{tag}: eigenvalues vs the phased solve max rel diff "
              f"{rel:.3e} (tol 1e-9)")
        if not rel <= 1e-9:
            raise AssertionError("the fused solve disagrees with the phased")
        if gcg.GRAPH_REPLAYS["cg_stage"] <= 0:
            raise AssertionError("the CG stage was not replayed from a graph")
        # the same with no ``fuse`` given: the chunk length ``solve`` tunes
        t0 = time.perf_counter()
        ev_tuned, _, conv_tuned = gcge_tpu_torch.solve(
            a_csr, None, verbose=0, device=DEVICE, **HEADLINE_KWARGS)
        torch.cuda.synchronize()
        print(f"fused headline (the default of solve on a card): wall "
              f"{time.perf_counter() - t0:.3f} s, nev_conv {conv_tuned}")
        if conv_tuned != nev_conv or not np.array_equal(ev_tuned, ev):
            raise AssertionError("the chunk length changes the result")
    return launches, ev


def phase_walls(torch, a_csr, a):
    """Walls in turns in one process on one card, phased and fused in chunks
    of 20 and 5: what the default ``fuse`` of ``solve`` on a card rests on.
    The headline solve, a short solve of the same matrix (nev=10: a chunk's
    discarded iterations weigh most there), and the irregular solve at the
    chunk length that the checked solves do not run."""
    import gcge_tpu_torch

    turns = (0, HEADLINE_FUSE, 5, 5, HEADLINE_FUSE, 0) * 2
    for tag, kwargs in (("headline", HEADLINE_KWARGS),
                        ("short (nev=10)", dict(HEADLINE_KWARGS, nev=10))):
        walls = {}
        for fuse in turns:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gcge_tpu_torch.solve(a_csr, None, verbose=0, device=DEVICE,
                                 fuse=fuse, **kwargs)
            torch.cuda.synchronize()
            walls.setdefault(fuse, []).append(time.perf_counter() - t0)
        print(f"{tag} walls in turns {turns}: " + "; ".join(
            f"fuse={fuse}: " + ", ".join(f"{w:.4f}" for w in ws)
            + f" s (median {np.median(ws):.4f})"
            for fuse, ws in walls.items()))
    for fuse in (5, 0, 5):
        t0 = time.perf_counter()
        _, _, conv = gcge_tpu_torch.solve(
            a, None, device=DEVICE, rcm=True, verbose=0, fuse=fuse,
            **IRREGULAR_KWARGS)
        torch.cuda.synchronize()
        print(f"irregular wall, fuse={fuse}: {time.perf_counter() - t0:.3f} "
              f"s, nev_conv {conv}")


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


def csr_rows(torch, log, key, op, vals, a_csr, cases, tol, gen, tag=""):
    """Kernel 5 or 6 (by the dtype of ``vals``) on the CSR operator ``op``
    in its own plan: :func:`spmm_rows` with the library call on the scipy
    matrix ``a_csr``."""
    from gcge_tpu_torch.ops import onehot

    rowptr, colidx, plan = op.rowptr, op.colidx, op.plan
    nnz = int(vals.shape[0])
    spmm_rows(
        torch, log, key,
        lambda x, t: onehot.csr_spmm(rowptr, colidx, vals, x, t, plan),
        lambda x, t, absolute: onehot.csr_spmm_reference(
            rowptr, colidx, vals.abs() if absolute else vals, x, t),
        op.shape[0], nnz,
        nnz * (4 + vals.element_size()) + 4 * (op.shape[0] + 1),
        csr_tensor(torch, a_csr, vals.dtype), cases, tol, gen, tag,
        n_in=op.shape[1])


def phase_kernels_irregular(torch, log, a_rcm):
    """Kernels 5-7, and kernels 3 and 4 again, against their plain versions
    at the irregular solve's shapes (n = 250,047 is odd: the tall kernels'
    last chunk is a partial one).  Returns the operator ``make_operator``
    picked."""
    import scipy.sparse as sps

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
    # kernel 6 (f64) and kernel 5 (f32); error relative to max (|A| |x|).
    # Primary: kernel 6 at the W coupling's column view of V, kernel 5 at the
    # f32 CG stage's own operand
    csr_rows(torch, log, "csr_f64", op, op.values, a_rcm,
             ["V[:, 110:120]", "ritz[:, 41:51]", "V[:, :100]", "(n, 10)",
              "(10, n)", "(40, n)"], 1e-14, gen)
    csr_rows(torch, log, "csr_f32", op, op.values.float(), a_rcm,
             ["cg", "(n, 10)", "(10, n)", "(40, n)"], 1e-5, gen)
    # kernels 6 and 5 at rows longer than their tile budget: 50,000 rows of
    # 0 to 11 entries (every 997th empty) and three of 3,000, 5,000 and
    # 20,000
    rng = np.random.default_rng(3)
    n2 = 50_000
    deg = rng.integers(0, 12, n2)
    deg[::997] = 0
    deg[[5, 777, 40_000]] = [5_000, 20_000, 3_000]
    rows = np.repeat(np.arange(n2), deg)
    long_rows = sps.coo_matrix(
        (rng.standard_normal(len(rows)), (rows, rng.integers(0, n2, len(rows)))),
        shape=(n2, n2)).tocsr()
    coo2 = long_rows.tocoo()
    op2 = onehot.CsrOperator.from_coo(coo2.row, coo2.col, coo2.data,
                                      (n2, n2), device=dev)
    tiles = op2.plan.tiles.cpu().numpy()
    if not (np.diff(tiles) == 1).sum() >= 3:
        raise AssertionError("the long rows do not have tiles of their own")
    tag = f" long rows (max {deg.max()}, budget {onehot.CSR_BUDGET})"
    csr_rows(torch, log, "csr_f64", op2, op2.values, long_rows,
             ["V[:, 110:120]"], 1e-14, gen, tag)
    csr_rows(torch, log, "csr_f32", op2, op2.values.float(), long_rows,
             ["cg", "(n, 16)"], 1e-5, gen, tag)
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


def phase_hybrid(torch, log):
    """A Hybrid operator on the card: 13 full diagonals plus 20,000 scattered
    outliers at n=50,000, applied in f64 and f32 against scipy; then kernel 5
    on its CSR remainder alone (most rows empty, the rest short)."""
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
    rest = op.rest
    rest_csr = sps.csr_matrix((rest.values.cpu().numpy(),
                               rest.colidx.cpu().numpy(),
                               rest.rowptr.cpu().numpy()), shape=rest.shape)
    csr_rows(torch, log, "csr_f32", rest, rest.values.float(), rest_csr,
             ["cg"], 1e-5, torch.Generator(device=DEVICE).manual_seed(2),
             f" hybrid remainder ({rest.nnz} entries)")


def phase_irregular(torch, log, a, a_rcm):
    """The irregular solve through the public entry point, checked, and
    compared with a solve on the plain gather route."""
    import gcge_tpu_torch
    from gcge_tpu_torch import SparseOperator

    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with TallCalls() as tall:
        ev, evec, nev_conv = gcge_tpu_torch.solve(
            a, None, device=DEVICE, rcm=True, verbose=1, fuse=0,
            **IRREGULAR_KWARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    tall.report("irregular", log, a.shape[0])
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
        ell, None, device=DEVICE, verbose=0, fuse=0, **IRREGULAR_KWARGS)
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
    return launches, ev


def phase_irregular_fused(torch, log, a, ev_phased):
    """The irregular solve by the fused loop, under the phased solve's gates
    and against its eigenvalues."""
    import gcge_tpu_torch
    from gcge_tpu_torch.solvers import gcg

    tag = f"fused irregular (fuse={IRREGULAR_FUSE})"
    reset_counters()
    gcg.GRAPH_REPLAYS["cg_stage"] = 0
    t0 = time.perf_counter()
    with TallCalls() as tall:
        ev, evec, nev_conv = gcge_tpu_torch.solve(
            a, None, device=DEVICE, rcm=True, verbose=1,
            fuse=IRREGULAR_FUSE, **IRREGULAR_KWARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    tall.report(tag, log, a.shape[0])
    res = residuals(a, ev[:NEV], evec[:, :NEV].cpu().numpy())
    rel = float(np.max(np.abs(ev[:NEV] - ev_phased[:NEV])
                       / np.abs(ev_phased[:NEV])))
    print(f"{tag}: wall {wall:.3f} s (host RCM and packing included), "
          f"nev_conv {nev_conv}, host residuals max {res.max():.3e} (tol "
          f"2e-8), eigenvalues vs the phased solve max rel diff {rel:.3e} "
          f"(tol 1e-9), launches {launches} (a replay of the captured CG "
          f"stage counts the kernels it launches), replays "
          f"{gcg.GRAPH_REPLAYS['cg_stage']}")
    if nev_conv < NEV:
        raise AssertionError(f"nev_conv {nev_conv} < {NEV}")
    if not res.max() <= 2e-8:
        raise AssertionError(f"residual {res.max():.3e} > 2e-8")
    if not rel <= 1e-9:
        raise AssertionError("the fused solve disagrees with the phased")
    idle = [k for k in ("gram", "expand", "csr_f32", "csr_f64")
            if launches[k] <= 0]
    if idle:
        raise AssertionError(f"kernels not launched by the solve: {idle}")
    if gcg.GRAPH_REPLAYS["cg_stage"] <= 0:
        raise AssertionError("the CG stage was not replayed from a graph")
    # the same with no ``fuse`` given: the chunk length ``solve`` tunes
    t0 = time.perf_counter()
    _, _, conv_tuned = gcge_tpu_torch.solve(
        a, None, device=DEVICE, rcm=True, verbose=0, **IRREGULAR_KWARGS)
    torch.cuda.synchronize()
    print(f"fused irregular (the default of solve on a card): wall "
          f"{time.perf_counter() - t0:.3f} s, nev_conv {conv_tuned}")
    if conv_tuned != nev_conv:
        raise AssertionError("fuse changes the converged count")
    return launches


def phase_kernels_probes(torch, log):
    """Kernels 8 and 9 against their plain versions at the shapes of their
    measurement scripts."""
    from gcge_tpu_torch.benchmarks.pallas_isolate import make_planes
    from gcge_tpu_torch.ops import _build, probes

    rng = np.random.default_rng(0)
    rows, cols = probes.PROBE_SHAPE
    a = torch.as_tensor((rng.standard_normal((rows, cols)) * 1.7)
                        .astype(np.float32), device=DEVICE)
    b = torch.as_tensor((rng.standard_normal((rows, cols)) * 0.3)
                        .astype(np.float32), device=DEVICE)
    # kernel 8: the Dekker block bit for bit; block 0 is the exact error
    # (the compiler fused a*b - p into one FMA) or zero (it did not)
    got, ref = probes.fma_probe_blocks(a, b), probes.fma_probe_plain(a, b)
    fused = torch.equal(got[:rows], ref[:rows])
    if not fused and bool((got[:rows] != 0).any()):
        raise AssertionError("fma_probe: a*b - p is neither the exact error "
                             "nor zero")
    print(f"kernel fma_probe: a*b - p is "
          f"{'the exact error: fused into one FMA' if fused else 'zero: not fused'}"
          f"; nonzero Dekker errors "
          f"{int(torch.count_nonzero(got[rows:]))}/{rows * cols}")
    held = slice(None) if fused else slice(rows, None)
    log.run("fma_probe", "fma_probe (8, 128)",
            lambda: probes.fma_probe_blocks(a, b)[held],
            lambda: probes.fma_probe_plain(a, b)[held], 1.0, 0,
            4 * 4 * rows * cols, 19 * rows * cols, primary=True)

    # kernel 9 at P = 128, Q = 16, n = 157,464 in chunks of 1024.  The bound
    # takes the peel's f32 operations at the f32 rate and the slab product
    # (bf16 values, f32 sums) at the bf16 tensor-core rate, the card's peak
    # for that type.  Tolerance 1e-5 of the largest entry of the plain slab:
    # both sum exact products of bf16 values in f32, the kernel a chunk's
    # 1024 in another order than the plain matrix product (`dot`, `none`).
    # With 7-bit slices (`full`) the chunk sums are exact, so `full` must
    # give the bits of the plain version summed in the kernel's runs: most
    # of the slab's blocks lie far below 1e-5 of its largest entry, and only
    # equal bits hold them.  The line also says whether the bits equal the
    # plain version's in the TPU kernel's order of chunk adds.  The library
    # call is one torch.mm of the bf16 stacks with f32 output, built once
    # outside the timing: the product only, without the peel.
    p_rows, q_rows, nr = 128, 16, 1024
    planes = make_planes(p_rows, q_rows, NX ** 3, nr, DEVICE)
    n_pad = planes[0].shape[1]
    run = probes.slice_gram_plan(p_rows, q_rows, n_pad, nr,
                                 _build.sm_count(planes[0].device)).run
    nbytes = 8 * (p_rows + q_rows) * n_pad + 4 * 49 * p_rows * q_rows
    peel_flops = 27.0 * (p_rows + q_rows) * n_pad
    dot_flops = 2.0 * 49 * p_rows * q_rows * n_pad
    for mode in probes.MODES:
        first = probes.slice_gram(*planes, mode=mode, nr=nr)
        again = probes.slice_gram(*planes, mode=mode, nr=nr)
        ref = probes.slice_gram_plain(*planes, mode=mode, nr=nr)
        if not torch.equal(first, again):
            raise AssertionError(f"slice_gram {mode}: two launches differ")
        in_runs = torch.equal(first, probes.slice_gram_plain(
            *planes, mode=mode, nr=nr, run=run))
        print(f"kernel slice_gram {mode}: two launches equal bits; bits "
              f"equal to the plain version: {torch.equal(first, ref)} in the "
              f"TPU kernel's order of chunk adds, {in_runs} in the kernel's "
              f"runs of {run} chunks")
        if mode == "full" and not in_runs:
            raise AssertionError(f"slice_gram full: bits differ from the "
                                 f"plain version summed in runs of {run} "
                                 "chunks")
        flops = [(peel_flops if mode in ("peel", "full") else 0.0,
                  PEAK_FLOP_S),
                 (dot_flops if mode in ("dot", "full") else 0.0,
                  PEAK_BF16_FLOP_S)]
        library = None
        if mode in ("dot", "full"):
            sa, sb = probes.stacks(*planes, mode=mode)

            def library():
                return torch.mm(sa, sb.T, out_dtype=torch.float32)

        log.run("slice_gram", f"slice_gram {mode} P={p_rows} Q={q_rows} "
                f"n_pad={n_pad} (runs of {run} chunks)",
                lambda: probes.slice_gram(*planes, mode=mode, nr=nr),
                lambda: probes.slice_gram_plain(*planes, mode=mode, nr=nr),
                ref.abs().max().clamp(min=1.0), 1e-5, nbytes, flops,
                library=library, primary=(mode == "full"))
        entry = log.last
        if mode in ("dot", "full"):
            print(f"kernel slice_gram {mode}: the slab's {dot_flops:.4g} "
                  f"operations take {1e3 * dot_flops / PEAK_BF16_FLOP_S:.4f} "
                  f"ms at the bf16 tensor-core rate; {entry['ms']:.4f} ms is "
                  f"{entry['ms'] / entry['bound_ms']:.2f} times the bound; "
                  f"the library call (torch.mm of the stacks, f32 out) is "
                  f"the product only, without the peel")
        if mode in ("none", "peel") and entry["ms"] < entry["bound_ms"]:
            raise AssertionError(
                f"slice_gram {mode}: {entry['ms']:.4f} ms is below the "
                f"{entry['bound_ms']:.4f} ms its loads need: the compiler "
                "removed the work")


def phase_scripts():
    """This slice's own path: the two kernel measurement scripts through
    their entry points, at their defaults (the TPU scripts' shapes)."""
    from gcge_tpu_torch.benchmarks import df64_push, pallas_isolate

    reset_counters()
    for mod in (df64_push, pallas_isolate):
        print(f"--- python3 -m {mod.__name__} --device {DEVICE}")
        if mod.main(["--device", DEVICE]) != 0:
            raise AssertionError(f"{mod.__name__} failed")
    launches = read_counters()
    print(f"measurement scripts: launches {launches}")
    idle = [k for k in ("fma_probe", "slice_gram", "dia_f64")
            if launches[k] <= 0]
    if idle:
        raise AssertionError(f"kernels not launched by the scripts: {idle}")
    return launches


def phase_sync_check(torch, label, run, steps: int = 5):
    """One fused chunk of ``steps`` iterations (``run(steps)`` solves with
    ``fuse=steps, max_iter=steps``) with every wait of the host for the
    device turned into an error.  ``safe_eigh`` lifts the mode for its own
    waits (cuSOLVER's info, the NaN flag) and counts its calls."""
    from gcge_tpu_torch.ops import eighs
    from gcge_tpu_torch.solvers import gcg

    chunk = gcg._gcg_chunk
    chunks = []

    def strict_chunk(*args, **kwargs):
        before = eighs.CALLS["safe_eigh"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = chunk(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        chunks.append(eighs.CALLS["safe_eigh"] - before)
        return out

    gcg._gcg_chunk = strict_chunk
    try:
        run(steps)
    finally:
        gcg._gcg_chunk = chunk
    torch.cuda.synchronize()
    print(f"sync check ({label}): {len(chunks)} fused chunk of {steps} "
          f"iterations under set_sync_debug_mode('error'): no wait outside "
          f"safe_eigh, which was called {chunks[-1]} times inside it")
    if len(chunks) != 1 or chunks[-1] <= 0:
        raise AssertionError("the sync check did not run one fused chunk")


def sync_check_headline(torch, a_csr):
    import gcge_tpu_torch

    phase_sync_check(torch, "headline", lambda steps: gcge_tpu_torch.solve(
        a_csr, None, verbose=0, **dict(HEADLINE_KWARGS, device=DEVICE,
                                       fuse=steps, max_iter=steps)))


# --------------------------------------------------------------------------
# the multilevel path: the cube FEM pair
# --------------------------------------------------------------------------


def build_fem(nx: int):
    """The P1 FEM pair (stiffness A, mass B) on the structured tet mesh of
    the unit cube, interior vertices, as scipy CSR matrices on the host."""
    import scipy.sparse as sps

    from gcge_tpu_torch.io.fem import cube_fem_laplacian

    t0 = time.perf_counter()
    rows, cols, av, bv, n = cube_fem_laplacian(nx)
    a = sps.coo_matrix((av, (rows, cols)), shape=(n, n)).tocsr()
    b = sps.coo_matrix((bv, (rows, cols)), shape=(n, n)).tocsr()
    print(f"FEM pair (cube, nx={nx}): n={n} nnz={a.nnz} "
          f"({np.diff(a.indptr).max()} a row at most); host assembly "
          f"{time.perf_counter() - t0:.1f} s")
    if n != (nx - 1) ** 3:
        raise AssertionError(f"n = {n}, expected {(nx - 1) ** 3}")
    return a, b


def op_rows(op):
    """``(nonzeros, longest row)`` of a port operator, counted on its
    device (DIA storage holds explicit zeros, which are not counted)."""
    from gcge_tpu_torch import DiaOperator, HybridOperator

    if isinstance(op, HybridOperator):
        per_row = (op.dia.values != 0).sum(dim=0)
        if op.rest is not None:
            per_row = per_row + (op.rest.rowptr[1:] - op.rest.rowptr[:-1])
    elif isinstance(op, DiaOperator):
        per_row = (op.values != 0).sum(dim=0)
    else:
        per_row = op.rowptr[1:] - op.rowptr[:-1]
    return int(per_row.sum()), int(per_row.max())


def layout(op) -> str:
    from gcge_tpu_torch import DiaOperator, HybridOperator

    if isinstance(op, HybridOperator):
        return (f"Hybrid ({len(op.dia.offsets)} diagonals + CSR "
                f"{op_rows(op.rest)[0] if op.rest is not None else 0})")
    if isinstance(op, DiaOperator):
        return f"DIA ({len(op.offsets)} diagonals)"
    return type(op).__name__


def print_hierarchy(tag, hier, wall):
    """Each level's n, nnz, layout and longest row, the transfers', and the
    host set-up seconds by level."""
    print(f"{tag}: hierarchy of {hier.num_levels} levels, host set-up "
          f"{wall:.2f} s")
    for i, (lv, t) in enumerate(zip(hier.levels, hier.setup)):
        nnz, longest = op_rows(lv.a_op)
        line = (f"{tag}:   level {i}: n={lv.a_op.shape[0]} nonzeros {nnz} "
                f"longest row {longest}, A as {layout(lv.a_op)}")
        if lv.b_op is not None:
            line += f", B as {layout(lv.b_op)}"
        if lv.p_op is not None:
            p_nnz, p_long = op_rows(lv.p_op)
            _, r_long = op_rows(lv.r_op)
            line += (f"; P {tuple(lv.p_op.shape)} as CSR, {p_nnz} nonzeros, "
                     f"rows up to {p_long}, R rows up to {r_long}")
        line += (f"; host aggregate {t['aggregate']:.2f} s, Galerkin "
                 f"{t['galerkin']:.2f} s, placing {t['place']:.2f} s")
        print(line)


class Captured:
    """Records, for its duration, the hierarchies ``solve`` builds (with
    their walls), the f32 CG stages ``gcg_solve`` builds, and the results of
    ``gcg_solve`` and ``pas_solve`` as ``solve`` reaches them."""

    def __enter__(self):
        from gcge_tpu_torch import api
        from gcge_tpu_torch.solvers import gcg, multigrid

        self.hiers, self.stages, self.results = [], [], []
        build, stage_cls = multigrid.build_hierarchy, gcg._MixedStage
        gcg_solve, pas_solve = api.gcg_solve, api.pas_solve
        outer = self

        def build_hierarchy(*args, **kwargs):
            t0 = time.perf_counter()
            hier = build(*args, **kwargs)
            outer.hiers.append((hier, time.perf_counter() - t0))
            return hier

        class Stage(stage_cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                outer.stages.append(self)

        def recorded(fn):
            def run(*args, **kwargs):
                res = fn(*args, **kwargs)
                outer.results.append(res)
                return res
            return run

        self.saved = [(multigrid, "build_hierarchy", build),
                      (gcg, "_MixedStage", stage_cls),
                      (api, "gcg_solve", gcg_solve),
                      (api, "pas_solve", pas_solve)]
        multigrid.build_hierarchy = build_hierarchy
        gcg._MixedStage = Stage
        api.gcg_solve = recorded(gcg_solve)
        api.pas_solve = recorded(pas_solve)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def fem_gates(tag, a, b, ev, evec, count, ev_plain):
    """Host checks of a multilevel solve: the first ``count`` pairs' residuals
    in the solver's measure (standard: ||Ax - lambda x|| / (|lambda| ||x||);
    generalized: ||Ax - lambda Bx|| / |lambda| for B-orthonormal x, with
    X^T B X = I to 1e-10) at most 2e-8, and all NEV eigenvalues within 1e-9
    of the plain solve's."""
    x = evec[:, :NEV].cpu().numpy()
    lam = ev[:NEV]
    if b is None:
        res = residuals(a, lam, x)
        orth = 0.0
    else:
        bx = b @ x
        res = np.linalg.norm(a @ x - bx * lam[None, :], axis=0) / np.abs(lam)
        orth = float(np.abs(x.T @ bx - np.eye(NEV)).max())
    rel = float(np.max(np.abs(lam - ev_plain[:NEV]) / np.abs(ev_plain[:NEV])))
    worst = float(res[:count].max()) if count else 0.0
    print(f"{tag}: host residuals of the first {count} pairs max "
          f"{worst:.3e} (tol 2e-8; all {NEV}: max {res.max():.3e}), "
          f"X^T B X - I max {orth:.3e} (tol 1e-10), eigenvalues vs the "
          f"plain solve max rel diff {rel:.3e} (tol 1e-9)")
    if not worst <= 2e-8:
        raise AssertionError(f"{tag}: residual {worst:.3e} > 2e-8")
    if not orth <= 1e-10:
        raise AssertionError(f"{tag}: X^T B X - I = {orth:.3e} > 1e-10")
    if not rel <= 1e-9:
        raise AssertionError(f"{tag}: eigenvalues disagree with the plain "
                             f"solve ({rel:.3e})")


def phase_amg(torch, log, a, b):
    """``solve(A, B, nev=50, multigrid=True)`` (B None: standard) against a
    plain ``solve(A, B, nev=50)`` on the same pair, both with ``solve``'s
    defaults on a card.  Returns ``(launches, hierarchy, the plain solve's
    eigenvalues, the multigrid solve's GCGResult)``."""
    import gcge_tpu_torch
    from gcge_tpu_torch.solvers import gcg

    tag = "AMG standard" if b is None else "AMG generalized"
    t0 = time.perf_counter()
    with Captured() as plain:
        ev_plain, _, conv_plain = gcge_tpu_torch.solve(
            a, b, nev=NEV, device=DEVICE, verbose=0)
    torch.cuda.synchronize()
    print(f"{tag}: plain solve (no multigrid) wall "
          f"{time.perf_counter() - t0:.3f} s, {plain.results[0].num_iter} "
          f"iterations, nev_conv {conv_plain}")
    reset_counters()
    gcg.GRAPH_REPLAYS["cg_stage"] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with TallCalls() as tall, Captured() as cap:
        ev, evec, nev_conv = gcge_tpu_torch.solve(
            a, b, nev=NEV, multigrid=True, device=DEVICE, verbose=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    (hier, setup), = cap.hiers
    res, = cap.results
    print_hierarchy(tag, hier, setup)
    tall.report(tag, log, a.shape[0])
    print(f"{tag}: wall {wall:.3f} s (host set-up {setup:.2f} s included), "
          f"{res.num_iter} iterations, nev_conv {nev_conv}, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {launches}, replays {gcg.GRAPH_REPLAYS['cg_stage']}")
    if nev_conv < NEV:
        raise AssertionError(f"{tag}: nev_conv {nev_conv} < {NEV}")
    fem_gates(tag, a, b, ev, evec, NEV, ev_plain)
    want = ("dia_f64", "gram", "expand", "csr_f64") + \
        (("dia_f32",) if b is None else ())
    idle = [k for k in want if launches[k] <= 0]
    if idle:
        raise AssertionError(f"{tag}: kernels not launched: {idle}")
    if b is None:
        # the V-cycle inside the captured f32 stage: its graph holds
        # kernel 1 (the fine level) and kernel 6 (coarse levels, transfers)
        stage, = cap.stages
        in_graph = {k: v for counts in stage._launches
                    for k, v in counts.items() if v}
        print(f"{tag}: the captured f32 CG stage launches {in_graph} a "
              f"replay")
        if gcg.GRAPH_REPLAYS["cg_stage"] <= 0 or stage.graph is None:
            raise AssertionError(f"{tag}: the CG stage was not replayed "
                                 "from a graph")
        if not (in_graph.get("dia_f64") and in_graph.get("csr_f64")):
            raise AssertionError(f"{tag}: the V-cycle is not in the graph")
    elif cap.stages:
        raise AssertionError(f"{tag}: a non-diagonal B built an f32 stage")
    return launches, hier, ev_plain, res


def phase_pas(torch, a, b, ev_plain):
    """``solve(A, B, nev=50, method="pas")``, then ``pas_solve(...,
    composite_rr=True)`` on the hierarchy that solve built, each against the
    plain generalized solve's eigenvalues ``ev_plain``.  Returns the
    launches of both, the hierarchy and the first solve's PASResult."""
    import gcge_tpu_torch
    from gcge_tpu_torch.solvers.pas import pas_solve

    out = {}
    hier = first = None
    for tag in ("PAS", "PAS composite"):
        reset_counters()
        t0 = time.perf_counter()
        with Captured() as cap:
            if hier is None:
                ev, evec, nev_conv = gcge_tpu_torch.solve(
                    a, b, nev=NEV, method="pas", device=DEVICE, verbose=1)
                (hier, setup), = cap.hiers
                print_hierarchy(tag, hier, setup)
                res, = cap.results
            else:
                res = pas_solve(hier, NEV, tol_rel=1e-8, verbose=1,
                                composite_rr=True, **PAS_KWARGS)
                ev, evec, nev_conv = res.eval, res.evec, res.nev_conv
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
        for level, lam in res.level_history:
            print(f"{tag}: level {level} lam[0:3] = {lam[:3]}")
        print(f"{tag}: wall {wall:.3f} s, sweeps by level (finest last) "
              f"{res.sweeps}, nev_conv {nev_conv} of {NEV}, launches "
              f"{launches}")
        fem_gates(tag, a, b, ev, evec, nev_conv, ev_plain)
        idle = [k for k in ("dia_f64", "gram", "expand", "csr_f64")
                if launches[k] <= 0]
        if idle:
            raise AssertionError(f"{tag}: kernels not launched: {idle}")
        out[tag] = launches
        if first is None:
            first = res
    return out["PAS"], out["PAS composite"], hier, first


def kernels_amg_levels(torch, log, hier):
    """Kernel 6 at the operands the V-cycle hands the CSR levels and the
    transfers (an ``(n, 10)`` block), against its plain version and beside
    ``torch.sparse.mm``; rows past the tile budget run as serial chains."""
    from gcge_tpu_torch.ops import onehot

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    for i, lv in enumerate(hier.levels):
        for what, op in (("A", lv.a_op), ("P", lv.p_op), ("R", lv.r_op)):
            if isinstance(op, onehot.CsrOperator):
                csr_operator_row(torch, log, op, f"AMG level {i} {what}", gen)


def kernels_fem_level0(torch, log, a):
    """Kernels 1 and 2 at the FEM pair's level 0 (the DIA operator
    ``solve`` places, 15 diagonals), where the multilevel solves launch
    them: kernel 1 at the W coupling's ``V[:, 110:120]``, kernel 2 at the
    f32 CG stage's operand, each against its plain version and beside
    ``torch.sparse.mm``."""
    from gcge_tpu_torch import make_operator
    from gcge_tpu_torch.ops import spmm

    coo = a.tocoo()
    op = make_operator(coo.row, coo.col, coo.data, coo.shape, device=DEVICE)
    n, offs = a.shape[0], op.offsets_t
    ndiag = op.values.shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    tag = f" FEM level 0 ({ndiag} diagonals, n={n})"
    for key, dtype, case, tol in (("dia_f64", torch.float64,
                                   "V[:, 110:120]", 1e-14),
                                  ("dia_f32", torch.float32, "cg", 1e-5)):
        values = op.values.to(dtype)
        item = values.element_size()
        spmm_rows(torch, log, key,
                  lambda x, t, v=values: spmm.dia_spmm(v, offs, x, t),
                  lambda x, t, absolute, v=values: spmm.dia_spmm_reference(
                      v.abs() if absolute else v, offs, x, t),
                  n, a.nnz, item * ndiag * n + 4 * ndiag,
                  csr_tensor(torch, a.tocsr(), dtype), [case], tol, gen, tag)


def csr_operator_row(torch, log, op, what, gen):
    """Kernel 6 on the CSR operator ``op`` at an ``(n, 10)`` block (n its
    columns), against its plain version and beside ``torch.sparse.mm``."""
    import scipy.sparse as sps

    from gcge_tpu_torch.ops import onehot

    a_csr = sps.csr_matrix((op.values.cpu().numpy(), op.colidx.cpu().numpy(),
                            op.rowptr.cpu().numpy()), shape=op.shape)
    lengths = np.diff(a_csr.indptr)
    past = int((lengths > onehot.CSR_BUDGET).sum())
    csr_rows(torch, log, "csr_f64", op, op.values, a_csr, [f"(n, {BS})"],
             1e-14, gen, f" {what} {op.shape} ({a_csr.nnz} entries, rows up "
             f"to {lengths.max()}, {past} past the budget of "
             f"{onehot.CSR_BUDGET})")


def sync_check_amg(torch, a, hier):
    """One fused chunk of the AMG-standard solve: ``gcg_solve`` with
    ``solve``'s defaults on a card and the V-cycle of ``hier`` as
    ``linear_precond``, on the operator ``solve`` places."""
    from gcge_tpu_torch import GCGParams, gcg_solve, make_operator
    from gcge_tpu_torch.api import _tuned_defaults
    from gcge_tpu_torch.solvers.multigrid import bamg_preconditioner

    coo = a.tocoo()
    op = make_operator(coo.row, coo.col, coo.data, coo.shape, device=DEVICE)
    tuned = _tuned_defaults(torch.device(DEVICE), "gcg", a, None)

    def run(steps):
        params = GCGParams(**dict(tuned, fuse=steps), nev=NEV, verbose=0,
                           max_iter=steps,
                           linear_precond=bamg_preconditioner(hier))
        gcg_solve(op, None, params)

    phase_sync_check(torch, "AMG standard, V-cycle in the captured stage",
                     run)


def phase_launch_floor(torch, log):
    """The time of an empty launch, by the kernel rows' method: an ``add_``
    on a one-element tensor, beside kernels 7 and 8."""
    one = torch.zeros(1, device=DEVICE)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    ms = median_ms(torch, lambda: one.add_(1.0), flush=flush)
    b2b = median_ms(torch, lambda: one.add_(1.0))
    del flush
    k7, k8 = (log.entries[k]["ms"] for k in ("mask_probe", "fma_probe"))
    print(f"launch floor: add_ on one element {ms:.4f} ms ({b2b:.4f} ms "
          f"back to back); kernel 7 (mask probe) {k7:.4f} ms, kernel 8 (FMA "
          f"probe) {k8:.4f} ms: {k7 / ms:.2f} and {k8 / ms:.2f} times the "
          f"floor")
    return ms


def profile_solve(torch, label: str, run):
    """``run()`` (a solve that returns its iteration count) under
    torch.profiler: wall, device busy and idle share, device operations and
    host synchronisations, in all and per iteration, and the device time by
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iters = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    syncs = copies = launches = replays = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:      # kernels, copies, memsets
            rows.append((e.self_device_time_total, e.count, e.key))
        elif e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                       "cudaEventSynchronize"):
            syncs += e.count
        elif e.key == "cudaMemcpyAsync":    # to the host (a wait) or not
            copies += e.count
        elif e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                       "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += e.count
        elif e.key == "cudaGraphLaunch":
            replays += e.count
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) * 1e-6
    ops = sum(r[1] for r in rows)
    print(f"profile ({label}, {iters} iterations): wall {wall:.4f} s, device "
          f"busy {busy:.4f} s, idle {100 * (1 - busy / wall):.2f} % of the "
          f"wall, {ops} device operations ({ops / iters:.0f} an iteration), "
          f"{launches} kernel launches by the host ({launches / iters:.0f}) "
          f"and {replays} graph replays, {syncs + copies} host syncs/copies "
          f"({(syncs + copies) / iters:.1f}): {syncs} synchronize calls "
          f"({syncs / iters:.1f}) and {copies} cudaMemcpyAsync "
          f"({copies / iters:.1f}, copies on the device among them)")
    for dev_us, count, key in rows[:14]:
        print(f"profile: {dev_us * 1e-3:10.3f} ms {count:8d} x  {key[:90]}")
    for what, picks in (
            ("kernels 3+4 (the Gram's chunk sum among them)",
             lambda k: "tall_gram" in k or "tall_expand" in k),
            ("kernel 1", lambda k: "dia_spmm_f64_staged" in k),
            ("kernel 2", lambda k: "dia_spmm_f32_staged" in k),
            ("kernel 5", lambda k: "csr_spmm_f32_tiled" in k),
            ("kernel 6", lambda k: "csr_spmm_f64_tiled" in k),
            # the f32 CG stage is the only f32 work of a solve
            ("PyTorch f32 elementwise and reductions (the CG stage's)",
             lambda k: ("elementwise" in k or "reduce_kernel" in k)
             and "float" in k and "double" not in k)):
        picked = [(us, count) for us, count, key in rows if picks(key)]
        dev_ms = sum(us for us, _ in picked) * 1e-3
        print(f"profile ({label}): {what} {dev_ms:.3f} ms device time in "
              f"{sum(count for _, count in picked)} launches, "
              f"{dev_ms / iters:.4f} ms an iteration")


def phase_profile(torch, op, a_csr):
    """Profiles, each by the phased and by the fused loop: 30 iterations of
    the irregular solve on the operator already packed on the card (no host
    RCM or packing in the window), and the whole headline solve."""
    import gcge_tpu_torch
    from gcge_tpu_torch import GCGParams, gcg_solve, make_operator

    for fuse in (0, IRREGULAR_FUSE):
        def irregular():
            gcge_tpu_torch.solve(op, None, device=DEVICE, verbose=1,
                                 fuse=fuse,
                                 **dict(IRREGULAR_KWARGS, max_iter=30))
            return 30

        profile_solve(torch, f"irregular solve, fuse={fuse}", irregular)
    coo = a_csr.tocoo()
    dia = make_operator(coo.row, coo.col, coo.data, coo.shape, device=DEVICE)
    for fuse in (0, HEADLINE_FUSE):
        params = GCGParams(**HEADLINE_KWARGS, fuse=fuse, cg_auto_shift=True,
                           cg_refine=2, cg_mixed=True, verbose=0)
        profile_solve(torch, f"headline solve, fuse={fuse}",
                      lambda: gcg_solve(dia, None, params).num_iter)


def profile_multilevel(torch, a, b):
    """Profiles of the multilevel path on the cube FEM pair: 10 iterations
    of the AMG-preconditioned solve, standard (the V-cycle in the captured
    f32 stage) and generalized (the f64 CG with the V-cycle), each on a
    hierarchy built outside the window, and PAS on the generalized one."""
    from gcge_tpu_torch import GCGParams, gcg_solve, make_operator
    from gcge_tpu_torch.api import _tuned_defaults
    from gcge_tpu_torch.solvers.multigrid import (bamg_preconditioner,
                                                  build_hierarchy)
    from gcge_tpu_torch.solvers.pas import pas_solve

    dev = torch.device(DEVICE)
    coo = a.tocoo()
    a_op = make_operator(coo.row, coo.col, coo.data, coo.shape, device=dev)
    b_vals = np.asarray(b[coo.row, coo.col]).ravel()
    b_op = make_operator(coo.row, coo.col, b_vals, coo.shape, device=dev)
    for tag, bv, bop in (("standard", None, None),
                         ("generalized", b_vals, b_op)):
        hier = build_hierarchy(coo.row, coo.col, coo.data, coo.shape[0],
                               b_vals=bv, device=dev)
        params = GCGParams(**_tuned_defaults(dev, "gcg", a, None if bv is
                                             None else b),
                           nev=NEV, max_iter=10, verbose=0,
                           linear_precond=bamg_preconditioner(hier))
        profile_solve(torch, f"AMG {tag} solve",
                      lambda: gcg_solve(a_op, bop, params).num_iter)
    profile_solve(torch, "PAS solve (iterations: sweeps)",
                  lambda: sum(pas_solve(hier, NEV, tol_rel=1e-8, verbose=0,
                                        **PAS_KWARGS).sweeps))


# --------------------------------------------------------------------------
# the row-sharded path: kernels 1 and 2 on halo windows, a one-rank NCCL
# mesh, and the utils
# --------------------------------------------------------------------------

HALO_BLOCKS = 4              # row blocks of the headline operator
CLI_EXTRA = []               # more flags of the CLI run (none on a card)


def phase_kernels_halo(torch, log, rows, cols, vals, n):
    """Kernels 1 and 2 on the halo windows of the headline operator cut into
    HALO_BLOCKS row blocks, as four ranks of a sharded DIA operator hold it:
    each block's value rows, and its window of x (the rank's rows between
    hl = -min(off) rows of the left neighbour and hr = max(off) of the
    right one, zeros past the ends), contiguous (ln + hl + hr, 10) as the
    sharded operator assembles it; kernel 2 at the CG stage's layout, (10,
    nw) in shape and (nw, 10) in memory.  Each against its plain version
    and against the block's rows of the unsharded product, timed beside the
    square product (halo (0, 0)) of the same block's rows; then halo (0, 0)
    against a zero-padded window, bit for bit."""
    from gcge_tpu_torch import make_operator
    from gcge_tpu_torch.ops import spmm

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(9)
    op = make_operator(rows, cols, vals, (n, n), device=dev)
    offs = op.offsets_t
    hl, hr = -min(op.offsets), max(op.offsets)
    ln = n // HALO_BLOCKS
    if ln * HALO_BLOCKS != n or hl > ln or hr > ln:
        raise AssertionError("the headline operator does not split into "
                             f"{HALO_BLOCKS} blocks with their halos")
    x_full = torch.randn((n, BS), generator=gen, dtype=torch.float64,
                         device=dev)
    x_pad = torch.nn.functional.pad(x_full, (0, 0, hl, hr))
    for dtype, key, tol in ((torch.float64, "dia_f64", 1e-14),
                            (torch.float32, "dia_f32", 1e-5)):
        item = torch.empty((), dtype=dtype).element_size()
        values = op.values.to(dtype)
        xp = x_pad.to(dtype)
        transposed = dtype == torch.float32
        xs = xp[hl:hl + n].contiguous()                      # (n, 10)
        whole = spmm.dia_spmm(values, offs, xs.T if transposed else xs,
                              transposed)
        whole = whole.T if transposed else whole
        exact = True
        for b in range(HALO_BLOCKS):
            r0 = b * ln
            vb = values[:, r0:r0 + ln].contiguous()
            win = xp[r0:r0 + ln + hl + hr].contiguous()     # (nw, 10)
            sq = xp[hl + r0:hl + r0 + ln].contiguous()
            if transposed:
                win, sq = win.T, sq.T                        # (10, nw) views
            nnz = int(torch.count_nonzero(vb))

            def halo_kernel(vb=vb, win=win):
                return spmm.dia_spmm(vb, offs, win, transposed, (hl, hr))

            def square_kernel(vb=vb, sq=sq):
                return spmm.dia_spmm(vb, offs, sq, transposed)

            # the library call: torch.sparse.mm of the block's rows as a
            # (ln, nw) CSR matrix over the window, in the (nw, 10) layout
            i = torch.arange(ln, device=dev).repeat(len(op.offsets))
            j = i + hl + offs.long().repeat_interleave(ln)
            keep = vb.reshape(-1) != 0
            lib = torch.sparse_coo_tensor(
                torch.stack([i[keep], j[keep]]), vb.reshape(-1)[keep],
                (ln, ln + hl + hr)).coalesce().to_sparse_csr()
            win_nm = win.T.contiguous() if transposed else win

            got = halo_kernel()
            twice_equal(torch, halo_kernel, f"{key} halo block {b}")
            rows_whole = whole[r0:r0 + ln]
            got_n = got.T if transposed else got
            exact = exact and torch.equal(got_n, rows_whole)
            diff = float((got_n - rows_whole).abs().max())
            scale = spmm.dia_spmm_reference(vb.abs(), offs, win.abs(),
                                            transposed, (hl, hr)).max()
            if not diff <= tol * float(scale):
                raise AssertionError(f"{key} halo block {b}: {diff:.3e} off "
                                     "the unsharded product's rows")
            label = (f"{key} halo block {b} ({ln} rows, halo ({hl}, {hr})) "
                     f"m={BS} strides {tuple(win.stride())}")
            log.run(key, label, halo_kernel,
                    lambda vb=vb, win=win: spmm.dia_spmm_reference(
                        vb, offs, win, transposed, (hl, hr)),
                    scale, tol,
                    item * (vb.numel() + (2 * ln + hl + hr) * BS)
                    + 4 * len(op.offsets), 2.0 * nnz * BS,
                    library=lambda lib=lib, win_nm=win_nm: torch.sparse.mm(
                        lib, win_nm))
            halo_ms = log.last["ms"]
            sq_scale = spmm.dia_spmm_reference(vb.abs(), offs, sq.abs(),
                                               transposed).max()
            log.run(key, f"{key} square block {b} ({ln} rows, halo (0, 0))",
                    square_kernel,
                    lambda vb=vb, sq=sq: spmm.dia_spmm_reference(
                        vb, offs, sq, transposed), sq_scale, tol,
                    item * (vb.numel() + 2 * ln * BS)
                    + 4 * len(op.offsets), 2.0 * nnz * BS)
            print(f"{key} block {b}: halo window {halo_ms:.4f} ms beside the "
                  f"square product of the same rows {log.last['ms']:.4f} ms "
                  f"({halo_ms / log.last['ms']:.2f} times)")
        print(f"{key}: the {HALO_BLOCKS} halo blocks equal the unsharded "
              f"product's rows {'bit for bit' if exact else 'to ' + str(tol)}")
        # halo (0, 0) is the square product: its bits on x equal those of
        # the window product on x between zero halos
        xw = xp.clone()
        xw[:hl] = 0
        xw[hl + n:] = 0
        if transposed:
            xs, xw = xs.T, xw.T
        square = spmm.dia_spmm(values, offs, xs, transposed)
        window = spmm.dia_spmm(values, offs, xw, transposed, (hl, hr))
        if not torch.equal(square, window):
            raise AssertionError(f"{key}: halo (0, 0) is not the zero-padded "
                                 "window's product")
        print(f"{key}: halo (0, 0) at n={n} equals the product on x between "
              f"zero halos ({hl}, {hr}) bit for bit")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_solve(torch, tag, a_op, a_csr, params, mesh):
    """``gcg_solve`` of ``a_op`` without a mesh, then of
    ``shard_operator(a_op, mesh)`` on the one-rank mesh, in one run: walls
    side by side; the distributed solve's gates (the undistributed solve's
    converged count, eigenvalues within 1e-9 of it, host residuals of 2e-8,
    kernels 1/2 or 5/6 launched through the window).  Returns the
    distributed solve's launches, graph replays and whether it has the
    undistributed solve's bits, then that solve and its wall."""
    from gcge_tpu_torch import gcg_solve
    from gcge_tpu_torch.parallel import dist_ops, shard_operator
    from gcge_tpu_torch.solvers import gcg

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = gcg_solve(a_op, None, params)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    sharded = shard_operator(a_op, mesh)
    reset_counters()
    dist_ops.WINDOWED.update({k: 0 for k in dist_ops.WINDOWED})
    gcg.GRAPH_REPLAYS["cg_stage"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gcg_solve(sharded, None, params, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    windowed = dict(dist_ops.WINDOWED)
    replays = gcg.GRAPH_REPLAYS["cg_stage"]
    ev = res.eval[:NEV]
    rel = float(np.max(np.abs(ev - plain.eval[:NEV]) / np.abs(plain.eval[:NEV])))
    bits = np.array_equal(res.eval, plain.eval) and \
        torch.equal(res.evec, plain.evec)
    res_h = residuals(a_csr, ev, res.evec[:, :NEV].cpu().numpy())
    print(f"{tag}: wall {wall:.3f} s on the one-rank mesh beside {wall_plain:.3f}"
          f" s without one; {res.num_iter} iterations (without: "
          f"{plain.num_iter}), nev_conv {res.nev_conv} (without: "
          f"{plain.nev_conv}); eigenvalues vs the undistributed solve max rel "
          f"diff {rel:.3e} (tol 1e-9), {'equal' if bits else 'not equal'} "
          f"bits; host residuals max {res_h.max():.3e} (tol 2e-8); windowed "
          f"products {windowed}; CG stage graph replays {replays}; launches "
          f"{launches}")
    if res.nev_conv < NEV or res.nev_conv != plain.nev_conv:
        raise AssertionError(f"{tag}: nev_conv {res.nev_conv}, undistributed "
                             f"{plain.nev_conv}")
    if not rel <= 1e-9 or not res_h.max() <= 2e-8:
        raise AssertionError(f"{tag}: eigenvalues or residuals off")
    kind = "dia" if sharded.kind == "dia" else "csr"
    idle = [k for k in (f"{kind}_f64", f"{kind}_f32") if windowed[k] <= 0]
    if idle:
        raise AssertionError(f"{tag}: no product through the window: {idle}")
    return launches, replays, bits, plain, wall_plain, wall


def grid_solve(torch, tag, a_op, a_csr, params, grid, plain, walls):
    """``gcg_solve`` of ``shard_operator(a_op, grid)`` on the (1, 1) grid,
    against the undistributed solve ``plain`` of this run: its bits,
    iterations and converged count, host residuals of 2e-8, kernels 1 and
    2 launched through the window; the wall printed beside ``walls``
    (label: seconds).  Returns the launches."""
    from gcge_tpu_torch import gcg_solve
    from gcge_tpu_torch.parallel import dist_ops, shard_operator
    from gcge_tpu_torch.solvers import gcg

    sharded = shard_operator(a_op, grid)
    reset_counters()
    reset_dist_counters()
    gcg.GRAPH_REPLAYS["cg_stage"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Captured() as cap:
        res = gcg_solve(sharded, None, params, mesh=grid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, windowed = read_counters(), dict(dist_ops.WINDOWED)
    bits = np.array_equal(res.eval, plain.eval) and \
        torch.equal(res.evec, plain.evec)
    stage = cap.stages[0] if cap.stages else None
    how = "no f32 stage" if stage is None else \
        "captured" if stage.graph is not None else \
        f"eager ({stage.capture_error or 'the phased loop'})"
    res_h = residuals(a_csr, res.eval[:NEV], res.evec[:, :NEV].cpu().numpy())
    beside = ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
    print(f"{tag}: wall {wall:.3f} s on the (1, 1) grid beside {beside}; "
          f"{res.num_iter} iterations (undistributed {plain.num_iter}), "
          f"nev_conv {res.nev_conv} (undistributed {plain.nev_conv}), "
          f"{'equal' if bits else 'not equal'} bits to the undistributed "
          f"solve; f32 CG stage {how}, {gcg.GRAPH_REPLAYS['cg_stage']} "
          f"replays; host residuals max {res_h.max():.3e}; windowed products "
          f"{windowed}; launches {launches}")
    if not bits or res.num_iter != plain.num_iter or \
            res.nev_conv != plain.nev_conv or res.nev_conv < NEV:
        raise AssertionError(f"{tag}: not the undistributed solve's bits, "
                             f"iterations and count")
    if not res_h.max() <= 2e-8:
        raise AssertionError(f"{tag}: host residuals off")
    idle = [k for k in ("dia_f64", "dia_f32") if windowed[k] <= 0]
    if idle:
        raise AssertionError(f"{tag}: no product through the window: {idle}")
    return launches


def phase_distributed(torch, a_csr, rows, cols, vals, n, a_rcm):
    """The row-sharded path on a one-rank NCCL group (one card cannot hold
    two NCCL ranks): the headline problem by the phased and the fused loop,
    the irregular problem (RCM-ordered, the sharded CSR operator) by the
    phased loop, each beside the undistributed solve of the same run.  At
    one rank the all_reduce and broadcast are copies and the window holds
    zeros past the ends, so the distributed fused solve (the CG stage
    captured with its all_reduce, or eager where the card refuses) has the
    bits of the undistributed fused solve (captured): the check that eager
    and captured agree under the mesh."""
    import torch.distributed as dist

    from gcge_tpu_torch import CsrOperator, GCGParams, make_operator
    from gcge_tpu_torch.parallel import bootstrap, grid_mesh, row_mesh

    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    bootstrap(f"tcp://127.0.0.1:{_free_port()}", 1, 0, DEVICE)
    paths = {}
    try:
        mesh = row_mesh()
        grid = grid_mesh(1, 1)
        # the parameters solve() tunes on a card for this problem
        tuned = dict(cg_auto_shift=True, cg_refine=2, cg_mixed=True,
                     verbose=0)
        op = make_operator(rows, cols, vals, (n, n), device=dev)
        for fuse, tag in ((0, "distributed headline"),
                          (HEADLINE_FUSE, "distributed fused headline")):
            params = GCGParams(**dict(HEADLINE_KWARGS, fuse=fuse, **tuned))
            launches, replays, bits, plain, wall_plain, wall = dist_solve(
                torch, tag, op, a_csr, params, mesh)
            if fuse and not bits:
                raise AssertionError("the one-rank fused solve does not have "
                                     "the undistributed fused solve's bits")
            paths[tag.replace(" ", "_")] = launches
            grid_tag = tag.replace("distributed", "grid")
            paths[grid_tag.replace(" ", "_")] = grid_solve(
                torch, grid_tag, op, a_csr, params, grid, plain,
                {"undistributed": wall_plain, "one-rank row mesh": wall})
        coo = a_rcm.tocoo()
        csr = CsrOperator.from_coo(coo.row, coo.col, coo.data, a_rcm.shape,
                                   device=dev)
        params = GCGParams(**dict(IRREGULAR_KWARGS, fuse=0, **dict(
            tuned, cg_refine=IRREGULAR_KWARGS["cg_refine"])))
        paths["distributed_irregular"] = dist_solve(
            torch, "distributed irregular", csr, a_rcm, params, mesh)[0]
    finally:
        dist.destroy_process_group()
    print(f"distributed phase: {time.perf_counter() - t0:.1f} s")
    return paths


@contextlib.contextmanager
def one_rank_mesh():
    """The row mesh of a one-rank NCCL group (``bootstrap`` on a free
    localhost port), destroyed on exit."""
    import torch.distributed as dist

    from gcge_tpu_torch.parallel import bootstrap, row_mesh

    bootstrap(f"tcp://127.0.0.1:{_free_port()}", 1, 0, DEVICE)
    try:
        yield row_mesh()
    finally:
        dist.destroy_process_group()


def dist_counters() -> dict:
    """The sharded operators' windowed products and the sharded transfers
    since the last :func:`reset_dist_counters`."""
    from gcge_tpu_torch.parallel import dist_ops

    return {**dist_ops.WINDOWED, **dist_ops.TRANSFERS}


def reset_dist_counters():
    from gcge_tpu_torch.parallel import dist_ops

    for counters in (dist_ops.WINDOWED, dist_ops.TRANSFERS):
        for key in counters:
            counters[key] = 0


def multilevel_path_gates(tag, counted):
    """Kernel 1 through level 0's window and both sharded transfers ran."""
    idle = [k for k in ("dia_f64", "prolong", "restrict") if counted[k] <= 0]
    if idle:
        raise AssertionError(f"{tag}: not run on the sharded level 0: {idle}")


def phase_distributed_amg(torch, log, a, hier, amg):
    """The AMG standard solve on a one-rank NCCL mesh: ``gcg_solve`` of the
    sharded operator with the parameters ``solve`` tunes on a card and the
    V-cycle of ``shard_hierarchy(hier, mesh)`` as ``linear_precond``,
    against the undistributed AMG solve ``amg`` of this run (the same
    hierarchy): the same iterations and converged count, eigenvalues within
    1e-9, host residuals of 2e-8, kernel 1 through the window, both sharded
    transfers, the V-cycle inside the captured f32 stage's graph (or the
    stage eager, with the card's reason printed).  Then kernel 6 at the
    two operands the sharded level 0 adds; then the same solve on a (1, 1)
    grid (``grid_mesh(1, 1)``, the hierarchy sharded over it), which must
    have the undistributed solve's bits, iterations and count.  Returns the
    launches of the row-mesh and of the grid solve."""
    from gcge_tpu_torch import GCGParams, gcg_solve, make_operator
    from gcge_tpu_torch.api import _tuned_defaults
    from gcge_tpu_torch.parallel import (grid_mesh, shard_hierarchy,
                                         shard_operator)
    from gcge_tpu_torch.solvers import gcg
    from gcge_tpu_torch.solvers.multigrid import bamg_preconditioner

    tag = "distributed AMG standard"
    coo = a.tocoo()
    op = make_operator(coo.row, coo.col, coo.data, coo.shape, device=DEVICE)
    tuned = _tuned_defaults(torch.device(DEVICE), "gcg", a, None)
    with one_rank_mesh() as mesh:
        hd = shard_hierarchy(hier, mesh)
        params = GCGParams(nev=NEV, verbose=0, **tuned,
                           linear_precond=bamg_preconditioner(hd))
        sharded = shard_operator(op, mesh)
        reset_counters()
        reset_dist_counters()
        gcg.GRAPH_REPLAYS["cg_stage"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with Captured() as cap:
            res = gcg_solve(sharded, None, params, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, counted = read_counters(), dist_counters()
        stage, = cap.stages
        bits = np.array_equal(res.eval, amg.eval) and \
            torch.equal(res.evec, amg.evec)
        print(f"{tag}: wall {wall:.3f} s on the one-rank mesh (the "
              f"hierarchy of the AMG standard phase, sharded), "
              f"{res.num_iter} iterations (undistributed {amg.num_iter}), "
              f"nev_conv {res.nev_conv} (undistributed {amg.nev_conv}), "
              f"{'equal' if bits else 'not equal'} bits to the undistributed"
              f" solve; windowed products and transfers {counted}; CG stage "
              f"graph replays {gcg.GRAPH_REPLAYS['cg_stage']}; launches "
              f"{launches}")
        if res.num_iter != amg.num_iter or res.nev_conv < NEV or \
                res.nev_conv != amg.nev_conv:
            raise AssertionError(f"{tag}: {res.num_iter} iterations and "
                                 f"nev_conv {res.nev_conv}, undistributed "
                                 f"{amg.num_iter} and {amg.nev_conv}")
        fem_gates(tag, a, None, res.eval, res.evec, NEV, amg.eval)
        multilevel_path_gates(tag, counted)
        if stage.graph is None:
            print(f"{tag}: the f32 CG stage runs eager under the mesh; the "
                  f"card refused its capture: {stage.capture_error}")
        else:
            in_graph = {k: v for counts in stage._launches
                        for k, v in counts.items() if v}
            print(f"{tag}: the captured f32 CG stage launches {in_graph} a "
                  f"replay")
            if not all(in_graph.get(k) for k in ("dia_f64", "csr_f64",
                                                  "prolong", "restrict")):
                raise AssertionError(f"{tag}: the sharded V-cycle is not in "
                                     "the graph")
        gen = torch.Generator(device=DEVICE).manual_seed(7)
        lv0 = hd.levels[0]
        csr_operator_row(torch, log, lv0.p_op.local,
                         "distributed level 0 rank-local P rows", gen)
        csr_operator_row(torch, log, lv0.r_op.local,
                         "distributed level 0 rank-local P^T columns", gen)
        grid = grid_mesh(1, 1)
        tag = "grid AMG standard"
        hg = shard_hierarchy(hier, grid)
        params = GCGParams(nev=NEV, verbose=0, **tuned,
                           linear_precond=bamg_preconditioner(hg))
        sharded = shard_operator(op, grid)
        reset_counters()
        reset_dist_counters()
        gcg.GRAPH_REPLAYS["cg_stage"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with Captured() as cap:
            res = gcg_solve(sharded, None, params, mesh=grid)
        torch.cuda.synchronize()
        grid_wall = time.perf_counter() - t0
        grid_launches, counted = read_counters(), dist_counters()
        stage, = cap.stages
        how = "captured" if stage.graph is not None else \
            f"eager ({stage.capture_error})"
        bits = np.array_equal(res.eval, amg.eval) and \
            torch.equal(res.evec, amg.evec)
        print(f"{tag}: wall {grid_wall:.3f} s on the (1, 1) grid (the "
              f"hierarchy of the AMG standard phase, sharded over it) beside "
              f"{wall:.3f} s on the one-rank row mesh and the undistributed "
              f"loop's {amg.timers['total']:.3f} s; {res.num_iter} "
              f"iterations (undistributed {amg.num_iter}), nev_conv "
              f"{res.nev_conv} (undistributed {amg.nev_conv}), "
              f"{'equal' if bits else 'not equal'} bits to the undistributed "
              f"solve; f32 CG stage {how}, {gcg.GRAPH_REPLAYS['cg_stage']} "
              f"replays; windowed products and transfers {counted}; launches "
              f"{grid_launches}")
        if not bits or res.num_iter != amg.num_iter or \
                res.nev_conv != amg.nev_conv:
            raise AssertionError(f"{tag}: not the undistributed solve's bits,"
                                 f" iterations and count")
        fem_gates(tag, a, None, res.eval, res.evec, NEV, amg.eval)
        multilevel_path_gates(tag, counted)
    return launches, grid_launches


def phase_distributed_pas(torch, a, b, hier, pas):
    """``pas_solve`` of ``shard_hierarchy(hier, mesh)`` on a one-rank NCCL
    mesh with ``solve``'s PAS knobs, against the undistributed PAS solve
    ``pas`` of this run (the same hierarchy): the same sweeps by level and
    converged count, eigenvalues within 1e-9 and host residuals of 2e-8
    (``fem_gates``), kernel 1 through the window and both sharded
    transfers.  Returns the launches."""
    from gcge_tpu_torch.parallel import shard_hierarchy
    from gcge_tpu_torch.solvers.pas import pas_solve

    tag = "distributed PAS"
    with one_rank_mesh() as mesh:
        hd = shard_hierarchy(hier, mesh)
        reset_counters()
        reset_dist_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pas_solve(hd, NEV, tol_rel=1e-8, verbose=0, **PAS_KWARGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, counted = read_counters(), dist_counters()
    bits = np.array_equal(res.eval, pas.eval) and \
        torch.equal(res.evec, pas.evec)
    print(f"{tag}: wall {wall:.3f} s on the one-rank mesh (the hierarchy of "
          f"the PAS phase, sharded), sweeps by level {res.sweeps} "
          f"(undistributed {pas.sweeps}), nev_conv {res.nev_conv} "
          f"(undistributed {pas.nev_conv}), {'equal' if bits else 'not equal'}"
          f" bits to the undistributed solve; windowed products and "
          f"transfers {counted}; launches {launches}")
    if res.sweeps != pas.sweeps or res.nev_conv != pas.nev_conv:
        raise AssertionError(f"{tag}: sweeps {res.sweeps} and nev_conv "
                             f"{res.nev_conv}, undistributed {pas.sweeps} and "
                             f"{pas.nev_conv}")
    fem_gates(tag, a, b, res.eval, res.evec, res.nev_conv, pas.eval)
    multilevel_path_gates(tag, counted)
    return launches


def phase_utils(torch, a_csr, rows, cols, vals, n):
    """The utils on the headline fused solve: a checkpoint every 5
    iterations, reloaded, and a resume from its Ritz vectors that needs
    fewer iterations; ``profile_dir`` writes a trace; ``MemWatch`` prints
    the peak; ``leak_check`` of a second solve finds no new bytes; and the
    CLI module in a subprocess."""
    import tempfile

    from gcge_tpu_torch import GCGParams, gcg_solve, make_operator
    from gcge_tpu_torch.utils import checkpoint, meminfo

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    op = make_operator(rows, cols, vals, (n, n), device=dev)
    params = GCGParams(**dict(HEADLINE_KWARGS, fuse=HEADLINE_FUSE,
                              cg_auto_shift=True, cg_refine=2, cg_mixed=True,
                              verbose=0))
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "gcg_ck.npz")
        with meminfo.MemWatch("headline fused solve with checkpoints",
                              device=dev) as watch:
            full = gcg_solve(op, None, GCGParams(**dict(
                params.__dict__, checkpoint_path=ck, checkpoint_every=5)))
        if watch.after.peak_bytes_in_use is None:
            raise AssertionError("MemWatch read no allocator peak")
        ev_ck, evec, conv_ck, meta = checkpoint.load_checkpoint(ck, dev)
        trace_dir = os.path.join(tmp, "trace")
        resumed = gcg_solve(op, None, GCGParams(**dict(
            params.__dict__, profile_dir=trace_dir)), x0=evec[:, :NEV])
        trace = os.path.join(trace_dir, "gcg_trace.json")
        trace_mb = os.path.getsize(trace) / 2 ** 20
        print(f"utils: checkpoint (every 5 iterations) of a {full.num_iter}"
              f"-iteration solve: nev_conv {conv_ck}, {evec.shape[1]} Ritz "
              f"vectors, params {len(meta)}; the resume from it: "
              f"{resumed.num_iter} iterations, nev_conv {resumed.nev_conv}; "
              f"its profile trace {trace_mb:.1f} MiB")
        rel = float(np.max(np.abs(resumed.eval[:NEV] - full.eval[:NEV])
                           / np.abs(full.eval[:NEV])))
        if resumed.nev_conv < NEV or not resumed.num_iter < full.num_iter \
                or not rel <= 1e-9 or trace_mb <= 0:
            raise AssertionError(f"utils: the resume ({resumed.num_iter} "
                                 f"iterations, eigenvalues {rel:.3e} off) or "
                                 "the trace failed")

    def run():
        gcg_solve(op, None, params)

    report = meminfo.leak_check(run, device=dev)
    print(f"utils: leak_check of a steady-state fused headline solve: "
          f"{report.new_arrays} new tensors, {report.new_bytes} new bytes")
    t1 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "gcge_tpu_torch.utils.cli", "-fem_nx", "12",
         "-gcge_print_conv", "0"] + CLI_EXTRA, cwd=HERE, capture_output=True, text=True,
        timeout=600)
    lams = [line for line in out.stdout.splitlines()
            if line.strip().startswith("[")]
    print(f"utils: python -m gcge_tpu_torch.utils.cli -fem_nx 12: exit "
          f"{out.returncode}, {len(lams)} eigenvalues in "
          f"{time.perf_counter() - t1:.1f} s, the first {lams[:3]}")
    if out.returncode != 0 or not lams:
        raise AssertionError(f"the CLI failed:\n{out.stderr[-2000:]}")
    print(f"utils phase: {time.perf_counter() - t0:.1f} s")


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
    ("fma_probe", "gcge_tpu_torch/ops/csrc/fma_probe.cu",
     "benchmarks/df64_push.py:51"),
    ("slice_gram", "gcge_tpu_torch/ops/csrc/slice_gram.cu",
     "benchmarks/pallas_isolate.py:55"),
)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import gcge_tpu_torch  # noqa: F401  (fails here, before any output, without the package)

    import scipy.sparse as sps

    from gcge_tpu_torch.io.stencil import build_3d27

    card = phase_build()
    phase_fragment_check(torch)
    log = KernelLog(torch)
    rows, cols, vals, n = build_3d27(NX)
    a_csr = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    paths = {}
    phase_kernels_headline(torch, log, rows, cols, vals, n)
    t0 = time.perf_counter()
    phase_kernels_halo(torch, log, rows, cols, vals, n)
    print(f"halo kernel phase: {time.perf_counter() - t0:.1f} s")
    phase_kernels_probes(torch, log)
    paths["scripts"] = phase_scripts()
    paths["headline"], ev_headline = phase_headline(torch, log, a_csr, 0)
    paths["fused_headline"], _ = phase_headline(torch, log, a_csr,
                                                HEADLINE_FUSE, ev_headline)
    sync_check_headline(torch, a_csr)
    a, a_rcm = build_delaunay(MESH)
    op = phase_kernels_irregular(torch, log, a_rcm)
    phase_hybrid(torch, log)
    paths["irregular"], ev_irregular = phase_irregular(torch, log, a, a_rcm)
    paths["fused_irregular"] = phase_irregular_fused(torch, log, a,
                                                     ev_irregular)
    phase_launch_floor(torch, log)
    paths.update(phase_distributed(torch, a_csr, rows, cols, vals, n, a_rcm))
    phase_utils(torch, a_csr, rows, cols, vals, n)
    t0 = time.perf_counter()
    fem_a, fem_b = build_fem(FEM_NX)
    paths["amg"], hier, _, amg = phase_amg(torch, log, fem_a, None)
    print(f"AMG standard phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sync_check_amg(torch, fem_a, hier)
    kernels_amg_levels(torch, log, hier)
    kernels_fem_level0(torch, log, fem_a)
    print(f"AMG sync check and kernel 6 rows: {time.perf_counter() - t0:.1f} "
          f"s")
    t0 = time.perf_counter()
    paths["distributed_amg"], paths["grid_amg"] = phase_distributed_amg(
        torch, log, fem_a, hier, amg)
    del hier, amg
    print(f"distributed AMG phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["amg_generalized"], _, ev_gen, _ = phase_amg(torch, log, fem_a,
                                                       fem_b)
    print(f"AMG generalized phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["pas"], paths["pas_composite"], hier, pas = phase_pas(
        torch, fem_a, fem_b, ev_gen)
    print(f"PAS phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["distributed_pas"] = phase_distributed_pas(torch, fem_a, fem_b,
                                                     hier, pas)
    del hier, pas
    print(f"distributed PAS phase: {time.perf_counter() - t0:.1f} s")
    if "--profile" in argv:
        phase_profile(torch, op, a_csr)
        profile_multilevel(torch, fem_a, fem_b)
        phase_walls(torch, a_csr, a)
    print(f"chip_smoke: {time.perf_counter() - T_START:.0f} s")
    print(card)
    print(json.dumps({"kernels": [
        {"name": key, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(counts[key] for counts in paths.values()),
         "launches_by_path": {name: counts[key]
                              for name, counts in paths.items()},
         **log.entries[key], "lib_ms": log.entries[key]["library_ms"]}
        for key, src, rep in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
