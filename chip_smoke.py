#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gcge_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --tall [--root DIR]
    python3 chip_smoke.py --dia [--root DIR]
    python3 chip_smoke.py --pas [--root DIR]
    python3 chip_smoke.py --csr [--root DIR]
    python3 chip_smoke.py --jacobi
    python3 chip_smoke.py --eigh [--root DIR]
    python3 chip_smoke.py --newton-mesh [--root DIR]

Ten kernels (the nine TPU kernels' counterparts and the Jacobi sweeps of
the projected eigensolvers), four solves (the headline and the irregular problem, each by
the phased and by the fused loop), the two kernel measurement scripts, the
multilevel path on the cube FEM pair (GCG preconditioned by an AMG V-cycle,
standard and generalized, and the PAS solver), a check that a fused chunk
never waits for the device outside ``eigh``, kernels 1 and 2 on halo
windows, the row-sharded solves on a one-rank NCCL mesh, the utils, the
distributed multilevel path (AMG and PAS on a sharded hierarchy) on a
one-rank NCCL mesh, the headline and AMG solves on a (1, 1) grid, the
command-line driver on files, and the stencil at the reference's
production widths (nev=200, m=480; nev=400, m=960).
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
   also on a matrix with rows of 3,000-20,000 entries (the split path, one
   to ten blocks a row), kernel 5 on the Hybrid check's CSR remainder; the mask probe against its plain version
   bit for bit; kernels 3 and 4 again at this matrix's n;
6. Hybrid check — a banded matrix plus a thin scatter of outliers (n=50,000)
   through ``make_operator``: DIA core and CSR remainder applied together in
   f64 and f32 against scipy;
7. irregular solve — ``gcge_tpu_torch.solve(a, None, nev=50, rcm=True,
   block_size=10, max_iter=300, cg_max_iter=60, cg_refine=3)``; checks the
   layout, the converged count, the residuals with scipy in the caller's
   ordering, that kernels 3-7 were launched (the mask probe by
   ``CsrOperator.from_coo``; kernel 6 also on the wide path's tiles, at the
   initial Rayleigh-Ritz's 100 columns), and the eigenvalues against a
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
    solve (the PAS solves through kernel 6's panel path); then kernel 6 at
    the coarse levels' own operands (rows of more than 256 entries on the
    split path; at PAS's (n, 75) on levels 2 A and 3 A the panel path),
    timed like the other rows, the split and the panel path in turns with
    a second bound (the records of x each gathers over the L2 rate), and
    each CSR level's middle third of rows as a CSR of its own, which must
    give the same bits as the rows of the whole product.

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
18. driver — ``gcge_tpu_torch.utils.cli.main`` on the card: the headline
    stencil written to a MatrixMarket file (the natural ordering must be
    kept; the headline phase's parameters; its eigenvalues within 1e-10 of
    the headline solve's and the headline gates), and the cube FEM pair
    written as PETSc binary files, solved with ``-shift 5`` (its
    eigenvalues less 5 within 1e-9 of ``solve(A, B, nev=50)``'s); each
    through kernels 1 (2 on the stencil), 3 and 4.
19. wide — for nev=200 at nx=54 (block 40, nevMax 400, m=480) and nev=400
    at nx=44 (block 80, nevMax 800, m=960): kernels 1-4 timed at the
    shapes those solves hand them (kernel 1 at ``V[:, m - bs:m]`` and the
    residual window ``ritz[:, 41:41 + bs]`` of the (n, 2 nev) Ritz block,
    kernel 2 at the CG's ``(bs, n)`` operand, each also on the narrow and
    the wide path in turns, their bits compared, kernels 3
    and 4 at every shape class, the expand of the restarts (n x 2 nev)
    (2 nev x 2 nev) among them; then each class that takes the wide path
    of kernels 3 and 4 on the narrow path and on the wide path in turns, beside
    the library call), then one row of ``utils.sweep`` (warm-up
    and timed solve): walls, iterations and converged count beside the C
    reference's, peak device memory, launches and host waits an
    iteration, kernels 3/4 by shape class; the headline gates on the
    first nev pairs, kernels 1-4 launched.
20. irregular wide — the Delaunay matrix of phase 7, in phase 7's RCM
    ordering, written to a MatrixMarket file and solved through
    ``utils.cli.main`` at nev=200, block 40 (m=480): packed as CSR; at
    least 200 converged, host residuals of the first 200 pairs at
    most 2e-8, the first 50 eigenvalues within 1e-9 of phase 7's;
    iterations beside the C reference's 107; kernels 5 and 6 launched,
    also on the wide path's tiles (m = 40: the plan's choice); kernels 6
    and 5 timed at this solve's operands (``V[:, 440:480]``, the CG's
    ``(40, n)``), on the 64-row and the wide tiles in turns, with equal
    bits.  Then the same matrix in its mesh ordering through the driver,
    under the same gates, with the layout the driver chose and its wall
    beside the first run's.

21. Jacobi kernel — right after phase 10: the sweeps of
    ``ops.eighs.jacobi_sweeps`` against its plain version (the same bits
    and sweep counts), ``eigvalsh`` (eigenvalues within 1e-12 ||H||) and
    ``U^T U = I`` to 1e-12, timed beside ``torch.linalg.eigh`` of the same
    matrices: one matrix of 120 from the card's eigh (the 'jacobi' path's
    operand), of 120, 80, 160, 240, 480 and 960 from a warm start 1e-6 off
    (480 and 960: the 'jacobi' backend's at nev=200 and 400), 64 blocks of
    64 (the cluster stage's batch), 8 blocks of 480 and of 512 (the
    closing stage's batch at nev=200 and 400); each with its launch plan
    (cluster size, rows a block, threads, where H and V live) and its time
    a round;
22. projected eigensolvers on the main path — the headline with
    ``rr_backend='jacobi'``, phased and ``fuse=20``, and (after phase
    19's nev=200 row) the nev=200 sweep row with ``rr_backend='newton'``
    and the structural warm start, fused and phased: the headline gates,
    eigenvalues within 1e-9 of the 'auto' solve, iterations, waits and
    Jacobi launches an iteration, the warm starts taken, the Newton
    eighs' closing rounds, walls in turns with 'auto', and one fused chunk
    of each under the sync check;
23. the partitioned Newton eigh on one NCCL rank — after phase 19's
    nev=400 row: ``eigh_newton`` with ``mesh=row_mesh()`` and with
    ``mesh=grid_mesh(1, 1)`` on the third projected matrix of order 480
    and of order 960 that the nev=200 and nev=400 rows' Rayleigh-Ritz steps
    built, ``mesh=None``'s bits, ``out='cols'`` the replicated bits, the
    gathers a call and the walls beside ``mesh=None``'s; then phase 22's
    nev=200 'newton' row through ``gcg_solve(..., mesh=row_mesh())``: the
    bits, iterations and count of phase 22's fused row, the headline
    gates, waits an iteration, and one fused chunk under the sync check.

``--jacobi`` runs phase 1 and then phase 21 alone, each operand also at
every cluster size that fits the card (1, 2, 4, 8, 16 blocks a matrix),
with the plan's bits, beside the plan's choice (about 2 minutes).

``--eigh`` runs phase 1, the nev=400 'auto' row (its InitializeX time:
the 800-column ``orth_block`` through ``eigh_newton``), phase 21 and phase
22's 'newton' row at nev=400 (m=960).  With ``--root DIR`` (a parent
commit unpacked there) it then runs four turns (parent, tree, tree,
parent), each ``python3 chip_smoke.py --eigh-turn`` in a process of its
own with the package of that tree: the Jacobi kernel at every operand of
phase 21 and the timed nev=200 'newton' solve, whose kernel bits, sweep
counts, solve bits, iterations and count must be the parent's.

``--newton-mesh`` runs phase 1 and then phase 23's nev=200 'newton' row
alone, without a mesh and on a one-rank NCCL row mesh: the captured
projected matrix of order 480 through ``eigh_newton`` (the same bits, a
``torch.profiler`` run of each, the walls in turns), then the solves'
walls in turns, their counts and a digest of their bits; ``--root DIR``
as for ``--tall`` (a parent: its one-rank mesh path).

``--tall`` runs phase 1 and then kernels 3 and 4 alone: every class of
the headline and the two wide solves, timed as in phases 2 and 19, the two
paths back to back, and the device time of one call by launch
(``torch.profiler``); ``--root DIR`` imports the package from DIR instead
of beside this script (a parent commit unpacked there), so that two trees
are timed in one call, in turns.

``--dia`` runs phase 1 and then kernels 1 and 2 alone, at every operand a
solve hands them (at the headline and at both production widths the CG's
operand, the windows of V and of the Ritz block, the f64 refresh, the
gathered residual window and the initial Rayleigh-Ritz; FEM level 0 and
the halo rows), each on the plan's path against the plain version and the
library call, the narrow and the wide path back to back with their bits
compared; then the two wide solves' walls and kernel 1/2 calls by
operand; ``--root DIR`` as for ``--tall`` (a parent tree: the plan's path
only).

``--pas`` runs phase 1 and then the PAS solve of the cube FEM pair alone
(the multilevel path's solve at PAS's working block of 75 columns): its
wall, sweeps and count, a ``torch.profiler`` run of it (busy, idle,
kernels 1 and 6 device time), then kernel 6 at the AMG levels' CSR
operands at ``(n, 10)`` and ``(n, 75)``, where the plan holds panels on
the split and the panel path in turns, each beside the library call, the
device-memory bound and the bound of its gathers of x over the L2 rate;
``--root DIR`` as for ``--tall``.

``--csr`` runs phase 1 and then kernels 5 and 6 alone on the irregular
matrix, at every operand the irregular nev=50 and nev=200 solves hand
them, on the plan's path against the plain version and beside the library
call, and on each of its tile paths (the 64-row tiles, the wide path's) in
turns with their bits compared, each beside the memory bound and the
bounds of its gathers of x over the L2 rate of the run; then both solves
(iterations, count, calls by operand) and a ``torch.profiler`` run of the
nev=200 solve (busy, idle, kernels 5 and 6 device time); ``--root DIR`` as
for ``--tall`` (a parent tree: its own paths).

``--profile`` adds ``torch.profiler`` runs (30 iterations of the irregular
solve and the whole headline solve, each phased and fused; the whole wide
solves; 10 iterations of each AMG-preconditioned solve and one PAS solve
on the FEM pair) and prints
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
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
import types

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
# the production widths run by the wide phase (block nev/5, nevMax 2 nev)
WIDE_NEVS = (200, 400)

IRREGULAR_KWARGS = dict(nev=NEV, block_size=BS, max_iter=300, cg_max_iter=60,
                        cg_refine=3)
FEM_NX = 54                  # the cube FEM pair: n = (FEM_NX - 1)^3
# solve's PAS defaults, for the composite run on a prebuilt hierarchy
PAS_KWARGS = dict(sweeps_per_level=2, final_sweeps=16, bamg_cycles=8)
# PAS's working block at NEV (nev + nev // 2): the width of its V-cycles
PAS_WIDTH = NEV + NEV // 2


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


def stencil(nx: int):
    """The 27-point stencil at ``nx`` as ``(rows, cols, vals, n)`` and a
    scipy CSR matrix."""
    import scipy.sparse as sps

    from gcge_tpu_torch.io.stencil import build_3d27

    rows, cols, vals, n = build_3d27(nx)
    return (rows, cols, vals, n), \
        sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()


def stencil_gates(tag, a_csr, nx, count, ev, evec):
    """The headline gates on the first ``count`` pairs: eigenvalues within
    1e-9 of the closed form, host residuals at most 2e-8."""
    from gcge_tpu_torch.io.stencil import smallest_eigs_3d27

    exact = smallest_eigs_3d27(nx, count)
    ev_err = float(np.max(np.abs(ev[:count] - exact) / np.abs(exact)))
    res = residuals(a_csr, ev[:count], evec[:, :count].cpu().numpy())
    print(f"{tag}: eigenvalues vs closed form max rel err {ev_err:.3e} "
          f"(tol 1e-9); host residuals max {res.max():.3e} (tol 2e-8)")
    if not ev_err <= 1e-9:
        raise AssertionError(f"{tag}: eigenvalue error {ev_err:.3e} > 1e-9")
    if not res.max() <= 2e-8:
        raise AssertionError(f"{tag}: residual {res.max():.3e} > 2e-8")


def path_launched(tag, launches, keys):
    """Raise unless every kernel of ``keys`` was launched (the counts of
    :func:`read_counters` over a path's run)."""
    idle = [k for k in keys if launches[k] <= 0]
    if idle:
        raise AssertionError(f"{tag}: kernels not launched: {idle}")


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
            library=None, primary=False, cls=None, plain_reps=REPS):
        """scale: the error's reference size, a scalar or per entry;
        tol 0 demands equal bits; cls: the key under which ``by_class``
        keeps this run's time and bound; plain_reps: the runs of the plain
        version's median (fewer where one takes seconds)."""
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
        plain_ms = median_ms(torch, plain, reps=plain_reps, flush=flush)
        lib_ms = None if library is None else \
            median_ms(torch, library, flush=flush)
        back_to_back_ms = median_ms(torch, kernel)
        bound_ms, bound_by = bound(nbytes, flops)
        self.last = {"ms": ms, "bound_ms": bound_ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms}
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


def spmm_operand(torch, name, n, dtype, gen, parents=None):
    """The operand of an SpMM row, as ``(x, transposed)``: a column view of
    a basis as a solve hands it to kernels 1 and 6, a contiguous ``(n, m)``
    or a contiguous ``(m, n)`` of the transposed layout.  The views are
    ``V[:, a:b]`` of the (n, m) basis and ``ritz[:, a:b]`` of the (n,
    size_x) Ritz block that ``tall_expand`` returns, whose widths
    ``parents`` gives as ``{"V": m, "ritz": size_x}`` (default the
    headline's, 120 and 100): ``V[:, 110:120]``, the W coupling of every
    Rayleigh-Ritz step (rows 120 elements apart, on 16 bytes);
    ``V[:, :100]``, the initial Rayleigh-Ritz; ``ritz[:, 41:51]``, a
    residual window at an odd offset (rows 8-byte aligned only)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=DEVICE)

    if name.startswith(("V[", "ritz[")):
        parent, window = name.split("[:, ")
        lo, hi = window.rstrip("]").split(":")
        width = (parents or {"V": 2 * NEV + 2 * BS, "ritz": 2 * NEV})[parent]
        return randn(n, width)[:, int(lo or 0):int(hi)], False
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
              cases, tol, gen, tag="", n_in=None, parents=None, after=None):
    """An SpMM kernel (``apply(x, transposed)``) against its plain version
    (``plain(x, transposed, absolute)``, on |A| where ``absolute``) and
    beside ``torch.sparse.mm`` on ``lib`` (the same values, in the (n, m)
    layout), for each operand of ``cases`` (:func:`spmm_operand`, or ``cg``:
    the f32 CG stage's, :func:`cg_operand`, of BS columns; ``cg40``: of
    40).  Each row also gives equal bits twice and returns its product in
    the memory order of its operand; its bound counts the matrix's bytes,
    x and y once each.  The first case is the primary one where ``tag`` is
    empty.  ``n_in``: the rows of x where the matrix is rectangular (its
    columns; default ``n``); ``parents``: the widths of the views'
    parents, as in :func:`spmm_operand`.  A case may also be an operand of
    its own, ``(name, x, transposed)``.  ``after(label, x, transposed,
    bound_ms)``, where given, runs after each row (:func:`dia_paths`)."""
    dtype = lib.dtype
    item = torch.empty((), dtype=dtype).element_size()
    n_in = n if n_in is None else n_in
    for case in cases:
        if isinstance(case, tuple):
            name, x, transposed = case
        elif case.startswith("cg"):
            name = case
            x = cg_operand(torch, lambda z: apply(z, True), n_in,
                           int(name[2:] or BS), gen)
            transposed = True
        else:
            name = case
            x, transposed = spmm_operand(torch, name, n_in, dtype, gen,
                                         parents)
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
                primary=not tag and case == cases[0])
        if after is not None:
            after(label, x, transposed, log.last["bound_ms"])


def launch_counters():
    from gcge_tpu_torch.ops import eighs, onehot, osgemm, probes, spmm

    return (spmm.LAUNCHES, osgemm.LAUNCHES, onehot.LAUNCHES, probes.LAUNCHES,
            getattr(eighs, "LAUNCHES", {}))


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


def kernels_tall(torch, log, n, gen, primary, grams=GRAM_CLASSES,
                 expands=EXPAND_CLASSES, width=120, col_major=()):
    """Kernels 3 and 4 against their plain versions at every shape class a
    solve of size n gives them (default: nev=50, block 10), with equal bits
    across two launches.  The tall operands are column views of a basis of
    ``width`` columns, as the solver's are; the expand classes of
    ``col_major`` take a column-major C, as the solver's Rayleigh-Ritz
    eigenvectors are (``torch.linalg.eigh``'s layout)."""
    from gcge_tpu_torch.ops import osgemm

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           device=DEVICE)

    basis = randn(n, width)
    # kernel 3: tall Gram; error relative to ||a_i|| ||b_j|| per entry
    for p, q in grams:
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
    for k, q in expands:
        a = basis[:, :k]
        c = randn(q, k).T if (k, q) in col_major else randn(k, q)
        label = f"tall_expand n={n} (n x {k})({k} x {q})" + (
            ", C column-major" if (k, q) in col_major else "")
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
    ``solve`` and ``utils.sweep`` reach it) are wrapped for its
    duration."""

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
            (gcg, "tall_gram"), (gcg, "tall_expand"), (api, "gcg_solve"),
            (gcg, "gcg_solve"))]
        for m in (osgemm, gcg):
            m.tall_gram, m.tall_expand = counted_gram, counted_expand
        api.gcg_solve = gcg.gcg_solve = counted_solve
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


def dia_pair(values, offs, halo=(0, 0)):
    """Kernel 1 or 2 on a DIA matrix (``apply(x, transposed)``) and its plain
    version (``plain(x, transposed, absolute)``), for :func:`spmm_rows`;
    ``halo`` as in ``spmm.dia_spmm``."""
    from gcge_tpu_torch.ops import spmm

    return (lambda x, t: spmm.dia_spmm(values, offs, x, t, halo),
            lambda x, t, absolute: spmm.dia_spmm_reference(
                values.abs() if absolute else values, offs, x, t, halo))


def phase_kernels_headline(torch, log, rows, cols, vals, n):
    """Kernels 1-4 against their plain versions at the headline shapes."""
    import scipy.sparse as sps

    from gcge_tpu_torch import make_operator

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    op = make_operator(rows, cols, vals, (n, n), device=dev)
    v64, offs = op.values, op.offsets_t
    v32 = v64.float()
    a_csr = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    lib64 = csr_tensor(torch, a_csr, torch.float64)
    lib32 = csr_tensor(torch, a_csr, torch.float32)
    ndiag = v64.shape[0]
    # kernel 1: f64 DIA; error relative to max (|A| |x|).  Primary: the W
    # coupling's column view of V, then the solve's other operands and the
    # other layouts
    spmm_rows(torch, log, "dia_f64", *dia_pair(v64, offs), n, a_csr.nnz,
              8 * ndiag * n + 4 * ndiag, lib64,
              ["V[:, 110:120]", "ritz[:, 41:51]", "V[:, :100]", "(n, 10)",
               "(10, n)", "(100, n)"], 1e-14, gen)
    # kernel 2: f32 DIA.  Primary: the operand the mixed inner CG hands it,
    # (m, n) with strides (1, m); besides, a contiguous (m, n) operand and
    # the (n, m) layout
    spmm_rows(torch, log, "dia_f32", *dia_pair(v32, offs), n, a_csr.nnz,
              4 * ndiag * n + 4 * ndiag, lib32,
              ["cg", f"({BS}, n)", f"(n, {BS})"], 1e-5, gen)
    kernels_tall(torch, log, n, gen, primary=True)
    tall_host_cost(torch)


def phase_headline(torch, log, a_csr, fuse: int, ev_phased=None):
    """The headline solve through the public entry point, by the phased loop
    (``fuse=0``) or the fused one; the fused solve is also held against the
    phased solve's eigenvalues.  Returns ``(launches, eigenvalues)``."""
    import gcge_tpu_torch
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
    stencil_gates(tag, a_csr, NX, NEV, ev, evec)
    path_launched(tag, launches, ("dia_f64", "dia_f32", "gram", "expand"))
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


def csr_keys(m: int) -> tuple:
    """The counters that an irregular solve whose block is m columns wide
    must move: kernels 5 and 6, and their launches on the wide path's tiles
    where the wrapper's rule takes it at m (the CG's operand and the W
    coupling); kernel 6's wide launches in any case (the initial
    Rayleigh-Ritz, 2 nev columns)."""
    from gcge_tpu_torch.ops import onehot

    return ("csr_f32", "csr_f64", "csr_f64_wide") + \
        (("csr_f32_wide",) if m > onehot.CSR_WIDE_M else ())


def csr_rows(torch, log, op, vals, a_csr, cases, tol, gen, tag="",
             parents=None, after=None):
    """Kernel 5 or 6 (by the dtype of ``vals``) on the CSR operator ``op``
    in its own plan: :func:`spmm_rows` with the library call on the scipy
    matrix ``a_csr`` (and its ``after`` hook)."""
    from gcge_tpu_torch.ops import onehot

    rowptr, colidx, plan = op.rowptr, op.colidx, op.plan
    nnz = int(vals.shape[0])
    spmm_rows(
        torch, log, "csr_f64" if vals.dtype == torch.float64 else "csr_f32",
        lambda x, t: onehot.csr_spmm(rowptr, colidx, vals, x, t, plan),
        lambda x, t, absolute: onehot.csr_spmm_reference(
            rowptr, colidx, vals.abs() if absolute else vals, x, t),
        op.shape[0], nnz,
        nnz * (4 + vals.element_size()) + 4 * (op.shape[0] + 1),
        csr_tensor(torch, a_csr, vals.dtype), cases, tol, gen, tag,
        n_in=op.shape[1], parents=parents, after=after)


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
    csr_rows(torch, log, op, op.values, a_rcm,
             ["V[:, 110:120]", "ritz[:, 41:51]", "V[:, :100]", "(n, 10)",
              "(10, n)", "(40, n)"], 1e-14, gen)
    csr_rows(torch, log, op, op.values.float(), a_rcm,
             ["cg", "(n, 10)", "(10, n)", "(40, n)"], 1e-5, gen)
    # kernels 6 and 5 at rows of the split path: 50,000 rows of 0 to 11
    # entries (every 997th empty) and three of 3,000, 5,000 and 20,000
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
    plan = op2.plan
    split = plan.split[:plan.nsplit].cpu().numpy()
    tiled = plan.tiles.cpu().numpy()
    if set(split[:, 0]) != {5, 777, 40_000} or \
            plan.nmulti != int((deg > onehot.CSR_PART).sum()) or \
            any(a <= r < b for a, b in tiled for r in (5, 777, 40_000)):
        raise AssertionError("the long rows are not on the split path alone: "
                             f"split blocks {split.tolist()}")
    tag = (f" long rows (max {deg.max()}; {plan.nsplit} split blocks, "
           f"{plan.nmulti} rows of several parts)")
    csr_rows(torch, log, op2, op2.values, long_rows,
             ["V[:, 110:120]"], 1e-14, gen, tag)
    csr_rows(torch, log, op2, op2.values.float(), long_rows,
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
    csr_rows(torch, log, rest, rest.values.float(), rest_csr,
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
    path_launched("irregular", launches,
                  ("gram", "expand", "mask_probe") + csr_keys(BS))

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
    path_launched(tag, launches, ("gram", "expand") + csr_keys(BS))
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
    path_launched(tag, launches, ("dia_f64", "gram", "expand", "csr_f64")
                  + (("dia_f32",) if b is None else ()))
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
        # the working block (n, 75) at levels 2 A and 3 A: the panel path
        path_launched(tag, launches, ("dia_f64", "gram", "expand",
                                      "csr_f64", "csr_f64_panel"))
        out[tag] = launches
        if first is None:
            first = res
    return out["PAS"], out["PAS composite"], hier, first


def kernels_amg_levels(torch, log, hier):
    """Kernel 6 at the operands the V-cycle hands the CSR levels and the
    transfers (an ``(n, 10)`` block), against its plain version and beside
    ``torch.sparse.mm``; rows of more than 256 entries run on the split
    path.  Where a level has such rows (level 2 A and R, level 3 A), also
    at PAS's working block (``(n, 75)``: the panel path where the plan takes
    it, level 2 A and level 3 A; else the split path's staged kernel), with
    the split and the panel path in turns (:func:`csr_paths`).  Then each
    level's A, at both widths: its middle third of rows as a CSR of its own
    gives the same bits as the whole product's rows."""
    from gcge_tpu_torch.ops import onehot

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    for i, lv in enumerate(hier.levels):
        for what, op in (("A", lv.a_op), ("P", lv.p_op), ("R", lv.r_op)):
            if isinstance(op, onehot.CsrOperator):
                widths = [BS] + ([PAS_WIDTH] if op.plan.nsplit else [])
                csr_operator_row(torch, log, op, f"AMG level {i} {what}",
                                 gen, widths)
                if what == "A":
                    for m in widths:
                        shard_bits(torch, op, f"AMG level {i} A", gen, m)


def shard_bits(torch, op, what, gen, m):
    """Rows [n/3, 2n/3) of the CSR operator ``op`` as a CSR of their own, on
    the same ``(n, m)`` block: the same bits as those rows of the whole
    product (a row's sum is split and ordered by its length alone)."""
    from gcge_tpu_torch.ops import onehot

    n = op.shape[0]
    r0, r1 = n // 3, 2 * n // 3
    lo, hi = (int(v) for v in op.rowptr[[r0, r1]].cpu())
    rowptr = (op.rowptr[r0:r1 + 1] - lo).contiguous()
    part = onehot.CsrOperator(rowptr, op.colidx[lo:hi].contiguous(),
                              op.values[lo:hi].contiguous(), op.shape[1])
    x = torch.randn((op.shape[1], m), generator=gen, dtype=torch.float64,
                    device=DEVICE)
    whole, shard = op.matvec(x), part.matvec(x)
    equal = torch.equal(whole[r0:r1], shard)
    print(f"{what} m={m}: rows [{r0}, {r1}) as a CSR of their own "
          f"({part.plan.nsplit} split blocks): equal bits to the whole "
          f"product's rows: {equal}")
    if not equal:
        raise AssertionError(f"{what} m={m}: the shard's bits differ from "
                             "the whole product's")


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


def csr_operator_row(torch, log, op, what, gen, widths=(BS,)):
    """Kernel 6 on the CSR operator ``op`` at an ``(n, m)`` block of each
    width of ``widths`` (n its columns), against its plain version and
    beside ``torch.sparse.mm``; where its plan holds panels, on the split
    and the panel path in turns (:func:`csr_paths`)."""
    import scipy.sparse as sps

    from gcge_tpu_torch.ops import onehot

    a_csr = sps.csr_matrix((op.values.cpu().numpy(), op.colidx.cpu().numpy(),
                            op.rowptr.cpu().numpy()), shape=op.shape)
    lengths = np.diff(a_csr.indptr)
    split = int((lengths > onehot.CSR_SPLIT).sum())
    pn = getattr(op.plan, "panels", None)
    panels = "" if pn is None else \
        f", {pn.npanels} panels of 16 rows, {pn.kcol.shape[0]} tiles of 16 " \
        f"x 8, {100 * pn.fill:.1f} % full, {pn.chunks} column chunks"
    csr_rows(torch, log, op, op.values, a_csr,
             [f"(n, {m})" for m in widths], 1e-14, gen,
             f" {what} {op.shape} ({a_csr.nnz} entries, rows up to "
             f"{lengths.max()}, {split} of more than {onehot.CSR_SPLIT} on "
             f"the split path, {op.plan.nsplit} blocks{panels})",
             after=None if pn is None else functools.partial(
                 csr_paths, torch, op, a_csr))


_L2_RATE = []


def l2_rate(torch) -> float:
    """Bytes a second the card moves through its L2 cache, measured once a
    run: the fastest of three plain PyTorch streams over buffers that stay
    in the 50 MB L2 (row sums of 16 MB, a copy of 8 MB, an add of two 4 MB
    buffers; bytes read and written counted), each 100 times in one CUDA
    graph so that no launch from the host sits between them, the median of
    REPS replays."""
    if not _L2_RATE:
        def f64(*shape):
            return torch.ones(shape, dtype=torch.float64, device=DEVICE)

        mb = 2 ** 20
        buf, rowsum = f64(2 ** 15, 64), f64(2 ** 15)
        src, dst = f64(mb), f64(mb)
        a, b, c = f64(mb // 2), f64(mb // 2), f64(mb // 2)
        streams = {"row sums": (lambda: torch.sum(buf, 1, out=rowsum),
                                16 * mb + mb // 4),
                   "copy": (lambda: dst.copy_(src), 16 * mb),
                   "add": (lambda: torch.add(a, b, out=c), 12 * mb)}
        rates = {}
        for name, (fn, nbytes) in streams.items():
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(100):
                    fn()
            rates[name] = 100 * nbytes / (1e-3 * median_ms(torch,
                                                            graph.replay))
        _L2_RATE.append(max(rates.values()))
        print("L2 rate (plain PyTorch streams within the L2 cache, 100 in "
              "a CUDA graph): " + ", ".join(
                  f"{name} {rate / 1e12:.2f} TB/s"
                  for name, rate in rates.items())
              + f"; the bound takes {_L2_RATE[0] / 1e12:.2f} TB/s")
    return _L2_RATE[0]


def csr_paths(torch, op, a_csr, label, x, transposed, bound_ms):
    """Kernel 6 on the CSR operator ``op`` at the operand ``x`` on the split
    and the panel path in turns (split, panel, panel, split; each a median
    of REPS after the L2 flush), beside the library call, ``bound_ms`` (the
    device-memory bound) and each path's second bound: the bytes of the
    records of x it gathers (the split path: a record of m elements an
    entry; the panel path: 8 records, padded to whole n-tiles of 8
    columns, a tile of 16 x 8, the tile path's rows a record an entry) over
    the fastest L2 rate seen (:func:`l2_rate`'s plain streams or either
    path's own gathers at this row, whichever is faster: the card's L2
    peak is not published, and a rate measured in the run only bounds it
    from below); the ``after`` hook of :func:`spmm_rows`."""
    from gcge_tpu_torch.ops import onehot

    pn = op.plan.panels
    m = x.shape[0] if transposed else x.shape[1]
    chosen = onehot.csr_path(op.plan, op.values, m)

    def kernel(path):
        return onehot.csr_spmm(op.rowptr, op.colidx, op.values, x,
                               transposed, op.plan, path)

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    times = {"split": [], "panel": []}
    for path in ("split", "panel", "panel", "split"):
        times[path].append(median_ms(torch, lambda: kernel(path),
                                     flush=flush))
    lib_x = (x.T if transposed else x).contiguous()
    lib = csr_tensor(torch, a_csr, torch.float64)
    lib_ms = median_ms(torch, lambda: torch.sparse.mm(lib, lib_x),
                       flush=flush)
    lengths = np.diff(a_csr.indptr)
    short = int(lengths[lengths <= onehot.PANEL_MIN].sum())
    gathered = {"split": 8.0 * a_csr.nnz * m,
                "panel": 8.0 * (pn.kcol.shape[0] * 8 * 8 * -(-m // 8)
                                + short * m)}
    achieved = {p: gathered[p] / (1e-3 * min(t)) for p, t in times.items()}
    rate = max(l2_rate(torch), *achieved.values())
    parts = "; ".join(
        f"{p} {t[0]:.4f} / {t[1]:.4f} ms ({lib_ms / min(t):.2f} times as "
        f"fast as the library, {100 * bound_ms / min(t):.0f} % of the "
        f"memory bound; gathers {gathered[p] / 1e9:.3f} GB at "
        f"{achieved[p] / 1e12:.2f} TB/s, {1e3 * gathered[p] / rate:.4f} ms "
        f"at the L2 rate of {rate / 1e12:.2f} TB/s, "
        f"{100 * 1e3 * gathered[p] / rate / min(t):.0f} % of that bound)"
        for p, t in times.items())
    print(f"csr paths {label}: the plan takes {chosen}; {parts}; library "
          f"{lib_ms:.4f} ms; memory bound {bound_ms:.4g} ms; panel "
          f"{min(times['split']) / min(times['panel']):.2f} times as fast "
          f"as split")


def tile_records(a_csr, tiles) -> int:
    """The distinct records of x that the row tiles ``tiles`` ((first row,
    end) pairs) gather, summed over the tiles: the bytes a tile path must
    bring into the SMs once each tile's reuse is caught (in L1 or shared
    memory), over the record's bytes."""
    tiles = np.asarray(tiles, np.int64).reshape(-1, 2)
    first, end = a_csr.indptr[tiles[:, 0]], a_csr.indptr[tiles[:, 1]]
    counts = (end - first).astype(np.int64)
    tile = np.repeat(np.arange(len(tiles)), counts)
    ent = np.repeat(first - (np.cumsum(counts) - counts), counts) + \
        np.arange(int(counts.sum()))
    return len(np.unique(tile * a_csr.shape[1] + a_csr.indices[ent]))


def csr_tile_paths(torch, op, vals, a_csr, label, x, transposed, bound_ms):
    """Kernel 5 or 6 (by the dtype of ``vals``) on the CSR operator ``op``
    at the operand ``x`` on every path of ``onehot.PATHS`` that runs the
    short rows on tiles (``split``: the 64-row tiles; ``wide``: the wide
    path's; a scratch tree's other paths), in turns (each a median of REPS
    after the L2 flush), with their bits compared (a difference raises),
    beside the library call, ``bound_ms`` (the device-memory bound) and
    two bounds of the gathers of x over the fastest L2 rate seen
    (:func:`l2_rate`'s plain streams or a path's own here): a record an
    entry, and each tile's distinct records once (:func:`tile_records`,
    where the path's tiles are known); the ``after`` hook of
    :func:`spmm_rows`."""
    from gcge_tpu_torch.ops import onehot

    m = x.shape[0] if transposed else x.shape[1]
    chosen = onehot.csr_path(op.plan, vals, m)
    paths = [p for p in onehot.PATHS if p != "panel"]

    def kernel(path):
        return onehot.csr_spmm(op.rowptr, op.colidx, vals, x, transposed,
                               op.plan, path)

    first = kernel(paths[0])
    for p in paths[1:]:
        if not torch.equal(first, kernel(p)):
            raise AssertionError(f"{label}: the {paths[0]} and the {p} "
                                 f"path differ")
    del first
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    times = {p: [] for p in paths}
    for p in paths + paths[::-1]:
        times[p].append(median_ms(torch, lambda: kernel(p), flush=flush))
    lib_x = (x.T if transposed else x).contiguous()
    lib = csr_tensor(torch, a_csr, vals.dtype)
    lib_ms = median_ms(torch, lambda: torch.sparse.mm(lib, lib_x),
                       flush=flush)
    record = vals.element_size() * m
    every = float(record * a_csr.nnz)
    tiles = {"split": op.plan.tiles, "wide": getattr(op.plan, "wide", None)}
    once = {p: float(record * tile_records(a_csr, tiles[p].cpu().numpy()))
            for p in paths if tiles.get(p) is not None}
    rate = max(l2_rate(torch), *(every / (1e-3 * min(t))
                                 for t in times.values()))
    parts = "; ".join(
        f"{p} {t[0]:.4f} / {t[1]:.4f} ms ({lib_ms / min(t):.2f} times as "
        f"fast as the library, {100 * bound_ms / min(t):.0f} % of the "
        f"memory bound; gathers of a record an entry {every / 1e9:.3f} GB "
        f"at {every / (1e-3 * min(t)) / 1e12:.2f} TB/s"
        + ("" if p not in once else
           f", each tile's distinct records {once[p] / 1e9:.3f} GB: "
           f"{1e3 * once[p] / rate:.4f} ms at the L2 rate of "
           f"{rate / 1e12:.2f} TB/s, "
           f"{100 * 1e3 * once[p] / rate / min(t):.0f} % of that bound")
        + ")" for p, t in times.items())
    best = min(times, key=lambda p: min(times[p]))
    print(f"csr tile paths {label}: the plan takes {chosen}; {parts}; "
          f"library {lib_ms:.4f} ms; memory bound {bound_ms:.4g} ms; "
          f"fastest {best}, {min(times['split']) / min(times[best]):.3f} "
          f"times as fast as split; the same bits")


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


def profile_solve(torch, label: str, run, host_top: int = 0):
    """``run()`` (a solve that returns its iteration count) under
    torch.profiler: wall, device busy and idle share, device operations and
    host synchronisations, in all and per iteration, and the device time by
    kernel; ``host_top``: as many host operations by their own host
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iters = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, host = [], []
    syncs = copies = launches = replays = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            host.append((e.self_cpu_time_total, e.count, e.key))
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
    for host_us, count, key in sorted(host, reverse=True)[:host_top]:
        print(f"profile host: {host_us * 1e-3:10.3f} ms {count:8d} x  "
              f"{key[:90]}")
    for what, picks in (
            ("kernels 3+4 (the Gram's chunk sum among them)",
             lambda k: "tall_gram" in k or "tall_expand" in k),
            # kernels 1 and 2: the narrow and the wide path
            ("kernel 1", lambda k: "dia_spmm_f64_staged" in k
             or "dia_spmm_wide<double" in k),
            ("kernel 2", lambda k: "dia_spmm_f32_staged" in k
             or "dia_spmm_wide<float" in k),
            # kernels 5 and 6 with the second launch of their split path
            ("kernel 5", lambda k: "csr_spmm_f32" in k
             or "csr_combine<float>" in k),
            ("kernel 6", lambda k: "csr_spmm_f64" in k
             or "csr_combine<double>" in k or "csr_panel_f64" in k),
            ("kernel 6's panel path", lambda k: "csr_panel_f64" in k),
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


def profile_wide(torch):
    """Profiles of the wide solves (``utils.sweep``'s settings at nev=200
    and nev=400), whole, on operators packed outside the window."""
    from gcge_tpu_torch import gcg_solve, make_operator
    from gcge_tpu_torch.utils import sweep

    for nev in WIDE_NEVS:
        (rows, cols, vals, n), _ = stencil(C_REFERENCE[nev][0])
        op = make_operator(rows, cols, vals, (n, n), device=DEVICE)
        params = sweep.production_params(nev, op)
        profile_solve(torch, f"wide solve, nev={nev}",
                      lambda: gcg_solve(op, None, params).num_iter)


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


def phase_pas_alone(torch):
    """``--pas``: the PAS solve of the cube FEM pair alone, on the
    generalized hierarchy (built outside the window, as ``--profile``'s):
    one solve for its wall, sweeps and count, one under torch.profiler
    (:func:`profile_solve`: busy, idle, kernels 1 and 6 device time); then
    kernel 6 at the CSR levels' operands, ``(n, 10)`` and PAS's ``(n,
    75)`` (:func:`kernels_amg_levels`: with a package that has the panel
    path, the split and the panel path in turns).  ``--root DIR`` (a parent
    tree) times that tree's package."""
    from gcge_tpu_torch.solvers.multigrid import build_hierarchy
    from gcge_tpu_torch.solvers.pas import pas_solve

    a, b = build_fem(FEM_NX)
    coo = a.tocoo()
    b_vals = np.asarray(b[coo.row, coo.col]).ravel()
    t0 = time.perf_counter()
    hier = build_hierarchy(coo.row, coo.col, coo.data, coo.shape[0],
                           b_vals=b_vals, device=torch.device(DEVICE))
    print_hierarchy("--pas", hier, time.perf_counter() - t0)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pas_solve(hier, NEV, tol_rel=1e-8, verbose=0, **PAS_KWARGS)
    torch.cuda.synchronize()
    print(f"--pas: PAS solve wall {time.perf_counter() - t0:.3f} s (set-up "
          f"excluded), sweeps by level {res.sweeps}, nev_conv "
          f"{res.nev_conv} of {NEV}, lam[:3] {res.eval[:3]}, launches "
          f"{read_counters()}")
    profile_solve(torch, "PAS solve (iterations: sweeps)",
                  lambda: sum(pas_solve(hier, NEV, tol_rel=1e-8, verbose=0,
                                        **PAS_KWARGS).sweeps))
    log = KernelLog(torch)
    kernels_amg_levels(torch, log, hier)
    # kernel 6 at PAS's (n, 75) on the CSR operators without split rows
    # (the plan's path there, the wide tiles), with the plain
    # version, the bound and the library call
    from gcge_tpu_torch.ops import onehot

    gen = torch.Generator(device=DEVICE).manual_seed(PAS_WIDTH)
    for i, lv in enumerate(hier.levels):
        for what, op in (("A", lv.a_op), ("P", lv.p_op), ("R", lv.r_op)):
            if isinstance(op, onehot.CsrOperator) and not op.plan.nsplit:
                path = onehot.csr_path(op.plan, op.values, PAS_WIDTH) \
                    if hasattr(onehot, "csr_path") else "plan's"
                csr_operator_row(torch, log, op,
                                 f"AMG level {i} {what} ({path} path)", gen,
                                 [PAS_WIDTH])


class CsrCalls:
    """Counts the calls of kernels 5 (f32) and 6 (f64) by operand of the
    solves run inside it: ``onehot.csr_spmm`` (where ``CsrOperator`` reaches
    the wrapper) is wrapped for its duration (a replay of the captured CG
    stage calls no wrapper, as in :class:`DiaCalls`)."""

    def __init__(self):
        self.calls = collections.Counter()

    def __enter__(self):
        from gcge_tpu_torch.ops import onehot

        self.spmm = spmm_fn = onehot.csr_spmm

        def counted(rowptr, colidx, values, x, transposed=False, *args,
                    **kwargs):
            m = x.shape[0] if transposed else x.shape[1]
            xs = (x.stride(1), x.stride(0)) if transposed else x.stride()
            dense = x.is_contiguous() or x.T.is_contiguous()
            what = ("dense" if dense else f"view, rows {xs[0]} apart") + \
                f", strides {xs}, start {x.data_ptr() % 16} mod 16"
            self.calls[str(x.dtype).split(".")[1], m, what] += 1
            return spmm_fn(rowptr, colidx, values, x, transposed, *args,
                           **kwargs)

        onehot.csr_spmm = counted
        return self

    def __exit__(self, *exc):
        from gcge_tpu_torch.ops import onehot

        onehot.csr_spmm = self.spmm


def irregular_params(op, nev: int):
    """The parameters of the irregular solve at ``nev``: at nev=200 those
    ``utils.cli.main`` gives it in phase 20 (block 40, the irregular cell's
    inner budget of 60), at nev=50 phase 7's (``IRREGULAR_KWARGS``), each
    with the command-line driver's defaults for the rest (the fused loop in
    chunks of 5, the mixed inner CG); no printing."""
    from gcge_tpu_torch import GCGParams
    from gcge_tpu_torch.utils import cli

    if nev == NEV:
        return cli.driver_params(GCGParams(**IRREGULAR_KWARGS, verbose=0),
                                 DEVICE, op)
    argv = ["-nevConv", str(nev), "-blockSize", str(wide_classes(nev)[1]),
            "-gcge_compW_cg_max_iter", str(IRREGULAR_KWARGS["cg_max_iter"])]
    params, _ = cli.params_from_args(argv)
    return cli.driver_params(dataclasses.replace(params, verbose=0), DEVICE,
                             op, None, {cli._FLAG_MAP[tok][0] for tok in argv
                                        if tok in cli._FLAG_MAP})


def phase_csr(torch):
    """``--csr``: kernels 5 and 6 alone on the irregular matrix (phase 7's
    Delaunay matrix in RCM order, ``CsrOperator``), at every operand the
    irregular nev=50 and nev=200 solves hand them (each solve's W coupling
    ``V[:, m-bs:m]``, residual window ``ritz[:, 41:41+bs]`` at an odd
    offset, refresh ``(n, bs)``, gathered window ``(n, 2 bs)``, initial
    Rayleigh-Ritz ``V[:, :2 nev]``, and the CG's ``(bs, n)``), each against
    its plain version beside the library call (:func:`csr_rows`), and on
    each of the package's tile paths in turns beside the memory bound and
    the gathers' bounds at the L2 rate of the run
    (:func:`csr_tile_paths`).  Then the two solves
    (:func:`irregular_params`): iterations, count, the first eigenvalues
    and the calls of kernels 5 and 6 by operand; and the nev=200 solve
    under torch.profiler (:func:`profile_solve`: busy, idle, kernel 5/6
    device time).  ``--root DIR`` (a parent tree): its paths."""
    import gcge_tpu_torch  # noqa: F401
    from gcge_tpu_torch import gcg_solve, make_operator
    from gcge_tpu_torch.ops import onehot

    log = KernelLog(torch)
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    _, a_rcm = build_delaunay(MESH)
    coo = a_rcm.tocoo()
    n = a_rcm.shape[0]
    t0 = time.perf_counter()
    op = make_operator(coo.row, coo.col, coo.data, (n, n), device=DEVICE)
    torch.cuda.synchronize()
    print(f"--csr: CsrOperator and its plan in "
          f"{time.perf_counter() - t0:.2f} s")
    if not isinstance(op, onehot.CsrOperator):
        raise AssertionError(f"make_operator picked {type(op).__name__}")
    for nev in (NEV, IRREGULAR_WIDE[0]):
        m, bs = (2 * NEV + 2 * BS, BS) if nev == NEV else \
            wide_classes(nev)[:2]
        tag = f" irregular nev={nev}"
        for vals, cases, tol, parents in (
                (op.values, [f"V[:, {m - bs}:{m}]", f"ritz[:, 41:{41 + bs}]",
                             f"(n, {bs})", f"(n, {2 * bs})",
                             f"V[:, :{2 * nev}]"], 1e-14,
                 {"V": m, "ritz": 2 * nev}),
                (op.values.float(), [f"cg{bs}"], 1e-5, None)):
            csr_rows(torch, log, op, vals, a_rcm, cases, tol, gen, tag,
                     parents, functools.partial(csr_tile_paths, torch, op,
                                                vals, a_rcm))
    for nev in (NEV, IRREGULAR_WIDE[0]):
        params = irregular_params(op, nev)
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with CsrCalls() as calls:
            res = gcg_solve(op, None, params)
        torch.cuda.synchronize()
        print(f"--csr irregular nev={nev} solve (block "
              f"{params.block_size}, fuse {params.fuse}): wall "
              f"{time.perf_counter() - t0:.3f} s, {res.num_iter} "
              f"iterations, nev_conv {res.nev_conv}, lam[:3] "
              f"{res.eval[:3].tolist()}, lam[{nev - 1}] "
              f"{float(res.eval[nev - 1])!r}, launches {read_counters()}")
        for (dtype, width, what), count in sorted(calls.calls.items()):
            print(f"--csr irregular nev={nev}: {dtype} m={width} {what}: "
                  f"{count} calls")
    params = irregular_params(op, IRREGULAR_WIDE[0])
    profile_solve(torch, f"irregular nev={IRREGULAR_WIDE[0]} solve",
                  lambda: gcg_solve(op, None, params).num_iter)


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
    path_launched(tag, launches, ("csr_f64_panel",))
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


# --------------------------------------------------------------------------
# the command-line layer, and the reference's production widths
# --------------------------------------------------------------------------

# the C reference's measured runs of the 27-point stencil (one CPU core,
# BASELINE.md:32-33): nev -> (nx, iterations, converged, wall s)
C_REFERENCE = {200: (54, 53, 202, 3800.0), 400: (44, 54, 431, 9406.5)}
FEM_SHIFT = 5.0
# the irregular matrix at nev=200 (BASELINE.md:35): nev, the C reference's
# iterations, converged and wall s
IRREGULAR_WIDE = (200, 107, 202, 20959.6)


def wide_classes(nev: int):
    """``(m, block, Gram classes, expand classes)`` of a solve with
    ``utils.sweep``'s settings for ``nev`` (block nev/5, nevMax 2 nev): the
    classes of :data:`GRAM_CLASSES` and :data:`EXPAND_CLASSES` at its
    widths, and the expand (n x 2 nev)(2 nev x 2 nev) of its Rayleigh-Ritz
    restarts (4 a solve)."""
    bs, size_x = nev // 5, 2 * nev
    m = size_x + 2 * bs
    return (m, bs, ((m, bs), (m - bs, bs), (bs, bs), (size_x, size_x)),
            ((m, size_x), (m, bs), (m - bs, bs), (bs, bs),
             (size_x, size_x)))


def eigenvector_classes(nev: int):
    """The expand classes of :func:`wide_classes` whose C is a block of the
    Rayleigh-Ritz eigenvectors (``c[:, :size_x]``, the restarts'
    (2 nev x 2 nev)): column-major, as ``torch.linalg.eigh`` returns them."""
    expands = wide_classes(nev)[3]
    return (expands[0], expands[-1])


def tall_paths_back_to_back(torch, n, width, grams, expands, gen,
                            col_major=()):
    """Kernels 3 and 4 at each class of ``grams`` and ``expands`` that takes
    the wide path, the narrow path (``path="narrow"``) against the wide one in
    turns (narrow, wide, wide, narrow), each a median of REPS after the L2
    flush, beside the library call of the same run and the bound.  The
    operands are the solver's views: columns of an (n, width) basis and a
    (k x q) block of a (width x width) matrix, column-major for the expand
    classes of ``col_major``."""
    from gcge_tpu_torch.ops import osgemm

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           device=DEVICE)

    basis, square = randn(n, width), randn(width, width)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    for kernel, classes in ((3, grams), (4, expands)):
        for p, q in classes:
            if osgemm.tall_path(p, q) != "wide":
                continue
            a = basis[:, :p]
            if kernel == 3:
                b = randn(n, q)
                shape = f"({p}x{q})"

                def fn(path, a=a, b=b):
                    return osgemm.tall_gram(a, b, path=path)

                def library(a=a, b=b):
                    return a.T @ b
            else:
                c = (square.T if (p, q) in col_major else square)[:p, :q]
                shape = f"(n x {p})({p} x {q})" + (
                    ", C column-major" if (p, q) in col_major else "")

                def fn(path, a=a, c=c):
                    return osgemm.tall_expand(a, c, path=path)

                def library(a=a, c=c):
                    return a @ c
            times = {"narrow": [], "wide": []}
            for path in ("narrow", "wide", "wide", "narrow"):
                times[path].append(median_ms(torch, lambda: fn(path),
                                             flush=flush))
            lib_ms = median_ms(torch, library, flush=flush)
            bound_ms, bound_by = bound(*tall_cost(n, p, q))
            wide_ms = min(times["wide"])
            print(f"kernel {kernel} {shape} n={n} back to back: the narrow path "
                  f"{times['narrow'][0]:.4f} / {times['narrow'][1]:.4f} ms, "
                  f"wide path {times['wide'][0]:.4f} / "
                  f"{times['wide'][1]:.4f} ms; library call {lib_ms:.4f} "
                  f"ms; bound {bound_ms:.4g} ms by {bound_by}; wide / "
                  f"library {wide_ms / lib_ms:.2f}, {100 * bound_ms / wide_ms:.0f}"
                  f" % of the bound")


# the device functions of csrc/tall_gemm.cu that a call of kernel 3 or 4
# launches
TALL_KERNEL_NAMES = ("tall_expand_wide", "tall_expand_dmma", "tall_gram_wide",
                     "tall_gram_dmma", "tall_gram_reduce")


def tall_phases(torch, gen):
    """Where a call of kernels 3 and 4 spends its device time at the widest
    classes (nev=400, n=85,184), by launch, under torch.profiler: kernel 4
    at (n x 960)(960 x 800) on the narrow path (its q-tile x k-chunk launches,
    by k-chunk: the first writes Y, the later ones read it back and add)
    and on the wide path; kernel 3 at (800 x 800) and (880 x 80), the
    partial sums against the chunk sum.  Then the narrow path's expand at one row tile
    a block (n = 64 x SMs), whose launches are its fixed cost: C staged
    into shared memory and the ring filled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gcge_tpu_torch.ops import _build, osgemm

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           device=DEVICE)

    n = C_REFERENCE[400][0] ** 3
    basis, square, other = randn(n, 960), randn(960, 960), randn(n, 800)
    tiny = 64 * _build.sm_count(torch.device(DEVICE))
    cases = (
        ("kernel 4 (n x 960)(960 x 800), C column-major", n, 960, 800,
         lambda path: osgemm.tall_expand(basis, square.T[:, :800],
                                         path=path)),
        ("kernel 3 (800 x 800)", n, 800, 800,
         lambda path: osgemm.tall_gram(basis[:, :800], other, path=path)),
        ("kernel 3 (880 x 80)", n, 880, 80,
         lambda path: osgemm.tall_gram(basis[:, :880], other[:, :80],
                                       path=path)),
        ("kernel 4 (n x 960)(960 x 800), one row tile a block", tiny, 960,
         800, lambda path: osgemm.tall_expand(basis[:tiny],
                                              square.T[:, :800], path=path)))
    for label, rows, p, q, fn in cases:
        library = (lambda: basis[:rows, :p] @ square.T[:p, :q]) \
            if label.startswith("kernel 4") else \
            (lambda: basis[:, :p].T @ other[:, :q])
        library()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            library()
            torch.cuda.synchronize()
        names = sorted({e.name for e in prof.events()
                        if e.device_type == DeviceType.CUDA})
        print(f"phases of {label} n={rows}, the library call's kernels: "
              + "; ".join(names))
        for path in ("narrow", "wide"):
            fn(path)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(path)
                torch.cuda.synchronize()
            runs = collections.defaultdict(list)
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    name = next((k for k in TALL_KERNEL_NAMES if k in e.name),
                                e.name[:60])
                    runs[name].append(e.time_range.elapsed_us())
            total = sum(sum(v) for v in runs.values())
            if not runs:                       # the profiler saw no kernel
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(path)
                end.record()
                end.synchronize()
                runs["(CUDA events, all launches)"] = [
                    1e3 * start.elapsed_time(end)]
                total = runs["(CUDA events, all launches)"][0]
            parts = "; ".join(
                f"{name} {len(us)} x, {sum(us) / 1e3:.4f} ms (mean "
                f"{np.mean(us) / 1e3:.4f}, min {min(us) / 1e3:.4f}, max "
                f"{max(us) / 1e3:.4f})" for name, us in runs.items())
            print(f"phases of {label} n={rows} on the {path} path: "
                  f"{total / 1e3:.4f} ms on the device: {parts}")
            if path == "narrow" and p * q > 128 * 128:
                plan = osgemm.expand_plan(rows, p, q, _build.sm_count(
                    torch.device(DEVICE)))
                k_chunks = -(-p // plan.k_chunk)
                launches = runs.get("tall_expand_dmma", [])
                if launches:
                    by_chunk = [np.mean(launches[i::k_chunks]) / 1e3
                                for i in range(k_chunks)]
                    print(f"phases of {label} n={rows}, the narrow path: "
                          f"{len(launches)} launches (q-tile {plan.q_tile}, "
                          f"k-chunk {plan.k_chunk}); mean ms by k-chunk "
                          + ", ".join(f"{t:.4f}" for t in by_chunk))


def phase_tall(torch, has_paths: bool):
    """``--tall``: kernels 3 and 4 alone, at every class of the nev=50
    headline solve and of the two production widths, against their plain
    versions, timed as in the kernel phases; with a package that has both
    paths, also the two paths back to back and the phases of both.  With
    ``--root DIR`` the package is imported from DIR (a parent commit
    unpacked there), so that two trees can be timed in one call."""
    log = KernelLog(torch)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    kernels_tall(torch, log, NX ** 3, gen, primary=True)
    for nev in WIDE_NEVS:
        m, _, grams, expands = wide_classes(nev)
        n = C_REFERENCE[nev][0] ** 3
        cols = eigenvector_classes(nev)
        kernels_tall(torch, log, n, gen, primary=False, grams=grams,
                     expands=expands, width=m, col_major=cols)
        if has_paths:
            tall_paths_back_to_back(torch, n, m, grams, expands, gen, cols)
    if has_paths:
        tall_phases(torch, gen)


# --------------------------------------------------------------------------
# kernels 1 and 2 alone (--dia): both paths at every operand a solve hands
# them
# --------------------------------------------------------------------------

def dia_paths(torch, values, offs, lib, halo, label, x, transposed,
              bound_ms):
    """Kernel 1 or 2 on ``values`` at the operand ``x`` on the narrow path
    and, where the wide path takes the layout, on the wide one, in turns
    (narrow, wide, wide, narrow; each a median of REPS after the L2 flush),
    beside the library call (``torch.sparse.mm`` of ``lib``) and
    ``bound_ms``, with the bits of the two paths compared (a difference
    raises); the ``after`` hook of :func:`spmm_rows`."""
    from gcge_tpu_torch.ops import spmm

    def kernel(path):
        return spmm.dia_spmm(values, offs, x, transposed, halo, path=path)

    m = x.shape[0] if transposed else x.shape[1]
    narrow = kernel("narrow")
    xs, ys = ((t.stride(1), t.stride(0)) if transposed else t.stride()
              for t in (x, narrow))
    plan = functools.partial(spmm.dia_plan, m, *xs, x.data_ptr() % 16, *ys,
                             narrow.data_ptr() % 16, x.element_size())
    chosen = "wide" if plan().wide else "narrow"
    try:
        plan(path="wide")
        paths = ("narrow", "wide")
    except ValueError:
        paths = ("narrow",)
    if len(paths) == 2 and not torch.equal(narrow, kernel("wide")):
        raise AssertionError(f"{label}: the narrow and the wide path differ")
    del narrow
    lib_x = (x.T if transposed else x).contiguous()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    times = {p: [] for p in paths}
    for p in paths + paths[::-1]:
        times[p].append(median_ms(torch, lambda: kernel(p), flush=flush))
    lib_ms = median_ms(torch, lambda: torch.sparse.mm(lib, lib_x),
                       flush=flush)
    parts = "; ".join(
        f"{p} {t[0]:.4f} / {t[1]:.4f} ms ({lib_ms / min(t):.2f} times as "
        f"fast as the library, {100 * bound_ms / min(t):.0f} % of the bound)"
        for p, t in times.items())
    speed = "" if len(paths) == 1 else \
        f"; wide {min(times['narrow']) / min(times['wide']):.2f} times " \
        "as fast as narrow, the same bits"
    print(f"dia paths {label}: the plan takes {chosen}; {parts}; library "
          f"{lib_ms:.4f} ms; bound {bound_ms:.4g} ms{speed}")


def dia_operator(torch, rows, cols, vals, n, dtype):
    """A DIA operator on the card and its library operand (a CSR tensor of
    the same values), both in ``dtype``; ``(values, offsets, lib, nnz)``."""
    import scipy.sparse as sps

    from gcge_tpu_torch import make_operator

    op = make_operator(rows, cols, vals, (n, n), device=DEVICE)
    a_csr = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    return (op.values.to(dtype), op.offsets_t, csr_tensor(torch, a_csr, dtype),
            a_csr.nnz)


class DiaCalls:
    """Counts the calls of kernel 1 (f64) and 2 (f32) by operand, and the
    iterations, of the solves run inside it: ``operators.dia_spmm`` (where
    ``DiaOperator`` reaches the wrapper) and ``gcg_solve`` are wrapped for
    its duration.  A replay of the captured CG stage calls no wrapper: the
    f32 count holds the capture and the eager stages only."""

    def __init__(self):
        self.calls = collections.Counter()
        self.iterations = 0

    def __enter__(self):
        from gcge_tpu_torch import api
        from gcge_tpu_torch.ops import operators
        from gcge_tpu_torch.solvers import gcg

        spmm_fn, solve = operators.dia_spmm, api.gcg_solve

        def counted(values, offsets, x, transposed=False, *args, **kwargs):
            m = x.shape[0] if transposed else x.shape[1]
            xs = (x.stride(1), x.stride(0)) if transposed else x.stride()
            dense = x.is_contiguous() or x.T.is_contiguous()
            what = ("dense" if dense else f"view, rows {xs[0]} apart") + \
                f", start {x.data_ptr() % 16} mod 16"
            self.calls[str(x.dtype).split(".")[1], m, what] += 1
            return spmm_fn(values, offsets, x, transposed, *args, **kwargs)

        def counted_solve(*args, **kwargs):
            res = solve(*args, **kwargs)
            self.iterations += res.num_iter
            return res

        self.saved = [(operators, "dia_spmm", spmm_fn),
                      (api, "gcg_solve", solve), (gcg, "gcg_solve", solve)]
        operators.dia_spmm = counted
        api.gcg_solve = gcg.gcg_solve = counted_solve
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def dia_solves(torch):
    """The headline solve, phased and fused (``fuse=20``), and the two wide
    solves (``utils.sweep`` rows at nev=200 and nev=400, warm-up and timed
    walls): iterations, converged count, and the calls of kernels 1 and 2
    by operand (a wide row's timed solve's, half of both)."""
    import gcge_tpu_torch
    from gcge_tpu_torch import make_operator
    from gcge_tpu_torch.utils import sweep

    def report(tag, calls, solves):
        for (dtype, m, what), count in sorted(calls.calls.items()):
            print(f"dia {tag}: {dtype} (n, {m}) {what}: "
                  f"{count / solves:g} calls a solve")

    _, a_csr = stencil(NX)
    for fuse in (0, 20):
        with DiaCalls() as calls:
            _, _, nev_conv = gcge_tpu_torch.solve(
                a_csr, None, verbose=0,
                **dict(HEADLINE_KWARGS, device=DEVICE, fuse=fuse))
        print(f"dia headline solve fuse={fuse}: {calls.iterations} "
              f"iterations, {nev_conv} converged")
        report(f"headline solve fuse={fuse}", calls, 1)
    for nev in WIDE_NEVS:
        nx = C_REFERENCE[nev][0]
        (rows, cols, vals, n), _ = stencil(nx)
        op = make_operator(rows, cols, vals, (n, n), device=DEVICE)
        params = sweep.production_params(nev, op)
        with DiaCalls() as calls:
            row = sweep.run_row(op, params)
        res = row.result
        print(f"dia wide solve nev={nev} (n={n}): warm-up {row.warmup_s:.3f}"
              f" s, timed {row.wall_s:.3f} s; {res.num_iter} iterations, "
              f"{res.nev_conv} converged")
        report(f"wide solve nev={nev}", calls, 2)


def phase_dia(torch, has_paths: bool):
    """``--dia``: kernels 1 and 2 alone at every operand a solve hands them,
    each against its plain version beside the library call
    (:func:`spmm_rows`) and, with a package that has both paths, on both in
    turns (:func:`dia_paths`): at the headline (n = 157,464) kernel 1's
    ``V[:, 110:120]`` (the W coupling), ``ritz[:, 40:60]`` and
    ``ritz[:, 41:61]`` (the phased loop's residual window at an even and
    an odd offset), ``(n, 10)`` (the inner solve's refresh),
    ``(n, 20)`` (the fused loop's gathered residual window) and
    ``V[:, :100]`` (the initial Rayleigh-Ritz), kernel 2's CG ``(10, n)``;
    a halo block of the headline operator; the FEM pair's level 0 (also
    PAS's ``(n, 75)`` and ``(n, 150)`` in f64); at both production widths
    the same operands at their widths.  Then the headline and the two wide
    solves (:func:`dia_solves`).  ``--root DIR`` (a parent tree, one path):
    the plan's choice only."""
    log = KernelLog(torch)
    gen = torch.Generator(device=DEVICE).manual_seed(15)

    def rows(values, offs, lib, nnz, cases, tag, halo=(0, 0), n_in=None,
             parents=None):
        f64 = values.dtype == torch.float64
        key = "dia_f64" if f64 else "dia_f32"
        spmm_rows(torch, log, key, *dia_pair(values, offs, halo),
                  values.shape[1], nnz,
                  values.element_size() * values.numel() + 4 * len(offs),
                  lib, cases, 1e-14 if f64 else 1e-5, gen, tag, n_in,
                  parents, after=functools.partial(
                      dia_paths, torch, values, offs, lib, halo)
                  if has_paths else None)

    def wide_cases(f64, bs, m, size_x):
        if not f64:
            return [f"cg{bs}"]
        return [f"V[:, {m - bs}:{m}]", f"ritz[:, 41:{41 + bs}]",
                f"(n, {bs})", f"(n, {2 * bs})", f"V[:, :{size_x}]"]

    (srows, scols, svals, n), _ = stencil(NX)
    for dtype in (torch.float64, torch.float32):
        values, offs, lib, nnz = dia_operator(torch, srows, scols, svals, n,
                                              dtype)
        f64 = dtype == torch.float64
        # the phased loop's residual window is 2 BS columns of the Ritz
        # block, at an even or an odd offset
        rows(values, offs, lib, nnz,
             ["V[:, 110:120]", "ritz[:, 40:60]", "ritz[:, 41:61]",
              f"(n, {BS})", f"(n, {2 * BS})", "V[:, :100]"] if f64
             else ["cg"], f" headline n={n}")
        # a halo block: the first of HALO_BLOCKS row blocks and its window,
        # (nw, 10) in memory as the sharded operator assembles it, zeros
        # before the operator's first row; kernel 2 at the CG stage's
        # layout, (10, nw) in shape
        hl, hr = -int(offs.min()), int(offs.max())
        ln = n // HALO_BLOCKS
        vb = values[:, :ln].contiguous()
        win = torch.randn((ln + hl + hr, BS), generator=gen, dtype=dtype,
                          device=DEVICE)
        win[:hl] = 0
        i = torch.arange(ln, device=DEVICE).repeat(vb.shape[0])
        j = i + hl + offs.long().repeat_interleave(ln)
        keep = vb.reshape(-1) != 0
        blib = torch.sparse_coo_tensor(
            torch.stack([i[keep], j[keep]]), vb.reshape(-1)[keep],
            (ln, ln + hl + hr)).coalesce().to_sparse_csr()
        rows(vb, offs, blib, int(keep.sum()),
             [("halo window", win, False) if f64 else
              ("CG halo window", win.T, True)],
             f" halo block ({ln} rows, halo ({hl}, {hr}))", (hl, hr),
             ln + hl + hr)
    fem_a, _ = build_fem(FEM_NX)
    coo = fem_a.tocoo()
    for dtype in (torch.float64, torch.float32):
        fn = fem_a.shape[0]
        values, offs, lib, nnz = dia_operator(torch, coo.row, coo.col,
                                              coo.data, fn, dtype)
        # PAS's blocks at level 0 (A and B both DIA there): its working
        # block and the span [X | N] of its Rayleigh-Ritz
        rows(values, offs, lib, nnz,
             ["V[:, 110:120]", f"(n, {BS})", f"(n, {PAS_WIDTH})",
              f"(n, {2 * PAS_WIDTH})"] if dtype == torch.float64 else ["cg"],
             f" FEM level 0 ({values.shape[0]} diagonals, n={fn})")
    del fem_a, coo
    for nev in WIDE_NEVS:
        m, bs = wide_classes(nev)[:2]
        (srows, scols, svals, n), _ = stencil(C_REFERENCE[nev][0])
        for dtype in (torch.float32, torch.float64):
            values, offs, lib, nnz = dia_operator(torch, srows, scols, svals,
                                                  n, dtype)
            rows(values, offs, lib, nnz,
                 wide_cases(dtype == torch.float64, bs, m, 2 * nev),
                 f" nev={nev} n={n}", parents={"V": m, "ritz": 2 * nev})
            del values, lib
    dia_solves(torch)


def phase_kernels_wide(torch, log, nev: int):
    """Kernels 1-4 at the shapes a solve with ``utils.sweep``'s settings for
    ``nev`` hands them, against their plain versions, beside the library
    call, as the headline rows: kernel 1 at the W coupling ``V[:, m - bs:
    m]`` of the (n, m) basis and at the residual window ``ritz[:, 41:41 +
    bs]`` of the (n, 2 nev) Ritz block, at an odd offset,
    kernel 2 at the CG's ``(bs, n)`` operand with strides ``(1, bs)``, each
    also on the narrow and the wide path in turns (:func:`dia_paths`), and
    kernels 3 and 4 at every shape class of :func:`wide_classes`."""
    from gcge_tpu_torch import make_operator

    nx = C_REFERENCE[nev][0]
    (rows, cols, vals, n), a_csr = stencil(nx)
    m, bs, grams, expands = wide_classes(nev)
    gen = torch.Generator(device=DEVICE).manual_seed(nev)
    op = make_operator(rows, cols, vals, (n, n), device=DEVICE)
    offs, ndiag = op.offsets_t, op.values.shape[0]
    tag = f" nev={nev} (nx={nx})"
    lib64 = csr_tensor(torch, a_csr, torch.float64)
    lib32 = csr_tensor(torch, a_csr, torch.float32)
    spmm_rows(torch, log, "dia_f64", *dia_pair(op.values, offs), n,
              a_csr.nnz, 8 * ndiag * n + 4 * ndiag, lib64,
              [f"V[:, {m - bs}:{m}]", f"ritz[:, 41:{41 + bs}]"], 1e-14, gen,
              tag=tag, parents={"V": m, "ritz": 2 * nev},
              after=functools.partial(dia_paths, torch, op.values, offs,
                                      lib64, (0, 0)))
    v32 = op.values.float()
    spmm_rows(torch, log, "dia_f32", *dia_pair(v32, offs), n, a_csr.nnz,
              4 * ndiag * n + 4 * ndiag, lib32, [f"cg{bs}"], 1e-5, gen,
              tag=tag, after=functools.partial(dia_paths, torch, v32, offs,
                                               lib32, (0, 0)))
    cols = eigenvector_classes(nev)
    kernels_tall(torch, log, n, gen, primary=False, grams=grams,
                 expands=expands, width=m, col_major=cols)
    tall_paths_back_to_back(torch, n, m, grams, expands, gen, cols)


def phase_wide(torch, log, nev: int):
    """One row of ``utils.sweep`` on the card: the 27-point stencil at the C
    reference's nx with ``sweep.production_params(nev, op)`` (block nev/5,
    nevMax 2 nev, tolerances 1 and 1e-8, fuse 5, the mixed inner CG), the
    untimed warm-up solve and the timed one; the headline gates on the
    first nev pairs, kernels 1-4 launched by both.  Returns the launches."""
    from gcge_tpu_torch import make_operator
    from gcge_tpu_torch.ops import eighs
    from gcge_tpu_torch.solvers import gcg
    from gcge_tpu_torch.utils import sweep

    nx, c_iters, c_conv, c_wall = C_REFERENCE[nev]
    (rows, cols, vals, n), a_csr = stencil(nx)
    m = wide_classes(nev)[0]
    op = make_operator(rows, cols, vals, (n, n), device=DEVICE)
    params = sweep.production_params(nev, op)
    tag = f"wide nev={nev}"
    reset_counters()
    gcg.GRAPH_REPLAYS["cg_stage"] = 0
    eighs.CALLS["safe_eigh"] = 0
    torch.cuda.reset_peak_memory_stats()
    with TallCalls() as tall:
        row = sweep.run_row(op, params)
    launches = read_counters()
    res = row.result
    iters = max(tall.iterations, 1)
    print(f"{tag} (nx={nx}, n={n}, block {row.block_size}, nevMax "
          f"{2 * nev}, m={m}, fuse {params.fuse}, cg_mixed "
          f"{params.cg_mixed}): warm-up solve {row.warmup_s:.3f} s, timed "
          f"solve {row.wall_s:.3f} s; {res.num_iter} iterations, "
          f"{res.nev_conv} converged (the C reference on one CPU core: "
          f"{c_iters} iterations, {c_conv} converged, {c_wall} s); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB")
    print(f"{tag}: over both solves ({tall.iterations} iterations): kernel "
          f"launches {launches} ("
          + ", ".join(f"{k} {v / iters:.1f}" for k, v in launches.items()
                      if v) + " an iteration), graph replays "
          f"{gcg.GRAPH_REPLAYS['cg_stage']}, host waits: safe_eigh "
          f"{eighs.CALLS['safe_eigh'] / iters:.2f} an iteration and one a "
          f"chunk of {params.fuse}")
    tall.report(tag, log, n)
    if res.nev_conv < nev:
        raise AssertionError(f"{tag}: nev_conv {res.nev_conv} < {nev}")
    stencil_gates(tag, a_csr, nx, nev, res.eval, res.evec)
    path_launched(tag, launches, ("dia_f64", "dia_f32", "gram", "expand"))
    return launches, res.eval


def write_mtx(path, rows, cols, vals, n):
    """A symmetric COO matrix as a MatrixMarket file (the lower triangle,
    symmetric storage)."""
    low = rows >= cols
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real symmetric\n")
        f.write(f"{n} {n} {int(low.sum())}\n")
        np.savetxt(f, np.column_stack([rows[low] + 1, cols[low] + 1,
                                       vals[low]]), fmt="%d %d %.17g")


def run_cli(argv):
    """``utils.cli.main(argv)`` on the card: its result, its printed lines
    (echoed here), its wall and the kernel launches of its solve."""
    import contextlib
    import io

    from gcge_tpu_torch.utils import cli

    reset_counters()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = cli.main(argv + ["-device", DEVICE])
    wall = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    for line in lines:
        print(f"  | {line}")
    return res, lines, wall, read_counters()


def phase_driver(torch, a_csr, rows, cols, vals, n, ev_headline, fem_a,
                 fem_b, ev_fem):
    """``utils.cli.main`` through the card on files: the headline stencil
    from a MatrixMarket file with the headline phase's parameters (the
    natural ordering kept; its eigenvalues within 1e-10 of the headline
    solve's, the headline gates), and the cube FEM pair from PETSc binary
    files with ``-shift`` (its eigenvalues less the shift within 1e-9 of
    ``solve(A, B, nev=50)``'s, ``ev_fem``).  Returns the launches of both
    runs by path."""
    import tempfile

    from gcge_tpu_torch.io.loaders import save_petsc_binary

    t0 = time.perf_counter()
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        mtx = os.path.join(tmp, f"stencil{NX}.mtx")
        write_mtx(mtx, rows, cols, vals, n)
        print(f"driver: wrote {mtx} ({os.path.getsize(mtx) / 2**20:.1f} "
              f"MiB) in {time.perf_counter() - t0:.1f} s")
        res, lines, wall, launches = run_cli([
            "-filename_matA", mtx, "-nevConv", str(NEV), "-blockSize",
            str(BS), "-gcge_max_niter", str(HEADLINE_KWARGS["max_iter"]),
            "-gcge_compW_cg_max_iter", str(HEADLINE_KWARGS["cg_max_iter"]),
            "-gcge_print_conv", "0", "-gcge_print_eval", "3"])
        tag = "driver (stencil .mtx)"
        rel = float(np.max(np.abs(res.eval[:NEV] - ev_headline[:NEV])
                           / np.abs(ev_headline[:NEV])))
        print(f"{tag}: wall {wall:.3f} s (file load and packing included), "
              f"{res.num_iter} iterations, nev_conv {res.nev_conv}, "
              f"eigenvalues vs the headline solve max rel diff {rel:.3e} "
              f"(tol 1e-10), launches {launches}")
        if not any(line.startswith("RCM skipped") for line in lines):
            raise AssertionError(f"{tag}: the natural ordering was not kept")
        if res.nev_conv < NEV or not rel <= 1e-10:
            raise AssertionError(f"{tag}: nev_conv {res.nev_conv}, "
                                 f"eigenvalues {rel:.3e} off")
        stencil_gates(tag, a_csr, NX, NEV, res.eval, res.evec)
        path_launched(tag, launches, ("dia_f64", "dia_f32", "gram",
                                      "expand"))
        paths["driver_stencil"] = launches

        files = []
        for name, mat in (("A", fem_a), ("B", fem_b)):
            coo = mat.tocoo()
            files.append(os.path.join(tmp, f"fem_{name}.petsc"))
            save_petsc_binary(files[-1], coo.row, coo.col, coo.data,
                              coo.shape)
        res, lines, wall, launches = run_cli([
            "-filename_matA", files[0], "-filename_matB", files[1],
            "-nevConv", str(NEV), "-shift", str(FEM_SHIFT),
            "-gcge_print_conv", "0", "-gcge_print_eval", "3"])
        tag = "driver (FEM pair, PETSc binary, -shift)"
        rel = float(np.max(np.abs(res.eval[:NEV] - FEM_SHIFT - ev_fem[:NEV])
                           / np.abs(ev_fem[:NEV])))
        print(f"{tag}: wall {wall:.3f} s, {res.num_iter} iterations, "
              f"nev_conv {res.nev_conv}, eigenvalues less {FEM_SHIFT} vs "
              f"solve(A, B) max rel diff {rel:.3e} (tol 1e-9), launches "
              f"{launches}")
        if res.nev_conv < NEV or not rel <= 1e-9:
            raise AssertionError(f"{tag}: nev_conv {res.nev_conv}, "
                                 f"eigenvalues {rel:.3e} off")
        path_launched(tag, launches, ("dia_f64", "gram", "expand"))
        paths["driver_fem"] = launches
    print(f"driver phase: {time.perf_counter() - t0:.1f} s")
    return paths


def drive_irregular_wide(torch, log, matrix, label, ev_irregular):
    """The irregular matrix ``matrix`` written to a MatrixMarket file and
    solved through ``utils.cli.main`` at nev=200, block 40 (nevMax 400,
    m=480) with the irregular cell's inner budget of 60: at least 200
    converged, host residuals of the first 200 pairs at most 2e-8 (in the
    ordering the driver chose), the first 50 eigenvalues within 1e-9 of the
    irregular phase's; iterations beside the C reference's.  Returns the
    driver's printed lines, its wall and launches, and the matrix in the
    driver's ordering as COO arrays and as scipy CSR."""
    import tempfile

    import scipy.sparse as sps

    from gcge_tpu_torch.io.native import (apply_permutation,
                                          load_matrix_market_native,
                                          rcm_permutation)

    nev, c_iters, c_conv, c_wall = IRREGULAR_WIDE
    bs = wide_classes(nev)[1]
    n = matrix.shape[0]
    tag = f"irregular nev={nev} (driver, {label})"
    t0 = time.perf_counter()
    coo = matrix.tocoo()
    with tempfile.TemporaryDirectory() as tmp:
        mtx = os.path.join(tmp, "delaunay.mtx")
        write_mtx(mtx, coo.row, coo.col, coo.data, n)
        print(f"{tag}: wrote {mtx} ({os.path.getsize(mtx) / 2**20:.1f} MiB)"
              f" in {time.perf_counter() - t0:.1f} s")
        torch.cuda.reset_peak_memory_stats()
        with TallCalls() as tall:
            res, lines, wall, launches = run_cli([
                "-filename_matA", mtx, "-nevConv", str(nev), "-blockSize",
                str(bs), "-gcge_compW_cg_max_iter",
                str(IRREGULAR_KWARGS["cg_max_iter"]), "-gcge_print_conv", "0",
                "-gcge_print_eval", "3"])
        # the driver's ordering, from the same file and the same toolkit
        rows, cols, vals, _ = load_matrix_market_native(mtx)
    if any(line.startswith("after RCM") for line in lines):
        rows, cols, vals = apply_permutation(rows, cols, vals,
                                             rcm_permutation(rows, cols, n))
    a_perm = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    tall.report(tag, log, n)
    layout = [line for line in lines if line.startswith("A layout")]
    print(f"{tag}: {layout}; wall {wall:.3f} s (file load, RCM and packing "
          f"included), {res.num_iter} iterations, nev_conv {res.nev_conv} "
          f"(the C reference on one CPU core: {c_iters} iterations, "
          f"{c_conv} converged, {c_wall} s); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches} (" + ", ".join(
              f"{k} {v / max(res.num_iter, 1):.1f}"
              for k, v in launches.items() if v) + " an iteration)")
    if res.nev_conv < nev:
        raise AssertionError(f"{tag}: nev_conv {res.nev_conv} < {nev}")
    resid = residuals(a_perm, res.eval[:nev], res.evec[:, :nev].cpu().numpy())
    rel = float(np.max(np.abs(res.eval[:NEV] - ev_irregular[:NEV])
                       / np.abs(ev_irregular[:NEV])))
    print(f"{tag}: host residuals max {resid.max():.3e} (tol 2e-8); the "
          f"first {NEV} eigenvalues vs the irregular phase's max rel diff "
          f"{rel:.3e} (tol 1e-9)")
    if not resid.max() <= 2e-8 or not rel <= 1e-9:
        raise AssertionError(f"{tag}: residual {resid.max():.3e} or "
                             f"eigenvalues {rel:.3e} off")
    return lines, wall, launches, (rows, cols, vals), a_perm


def phase_irregular_wide(torch, log, a, a_rcm, ev_irregular):
    """The irregular matrix at nev=200 through the driver
    (:func:`drive_irregular_wide`), first in the irregular phase's RCM
    ordering, ``a_rcm``, which the driver must pack as CSR; then kernels 6
    and 5 timed at the operands that solve hands them: ``V[:, 440:480]``
    of the (n, 480) basis and the CG's ``(40, n)``, on each tile path in
    turns (:func:`csr_tile_paths`).  Then in its mesh
    ordering, ``a``, as a user would pass it: 119 diagonals, which the
    driver's RCM rule (``gcge_solve.py``'s, with its cap of 65 diagonals)
    keeps and ``make_operator`` packs as DIA (up to 128 diagonals); its
    wall and layout beside the first run's.  Returns the launches of both
    runs."""
    from gcge_tpu_torch import make_operator

    nev = IRREGULAR_WIDE[0]
    m, bs = wide_classes(nev)[:2]
    n = a_rcm.shape[0]
    lines, wall_rcm, launches, (rows, cols, vals), a_perm = \
        drive_irregular_wide(torch, log, a_rcm, "RCM ordering", ev_irregular)
    if "A layout: CsrOperator, B = I" not in lines:
        raise AssertionError("irregular wide: the driver did not pack the "
                             "RCM-ordered A as CSR")
    path_launched(f"irregular nev={nev} (RCM ordering)", launches,
                  ("gram", "expand", "mask_probe") + csr_keys(bs))
    gen = torch.Generator(device=DEVICE).manual_seed(nev)
    op = make_operator(rows, cols, vals, (n, n), device=DEVICE)
    tag = f" irregular nev={nev}"
    for vals, case, tol, parents in (
            (op.values, f"V[:, {m - bs}:{m}]", 1e-14, {"V": m}),
            (op.values.float(), f"cg{bs}", 1e-5, None)):
        csr_rows(torch, log, op, vals, a_perm, [case], tol, gen, tag,
                 parents, functools.partial(csr_tile_paths, torch, op, vals,
                                            a_perm))
    del op
    lines, wall_mesh, natural, _, _ = drive_irregular_wide(
        torch, log, a, "mesh ordering", ev_irregular)
    path_launched(f"irregular nev={nev} (mesh ordering)", natural,
                  ("gram", "expand"))
    said = [line.split(":")[0] for line in lines
            if line.startswith(("after RCM", "RCM skipped"))] + \
        [line for line in lines if line.startswith("A layout")]
    print(f"irregular nev={nev}: the driver's wall in the mesh ordering "
          f"{wall_mesh:.3f} s ({'; '.join(said)}) against {wall_rcm:.3f} s "
          f"in the RCM ordering (CsrOperator)")
    return launches, natural


# --------------------------------------------------------------------------
# the projected eigensolvers: the Jacobi kernel, and the 'jacobi' and
# 'newton' backends on the main path
# --------------------------------------------------------------------------

# the sweep cap of the kernel rows: eigh_newton's cluster-stage polish
JACOBI_SWEEPS = 4
# the production width at which the default run drives the 'newton' backend
# with the structural warm start (--eigh adds nev=400)
EIGH_NEV = 200


def jacobi_operand(torch, me: int, batch: int, noise: float, seed: int):
    """``(h, u0, h1)`` for a kernel row: ``batch`` random symmetric ``h`` of
    order ``me`` on the card, ``u0`` their eigenvectors from the card's
    ``eigh`` (as the solves' polish gets them) rotated by a random skew of
    ``noise`` (the TPU's f32-accurate back-transform is 1e-6), and the
    kernel's operand ``h1 = u0^T h u0``, symmetrized, as ``jacobi_polish``
    builds it."""
    f64 = dict(dtype=torch.float64, device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    a = torch.randn((batch, me, me), generator=g, **f64)
    h = a + a.transpose(-2, -1)
    _, u0 = torch.linalg.eigh(h)
    if noise:
        s = noise * torch.randn((batch, me, me), generator=g, **f64)
        u0 = u0 @ torch.linalg.qr(torch.eye(me, **f64)
                                  + 0.5 * (s - s.transpose(-2, -1))).Q
    h1 = u0.transpose(-2, -1) @ h @ u0
    return h, u0, 0.5 * (h1 + h1.transpose(-2, -1))


JACOBI_CASES = (  # label, me, batch, warm-start error, primary
    ("120, the card's eigh warm start", 120, 1, 0.0, True),
    ("120, warm start 1e-6 off", 120, 1, 1e-6, False),
    ("80, warm start 1e-6 off", 80, 1, 1e-6, False),
    ("160, warm start 1e-6 off", 160, 1, 1e-6, False),
    ("240, warm start 1e-6 off", 240, 1, 1e-6, False),
    ("64 blocks of 64, warm start 1e-6 off", 64, 64, 1e-6, False),
    ("8 blocks of 480, warm start 1e-6 off", 480, 8, 1e-6, False),
    ("480, warm start 1e-6 off", 480, 1, 1e-6, False),
    ("8 blocks of 512, warm start 1e-6 off", 512, 8, 1e-6, False),
    ("960, warm start 1e-6 off", 960, 1, 1e-6, False))
# the cluster sizes --jacobi times at each operand beside the plan's
JACOBI_SIZES = (1, 2, 4, 8, 16)


def jacobi_digest(*tensors) -> str:
    """The first 16 hex digits of a SHA-256 of the tensors' bytes."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def phase_kernels_jacobi(torch, log, sizes=False):
    """The Jacobi kernel against its plain version (bit for bit, the same
    sweep counts) and beside ``torch.linalg.eigh`` of the same matrices (the
    one library call for the same function), at the shapes the solves give
    it: one matrix of 120 (the 'jacobi' headline's projected problem), 80
    and 160 (the structural warm start's 2 bs at nev=200 and 400), 240,
    480 and 960 (the 'jacobi' backend's matrix at nev=200 and 400), a
    batch of 64 blocks of 64 (eigh_newton's cluster stage) and of 8 blocks
    of 480 and of 512 (its closing stage at nev=200 and 400, blocks of
    min(512, m)); h1 and v bit for bit the plain version's, its
    eigenvalues within 1e-12 ||H|| of the plain version's and of
    ``eigvalsh``, ``||U^T U - I|| <= 1e-12``.  Each row prints the launch
    plan (cluster size C, rows a block, threads, where H's buffers and V
    live) and the time a round (the kernel's time over the most sweeps
    of the batch times me - 1 rounds).  The bound counts the sweeps this
    run's data took, 9 me^3 operations each, at the f64 rate, or the bytes
    of h1 in and h1 and v out.  ``sizes``: also each cluster size of
    :data:`JACOBI_SIZES` that fits the card beside the plan's, with the
    plan's bits (median of 5 after the flush)."""
    from gcge_tpu_torch.ops import _build, eighs

    sms = _build.sm_count(torch.device(DEVICE))
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEVICE) \
        if sizes else None
    for label, me, batch, noise, primary in JACOBI_CASES:
        h, u0, h1 = jacobi_operand(torch, me, batch, noise, me + batch)
        plan = eighs.jacobi_card_plan(me, batch, DEVICE)
        hk, vk, kk = eighs.jacobi_sweeps(h1, JACOBI_SWEEPS)
        hp, vp, kp = eighs.jacobi_sweeps_plain(h1, JACOBI_SWEEPS)
        w = hk.diagonal(dim1=-2, dim2=-1).sort(-1).values
        w_plain = hp.diagonal(dim1=-2, dim2=-1).sort(-1).values
        w_lib = torch.linalg.eigvalsh(h)
        norm = float(w_lib.abs().max())
        u = u0 @ vk
        eye = torch.eye(me, dtype=torch.float64, device=DEVICE)
        errs = (float((w - w_plain).abs().max()) / norm,
                float((w - w_lib).abs().max()) / norm,
                float((u.transpose(-2, -1) @ u - eye).abs().max()))
        bits = torch.equal(hk, hp) and torch.equal(vk, vp)
        sweeps = kk.tolist()
        print(f"kernel jacobi {label}: sweeps {sorted(set(sweeps))} (plain "
              f"{sorted(set(kp.tolist()))}), eigenvalues vs plain "
              f"{errs[0]:.3e}, vs eigvalsh {errs[1]:.3e} of ||H|| (tol "
              f"1e-12), ||U^T U - I|| {errs[2]:.3e} (tol 1e-12), h1 and v "
              f"{'bit for bit' if bits else 'NOT bit for bit'} the plain "
              f"version's")
        if not torch.equal(kk, kp):
            raise AssertionError(f"jacobi {label}: sweep counts differ")
        if not bits:
            raise AssertionError(f"jacobi {label}: h1 or v differs from the "
                                 f"plain version's")
        if not max(errs) <= 1e-12:
            raise AssertionError(f"jacobi {label}: errors {errs} > 1e-12")
        if noise and min(sweeps) == 0:
            raise AssertionError(f"jacobi {label}: no sweep ran")
        log.run("jacobi", f"jacobi {label} (h1 out)",
                lambda: eighs.jacobi_sweeps(h1, JACOBI_SWEEPS)[0],
                lambda: eighs.jacobi_sweeps_plain(h1, JACOBI_SWEEPS)[0],
                1.0, 0, 3 * 8 * batch * me * me,
                9 * sum(sweeps) * (me - 1) * me * me,
                library=lambda: torch.linalg.eigh(h), primary=primary,
                plain_reps=3 if me >= 480 else REPS)
        rounds = max(sweeps) * (me - 1)
        last = log.last
        place = ", ".join(f"{name} in {'shared' if on else 'device'} memory"
                          for name, on in (("H's buffers", plan.h_shared),
                                           ("V", plan.v_shared)))
        per_round = f"{1e3 * last['ms'] / rounds:.3f}" if rounds else "-"
        held = eighs.jacobi_resident(torch.cuda.current_device(), plan)
        print(f"kernel jacobi {label}: plan C={plan.cluster} (a cluster of "
              f"{plan.cluster} blocks a matrix, {batch * plan.cluster} of "
              f"{sms} SMs; the card holds {held} such clusters at once), "
              f"{plan.rows} rows a block, {plan.threads} "
              f"threads, {plan.smem} bytes of shared memory, {place}; "
              f"{last['ms']:.4f} ms, {per_round} us a round over {rounds} "
              f"rounds; torch.linalg.eigh {last['library_ms']:.4f} ms "
              f"(kernel / library {last['ms'] / last['library_ms']:.3f}), "
              f"bound {last['bound_ms']:.4g} ms")
        if not sizes:
            continue
        times = {}
        for c in JACOBI_SIZES:
            if batch * c > sms:
                continue
            got = eighs.jacobi_sweeps(h1, JACOBI_SWEEPS, cluster=c)
            if not all(torch.equal(a, b) for a, b in zip(got, (hk, vk, kk))):
                raise AssertionError(f"jacobi {label}: the bits at C={c} "
                                     f"differ from the plan's")
            times[c] = median_ms(torch, lambda c=c: eighs.jacobi_sweeps(
                h1, JACOBI_SWEEPS, cluster=c), reps=5, flush=flush)
        print(f"kernel jacobi {label}: cluster sizes (the plan's bits at "
              f"each; ms, us a round): " + "; ".join(
                  f"C={c} {t:.4f} ms, {1e3 * t / max(rounds, 1):.3f} us"
                  for c, t in times.items()))


def eigh_turn(torch):
    """``--eigh-turn``: one turn of ``--eigh --root``, in a process of its
    own (the package from ``--root`` or beside this script): the Jacobi
    kernel at every operand of :data:`JACOBI_CASES` (median of
    :data:`REPS` after the flush, a digest of h1, v and the sweep counts),
    then the nev=200 'newton' row with the structural warm start (a
    warm-up solve, then the timed one: wall, iterations, count, a digest
    of the eigenvalues and eigenvectors); one ``EIGH_TURN`` JSON line."""
    from gcge_tpu_torch import gcg_solve, make_operator
    from gcge_tpu_torch.ops import eighs
    from gcge_tpu_torch.utils import sweep

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    out = {"kernels": {}}
    for label, me, batch, noise, _ in JACOBI_CASES:
        _, _, h1 = jacobi_operand(torch, me, batch, noise, me + batch)
        hk, vk, kk = eighs.jacobi_sweeps(h1, JACOBI_SWEEPS)
        ms = median_ms(torch, lambda: eighs.jacobi_sweeps(h1, JACOBI_SWEEPS),
                       flush=flush)
        out["kernels"][label] = {"ms": ms, "sweeps": max(kk.tolist()),
                                 "digest": jacobi_digest(hk, vk, kk)}
    del flush
    nev = EIGH_NEV
    nx = C_REFERENCE[nev][0]
    (rows, cols, vals, n), _ = stencil(nx)
    op = make_operator(rows, cols, vals, (n, n), device=DEVICE)
    params = dataclasses.replace(sweep.production_params(nev, op),
                                 rr_backend="newton", rr_warm="struct")
    gcg_solve(op, None, params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gcg_solve(op, None, params)
    torch.cuda.synchronize()
    out["solve"] = {"wall": time.perf_counter() - t0,
                    "iterations": res.num_iter, "converged": res.nev_conv,
                    "digest": jacobi_digest(torch.as_tensor(res.eval),
                                            res.evec)}
    print("EIGH_TURN " + json.dumps(out))


def phase_eigh_turns(card, parent):
    """``--eigh --root DIR``: :func:`eigh_turn` for the parent's package
    (DIR) and this tree's, in turns (parent, tree, tree, parent), each a
    process of its own on the same card: the kernel's times beside each
    other and the 'newton' nev=200 solve's walls; raises unless every turn
    has the same kernel bits and sweep counts and the same solve bits,
    iterations and count."""
    turns = []
    for name in ("parent", "tree", "tree", "parent"):
        cmd = [sys.executable, os.path.abspath(__file__), "--eigh-turn"]
        if name == "parent":
            cmd += ["--root", os.path.abspath(parent)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900, cwd=HERE)
        lines = [line for line in proc.stdout.splitlines()
                 if line.startswith("EIGH_TURN ")]
        if proc.returncode != 0 or not lines:
            raise AssertionError(f"--eigh-turn ({name}) failed "
                                 f"({proc.returncode}):\n"
                                 f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        turns.append((name, json.loads(lines[-1][len("EIGH_TURN "):])))
    first = turns[0][1]
    for label, *_ in JACOBI_CASES:
        ref = first["kernels"][label]
        times = collections.defaultdict(list)
        for name, turn in turns:
            got = turn["kernels"][label]
            if (got["digest"], got["sweeps"]) != (ref["digest"],
                                                   ref["sweeps"]):
                raise AssertionError(f"jacobi {label}: the {name}'s bits or "
                                     f"sweeps differ from the parent's")
            times[name].append(round(got["ms"], 4))
        print(f"kernel jacobi {label} in turns (parent, tree, tree, parent; "
              f"{card}): parent {times['parent']} ms, tree {times['tree']} "
              f"ms; the same bits and sweeps ({ref['sweeps']}) in every turn")
    ref = first["solve"]
    walls = collections.defaultdict(list)
    for name, turn in turns:
        got = turn["solve"]
        for key in ("digest", "iterations", "converged"):
            if got[key] != ref[key]:
                raise AssertionError(f"nev={EIGH_NEV} 'newton': the {name}'s "
                                     f"{key} {got[key]} differs from the "
                                     f"parent's {ref[key]}")
        walls[name].append(round(got["wall"], 3))
    print(f"wide nev={EIGH_NEV} rr_backend='newton' timed walls in turns "
          f"(parent, tree, tree, parent; {card}): parent {walls['parent']} s, "
          f"tree {walls['tree']} s; {ref['iterations']} iterations, "
          f"{ref['converged']} converged, the same bits in every turn")


@contextlib.contextmanager
def struct_warm_counter():
    """Counts the structural warm starts a solve offers its Rayleigh-Ritz
    steps (``gcg._rr_struct_warm``) and how many of them were taken (the
    premise held)."""
    from gcge_tpu_torch.solvers import gcg

    counts = collections.Counter()
    warm = gcg._rr_struct_warm

    def counted(*args):
        out = warm(*args)
        counts["offered"] += 1
        counts["taken"] += bool(out[3])
        return out

    gcg._rr_struct_warm = counted
    try:
        yield counts
    finally:
        gcg._rr_struct_warm = warm


def reset_waits():
    from gcge_tpu_torch.ops import eighs

    for key in eighs.CALLS:
        eighs.CALLS[key] = 0


def waits() -> int:
    """The host's waits for the card counted since :func:`reset_waits`:
    every ``safe_eigh`` call and every host-backend eigh."""
    from gcge_tpu_torch.ops import eighs

    return sum(eighs.CALLS.values())


def walls_in_turns(torch, solvers, turns=("auto", "new", "new", "auto")):
    """The walls of ``solvers[name]()`` (each ends in a wait for the card)
    in the order ``turns``: ``{name: [s, ...]}``."""
    walls = collections.defaultdict(list)
    for name in turns:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solvers[name]()
        torch.cuda.synchronize()
        walls[name].append(round(time.perf_counter() - t0, 3))
    return dict(walls)


def eigh_solve_gates(tag, a_csr, nx, nev, res_eval, res_evec, conv,
                     ev_auto):
    """The headline gates on the first ``nev`` pairs, and their eigenvalues
    within 1e-9 of the same solve with ``rr_backend='auto'``."""
    if conv < nev:
        raise AssertionError(f"{tag}: nev_conv {conv} < {nev}")
    stencil_gates(tag, a_csr, nx, nev, res_eval, res_evec)
    rel = float(np.max(np.abs(res_eval[:nev] - ev_auto[:nev])
                       / np.abs(ev_auto[:nev])))
    print(f"{tag}: eigenvalues vs rr_backend='auto' max rel diff {rel:.3e} "
          f"(tol 1e-9)")
    if not rel <= 1e-9:
        raise AssertionError(f"{tag}: eigenvalues differ from 'auto'")


def phase_jacobi_headline(torch, a_csr, ev_auto):
    """The headline solve with ``rr_backend='jacobi'`` through ``solve``,
    by the phased loop and the fused one (``fuse=20``), each under the
    headline gates and within 1e-9 of the 'auto' solve; iterations, waits
    and Jacobi launches an iteration; the phased walls in turns with the
    'auto' solve; then one fused chunk under the sync check."""
    import gcge_tpu_torch

    out = {}
    for fuse, key in ((0, "jacobi_headline"),
                      (HEADLINE_FUSE, "jacobi_fused_headline")):
        tag = f"headline rr_backend='jacobi' (fuse={fuse})"
        reset_counters()
        reset_waits()
        t0 = time.perf_counter()
        with TallCalls() as tall:
            ev, evec, conv = gcge_tpu_torch.solve(
                a_csr, None, verbose=0, rr_backend="jacobi",
                **dict(HEADLINE_KWARGS, device=DEVICE, fuse=fuse))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
        iters = max(tall.iterations, 1)
        print(f"{tag}: wall {wall:.3f} s, {tall.iterations} iterations, "
              f"nev_conv {conv}; waits {waits() / iters:.2f} an iteration "
              f"(safe_eigh), Jacobi launches {launches['jacobi']} "
              f"({launches['jacobi'] / iters:.2f} an iteration)")
        eigh_solve_gates(tag, a_csr, NX, NEV, ev, evec, conv, ev_auto)
        path_launched(tag, launches, ("jacobi", "dia_f64", "gram",
                                      "expand"))
        out[key] = launches

    def run(backend):
        return lambda: gcge_tpu_torch.solve(
            a_csr, None, verbose=0, rr_backend=backend,
            **dict(HEADLINE_KWARGS, device=DEVICE, fuse=0))

    walls = walls_in_turns(torch, {"auto": run("auto"),
                                   "new": run("jacobi")})
    print(f"headline phased walls in turns (auto, jacobi, jacobi, auto): "
          f"auto {walls['auto']} s, jacobi {walls['new']} s")
    phase_sync_check(torch, "headline, rr_backend='jacobi'",
                     lambda steps: gcge_tpu_torch.solve(
                         a_csr, None, verbose=0, rr_backend="jacobi",
                         **dict(HEADLINE_KWARGS, device=DEVICE, fuse=steps,
                                max_iter=steps)))
    return out


def phase_newton_wide(torch, log, nev: int, ev_auto):
    """One ``utils.sweep`` row at ``nev`` with ``rr_backend='newton'`` and
    the structural warm start (the sweep's own fused loop, then the phased
    loop): the headline gates on the first nev pairs, eigenvalues within
    1e-9 of the 'auto' row's; iterations, waits an iteration beside the
    'auto' row's, Jacobi launches, and how many Rayleigh-Ritz steps took
    the warm start (its premise, the X-W coupling below 2 % of the spread,
    holds) of those that offered it; the timed walls in turns with the 'auto' row; then one
    fused chunk under the sync check."""
    from gcge_tpu_torch import gcg_solve, make_operator
    from gcge_tpu_torch.ops import eighs
    from gcge_tpu_torch.utils import sweep

    nx = C_REFERENCE[nev][0]
    (rows, cols, vals, n), a_csr = stencil(nx)
    op = make_operator(rows, cols, vals, (n, n), device=DEVICE)
    auto = sweep.production_params(nev, op)
    newton = dataclasses.replace(auto, rr_backend="newton",
                                 rr_warm="struct")
    out, rows_ = {}, {}
    for params, key in ((newton, f"newton_{nev}"),
                        (dataclasses.replace(newton, fuse=0),
                         f"newton_{nev}_phased")):
        tag = f"wide nev={nev} rr_backend='newton' (fuse={params.fuse})"
        reset_counters()
        reset_waits()
        eighs.NEWTON.update(calls=0, closing_rounds=0)
        with TallCalls() as tall, struct_warm_counter() as warm:
            row = sweep.run_row(op, params)
        launches = read_counters()
        res = row.result
        iters = max(tall.iterations, 1)
        print(f"{tag}: warm-up solve {row.warmup_s:.3f} s, timed solve "
              f"{row.wall_s:.3f} s; {res.num_iter} iterations, "
              f"{res.nev_conv} converged; over both solves "
              f"({tall.iterations} iterations): waits {waits() / iters:.2f} "
              f"an iteration (safe_eigh), Jacobi launches "
              f"{launches['jacobi']} ({launches['jacobi'] / iters:.2f} an "
              f"iteration), structural warm start taken {warm['taken']} of "
              f"{warm['offered']} Rayleigh-Ritz steps; Newton eighs "
              f"{eighs.NEWTON['calls']}, their closing rounds "
              f"{eighs.NEWTON['closing_rounds']}")
        eigh_solve_gates(tag, a_csr, nx, nev, res.eval, res.evec,
                         res.nev_conv, ev_auto)
        path_launched(tag, launches, ("jacobi", "dia_f64", "gram",
                                      "expand"))
        # every step after the first offers the warm start (its (2 bs)^2
        # eigh and polish run); it is taken where gcge_tpu's premise holds
        if warm["offered"] <= 0:
            raise AssertionError(f"{tag}: no structural warm start")
        out[key], rows_[key] = launches, res

    counts = {}

    def run(params, name):
        def solve():
            reset_waits()
            res = gcg_solve(op, None, params)
            counts[name] = (res.num_iter, waits())
        return solve

    walls = walls_in_turns(torch, {"auto": run(auto, "auto"),
                                   "new": run(newton, "new")})
    print(f"wide nev={nev} timed walls in turns (auto, newton, newton, "
          f"auto; fuse {auto.fuse}): auto {walls['auto']} s, newton "
          f"{walls['new']} s; iterations and waits an iteration: auto "
          f"{counts['auto'][0]}, {counts['auto'][1] / counts['auto'][0]:.2f}"
          f"; newton {counts['new'][0]}, "
          f"{counts['new'][1] / counts['new'][0]:.2f}")
    phase_sync_check(torch, f"nev={nev}, rr_backend='newton'",
                     lambda steps: gcg_solve(op, None, dataclasses.replace(
                         newton, fuse=steps, max_iter=steps)))
    fused = types.SimpleNamespace(op=op, a_csr=a_csr, nx=nx, params=newton,
                                  result=rows_[f"newton_{nev}"],
                                  ev_auto=ev_auto)
    return out, fused


def phase_eigh_alone(torch):
    """``--eigh``: the Jacobi kernel rows, the 'newton' row with the
    structural warm start at nev=400 (m=960) beside the 'auto' row; and
    the 'auto' nev=400 row's InitializeX (its 800-column block through
    orth_block's eigh_newton) with its wall."""
    from gcge_tpu_torch import gcg_solve, make_operator
    from gcge_tpu_torch.ops import eighs
    from gcge_tpu_torch.utils import sweep

    nev = WIDE_NEVS[-1]
    nx = C_REFERENCE[nev][0]
    (rows, cols, vals, n), a_csr = stencil(nx)
    op = make_operator(rows, cols, vals, (n, n), device=DEVICE)
    auto = sweep.production_params(nev, op)
    row = sweep.run_row(op, auto)
    res = row.result
    print(f"wide nev={nev} rr_backend='auto': warm-up {row.warmup_s:.3f} s, "
          f"timed {row.wall_s:.3f} s, InitializeX {res.timers['initX']:.3f} "
          f"s of the timed solve; {res.num_iter} iterations, "
          f"{res.nev_conv} converged")
    if res.nev_conv < nev:
        raise AssertionError(f"nev={nev}: nev_conv {res.nev_conv} < {nev}")
    stencil_gates(f"wide nev={nev}", a_csr, nx, nev, res.eval, res.evec)
    for _ in range(2):
        t0 = time.perf_counter()
        again = gcg_solve(op, None, auto)
        torch.cuda.synchronize()
        print(f"wide nev={nev} rr_backend='auto' again: wall "
              f"{time.perf_counter() - t0:.3f} s, InitializeX "
              f"{again.timers['initX']:.3f} s")
    phase_kernels_jacobi(torch, KernelLog(torch))
    phase_newton_wide(torch, None, nev, res.eval)


@contextlib.contextmanager
def projected_capture(orders, keep: int = 3):
    """Copies of the projected matrices that Rayleigh-Ritz steps hand to
    ``eigh`` while it is open: ``{m: h}``, the ``keep``-th of each order in
    ``orders`` (a step past InitializeX's with its P block filled)."""
    from gcge_tpu_torch.solvers import gcg

    eigh = gcg.eigh
    seen, kept = collections.Counter(), {}

    def capture(h, *args, **kwargs):
        m = h.shape[0]
        if m in orders:
            seen[m] += 1
            if seen[m] == keep:
                kept[m] = h.clone()
        return eigh(h, *args, **kwargs)

    gcg.eigh = capture
    try:
        yield kept
    finally:
        gcg.eigh = eigh


def newton_mesh_eighs(torch, card, projected, orders, row, grid):
    """``eigh_newton`` of each captured projected matrix (one of each order
    in ``orders``, else it raises) without a mesh, on the one-rank row mesh
    and on the (1, 1) grid: the same bits, both outputs; the gathers and
    broadcasts a call, the products' widths, the blocks' slices and the
    closing rounds; the walls in turns (none, row, grid, grid, row,
    none)."""
    from gcge_tpu_torch.ops import eighs

    if set(projected) != set(orders):
        raise AssertionError(f"projected matrices of orders "
                             f"{sorted(projected)} captured, {sorted(orders)} "
                             f"expected")
    meshes = {"row mesh": row, "(1, 1) grid": grid}
    for m, h in sorted(projected.items()):
        w0, u0 = eighs.eigh_newton(h)
        for name, mesh in meshes.items():
            eighs.NEWTON.update(calls=0, closing_rounds=0, gathers=0,
                                broadcasts=0)
            for widths in eighs.SPLIT.values():
                widths.clear()
            w, u = eighs.eigh_newton(h, mesh=mesh)
            counts = dict(eighs.NEWTON, **eighs.SPLIT)
            wc, uc = eighs.eigh_newton(h, mesh=mesh, out="cols")
            bits = (torch.equal(w, w0) and torch.equal(u, u0)
                    and torch.equal(wc, w0) and torch.equal(uc, u0))
            print(f"eigh_newton m={m} on the one-rank {name} ({card}): "
                  f"{'the same bits as' if bits else 'NOT the bits of'} "
                  f"mesh=None, out='cols' too; a call {counts['gathers']} "
                  f"gathers, {counts['broadcasts']} broadcast, products by "
                  f"columns {counts['cols']}, block eighs by blocks "
                  f"{counts['blocks']}, closing rounds "
                  f"{counts['closing_rounds']}")
            if not bits:
                raise AssertionError(f"eigh_newton m={m}, {name}: not "
                                     f"mesh=None's bits")
            if counts["gathers"] <= 0 or set(counts["cols"]) != {m}:
                raise AssertionError(f"eigh_newton m={m}, {name}: the "
                                     f"partition did not run")
        walls = walls_in_turns(torch, {
            name: functools.partial(eighs.eigh_newton, h, mesh=mesh)
            for name, mesh in dict(meshes, none=None).items()},
            turns=("none", "row mesh", "(1, 1) grid", "(1, 1) grid",
                   "row mesh", "none"))
        print(f"eigh_newton m={m} walls in turns ({card}): " + "; ".join(
            f"{k} {vs} s" for k, vs in walls.items()))


def phase_newton_mesh(torch, card, projected, orders, fused):
    """Phase 23 on a one-rank NCCL group: :func:`newton_mesh_eighs`, then
    phase 22's fused nev=200 'newton' row (``fused``) through
    ``gcg_solve(..., mesh=row_mesh())``: its bits, iterations and count,
    the headline gates and eigenvalues within 1e-9 of the 'auto' row's,
    waits an iteration, the walls in turns with the solve without a mesh;
    then one fused chunk under the sync check.  Returns the solve's
    launches."""
    import torch.distributed as dist

    from gcge_tpu_torch import gcg_solve
    from gcge_tpu_torch.parallel import (bootstrap, grid_mesh, row_mesh,
                                         shard_operator)

    t_phase = time.perf_counter()
    bootstrap(f"tcp://127.0.0.1:{_free_port()}", 1, 0, DEVICE)
    try:
        row, grid = row_mesh(), grid_mesh(1, 1)
        grid.warm()
        newton_mesh_eighs(torch, card, projected, orders, row, grid)
        nev = fused.params.nev
        tag = f"wide nev={nev} rr_backend='newton' on the one-rank row mesh"
        sharded = shard_operator(fused.op, row)
        reset_counters()
        reset_waits()
        res = gcg_solve(sharded, None, fused.params, mesh=row)
        torch.cuda.synchronize()
        launches, n_waits = read_counters(), waits()
        plain = fused.result
        bits = np.array_equal(res.eval, plain.eval) and \
            torch.equal(res.evec, plain.evec)
        print(f"{tag} ({card}): {res.num_iter} iterations (undistributed "
              f"{plain.num_iter}), nev_conv {res.nev_conv} (undistributed "
              f"{plain.nev_conv}), "
              f"{'the same bits' if bits else 'NOT the same bits'}; waits "
              f"{n_waits / res.num_iter:.2f} an iteration (safe_eigh); "
              f"launches {launches}")
        if not bits or res.num_iter != plain.num_iter or \
                res.nev_conv != plain.nev_conv:
            raise AssertionError(f"{tag}: not the undistributed row's bits, "
                                 f"iterations and count")
        eigh_solve_gates(tag, fused.a_csr, fused.nx, nev, res.eval, res.evec,
                         res.nev_conv, fused.ev_auto)
        path_launched(tag, launches, ("jacobi", "dia_f64", "dia_f32", "gram",
                                      "expand"))
        walls = walls_in_turns(torch, {
            "none": lambda: gcg_solve(fused.op, None, fused.params),
            "mesh": lambda: gcg_solve(sharded, None, fused.params,
                                      mesh=row)},
            turns=("none", "mesh", "mesh", "none"))
        print(f"{tag}: walls in turns ({card}): without a mesh "
              f"{walls['none']} s, on the one-rank row mesh {walls['mesh']} s")
        phase_sync_check(torch, f"nev={nev}, rr_backend='newton', one-rank "
                         f"row mesh", lambda steps: gcg_solve(
                             sharded, None, dataclasses.replace(
                                 fused.params, fuse=steps, max_iter=steps),
                             mesh=row))
    finally:
        dist.destroy_process_group()
    print(f"partitioned Newton phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_newton_mesh_alone(torch, card):
    """``--newton-mesh``: phase 23's nev=200 'newton' row (the structural
    warm start, the sweep's fused loop) without a mesh and on a one-rank
    NCCL row mesh, so that two trees are compared in one call (``--root
    DIR``, a parent: there the mesh's eigh runs whole and broadcasts its
    result).  The third projected matrix of order 480 of the first solve
    (also the warm-up) is captured; ``eigh_newton`` on it without a mesh and
    on the row mesh: the same bits, two calls of each under torch.profiler
    (device time by kernel, the host's operations by their own time), and
    the walls in turns (none, mesh, mesh, none; five calls a turn); then
    the solve, in turns (none, mesh, mesh, none; three a turn): walls,
    iterations, count, the same bits, and a digest of the eigenvalues' and
    eigenvectors' bytes for the trees to compare."""
    import hashlib

    import torch.distributed as dist

    from gcge_tpu_torch import gcg_solve, make_operator
    from gcge_tpu_torch.ops import eighs
    from gcge_tpu_torch.parallel import bootstrap, row_mesh, shard_operator
    from gcge_tpu_torch.utils import sweep

    nev, m = EIGH_NEV, wide_classes(EIGH_NEV)[0]
    nx = C_REFERENCE[nev][0]
    (rows, cols, vals, n), _ = stencil(nx)
    op = make_operator(rows, cols, vals, (n, n), device=DEVICE)
    params = dataclasses.replace(sweep.production_params(nev, op),
                                 rr_backend="newton", rr_warm="struct")
    with projected_capture((m,)) as projected:
        gcg_solve(op, None, params)
    if set(projected) != {m}:
        raise AssertionError(f"no projected matrix of order {m} captured")
    h = projected[m]

    def in_turns(runs, each):
        walls = collections.defaultdict(list)
        for name in ("none", "mesh", "mesh", "none"):
            for _ in range(each):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs[name]()
                torch.cuda.synchronize()
                walls[name].append(round(time.perf_counter() - t0, 4))
        return dict(walls)

    bootstrap(f"tcp://127.0.0.1:{_free_port()}", 1, 0, DEVICE)
    try:
        row = row_mesh()
        row.warm()
        eig = {"none": lambda: eighs.eigh_newton(h),
               "mesh": lambda: eighs.eigh_newton(h, mesh=row)}
        (w0, u0), (w1, u1) = eig["none"](), eig["mesh"]()
        if not (torch.equal(w0, w1) and torch.equal(u0, u1)):
            raise AssertionError(f"eigh_newton m={m}: the one-rank row "
                                 f"mesh's bits differ from mesh=None's")
        for name, run in eig.items():
            profile_solve(torch, f"eigh_newton m={m}, {name}, 2 calls "
                          f"({card})", lambda run=run: (run(), run(), 2)[2],
                          host_top=12)
        walls = in_turns(eig, 5)
        print(f"eigh_newton m={m} walls in turns (none, mesh, mesh, none; "
              f"five calls a turn; {card}): " + "; ".join(
                  f"{k} {v} s" for k, v in walls.items()))
        sharded = shard_operator(op, row)
        got = {}
        walls = in_turns({
            "none": lambda: got.update(none=gcg_solve(op, None, params)),
            "mesh": lambda: got.update(mesh=gcg_solve(sharded, None, params,
                                                      mesh=row))}, 3)
        for name, res in got.items():
            digest = hashlib.sha256(res.eval.tobytes() + res.evec.cpu()
                                    .numpy().tobytes()).hexdigest()[:16]
            print(f"wide nev={nev} rr_backend='newton', {name}: "
                  f"{res.num_iter} iterations, {res.nev_conv} converged, "
                  f"digest {digest}")
        if not (np.array_equal(got["none"].eval, got["mesh"].eval)
                and torch.equal(got["none"].evec, got["mesh"].evec)):
            raise AssertionError(f"nev={nev} 'newton': the one-rank row "
                                 f"mesh's bits differ from mesh=None's")
        print(f"wide nev={nev} rr_backend='newton' walls in turns (none, "
              f"mesh, mesh, none; three solves a turn; {card}): " +
              "; ".join(f"{k} {v} s" for k, v in walls.items()))
    finally:
        dist.destroy_process_group()


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
    # jnp code, no Pallas kernel: the sweep loop of jacobi_polish
    ("jacobi", "gcge_tpu_torch/ops/csrc/jacobi.cu",
     "gcge_tpu/ops/eighs.py:175"),
)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # --eigh --root DIR runs this tree and the parent's turns in processes
    # of their own (phase_eigh_turns)
    root = argv[argv.index("--root") + 1] \
        if "--root" in argv and "--eigh" not in argv else HERE
    sys.path.insert(0, os.path.abspath(root))
    import gcge_tpu_torch  # noqa: F401  (fails here, before any output, without the package)

    card = phase_build()
    phase_fragment_check(torch)
    if "--dia" in argv:
        import inspect

        from gcge_tpu_torch.ops import spmm

        phase_dia(torch, "path" in inspect.signature(
            spmm.dia_spmm).parameters)
        print(f"chip_smoke --dia ({gcge_tpu_torch.__file__}): "
              f"{time.perf_counter() - T_START:.0f} s")
        print(card)
        return 0
    if "--csr" in argv:
        phase_csr(torch)
        print(f"chip_smoke --csr ({gcge_tpu_torch.__file__}): "
              f"{time.perf_counter() - T_START:.0f} s")
        print(card)
        return 0
    if "--pas" in argv:
        phase_pas_alone(torch)
        print(f"chip_smoke --pas ({gcge_tpu_torch.__file__}): "
              f"{time.perf_counter() - T_START:.0f} s")
        print(card)
        return 0
    if "--newton-mesh" in argv:
        phase_newton_mesh_alone(torch, card)
        print(f"chip_smoke --newton-mesh ({gcge_tpu_torch.__file__}): "
              f"{time.perf_counter() - T_START:.0f} s")
        print(card)
        return 0
    if "--eigh-turn" in argv:
        eigh_turn(torch)
        return 0
    if "--jacobi" in argv:
        phase_kernels_jacobi(torch, KernelLog(torch), sizes=True)
        print(f"chip_smoke --jacobi ({gcge_tpu_torch.__file__}): "
              f"{time.perf_counter() - T_START:.0f} s")
        print(card)
        return 0
    if "--eigh" in argv:
        phase_eigh_alone(torch)
        if "--root" in argv:
            phase_eigh_turns(card, argv[argv.index("--root") + 1])
        print(f"chip_smoke --eigh ({gcge_tpu_torch.__file__}): "
              f"{time.perf_counter() - T_START:.0f} s")
        print(card)
        return 0
    if "--tall" in argv:
        import inspect

        from gcge_tpu_torch.ops import osgemm

        phase_tall(torch, "path" in inspect.signature(
            osgemm.tall_gram).parameters)
        print(f"chip_smoke --tall ({gcge_tpu_torch.__file__}): "
              f"{time.perf_counter() - T_START:.0f} s")
        print(card)
        return 0
    log = KernelLog(torch)
    (rows, cols, vals, n), a_csr = stencil(NX)
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
    t0 = time.perf_counter()
    phase_kernels_jacobi(torch, log)
    paths.update(phase_jacobi_headline(torch, a_csr, ev_headline))
    print(f"jacobi phases: {time.perf_counter() - t0:.1f} s")
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
    paths.update(phase_driver(torch, a_csr, rows, cols, vals, n, ev_headline,
                              fem_a, fem_b, ev_gen))
    orders = tuple(wide_classes(nev)[0] for nev in WIDE_NEVS)
    with projected_capture(orders) as projected:
        for nev in WIDE_NEVS:
            t0 = time.perf_counter()
            phase_kernels_wide(torch, log, nev)
            paths[f"wide_{nev}"], ev_wide = phase_wide(torch, log, nev)
            print(f"wide phase nev={nev}: {time.perf_counter() - t0:.1f} s")
            if nev == EIGH_NEV:
                t0 = time.perf_counter()
                newton_paths, fused = phase_newton_wide(torch, log, nev,
                                                        ev_wide)
                paths.update(newton_paths)
                print(f"newton phase nev={nev}: "
                      f"{time.perf_counter() - t0:.1f} s")
    paths[f"newton_{EIGH_NEV}_mesh"] = phase_newton_mesh(
        torch, card, projected, orders, fused)
    t0 = time.perf_counter()
    paths["irregular_wide"], paths["irregular_wide_mesh"] = \
        phase_irregular_wide(torch, log, a, a_rcm, ev_irregular)
    print(f"irregular wide phase: {time.perf_counter() - t0:.1f} s")
    if "--profile" in argv:
        phase_profile(torch, op, a_csr)
        profile_wide(torch)
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
