#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gcge_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. build — print the card's name and power limit, build the CUDA kernels from
   ``gcge_tpu_torch/ops/csrc`` and print the build time;
2. kernels — run each kernel's wrapper on the card at the shapes of the
   headline solve, hold it against its plain PyTorch version on the same
   inputs (stated tolerance), and time both (CUDA events, median of 20);
3. slice — the headline solve through ``gcge_tpu_torch.solve``: the 3-D
   27-point Laplacian at nx=54 (n=157,464), nev=50 at tol_rel 1e-8, block 10,
   inner CG budget 30; checks the converged count, the eigenvalues against
   the closed-form spectrum, the residuals with scipy on the host, and that
   every kernel was launched during the solve.

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
REPS = 20
DEVICE = "cuda"


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


def median_ms(torch, fn, reps: int = REPS) -> float:
    """Median time of fn() on the card over reps runs, by CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_build():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(out.splitlines()[0])
    from gcge_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(path, HERE)}")


def phase_kernels(torch, rows, cols, vals, n):
    """Each kernel against its plain version at the headline shapes."""
    from gcge_tpu_torch import make_operator
    from gcge_tpu_torch.ops import osgemm, spmm

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float64):
        return torch.randn(shape, generator=gen, dtype=dtype, device=dev)

    op = make_operator(rows, cols, vals, (n, n), device=dev)
    v64, offs = op.values, op.offsets_t
    v32 = v64.float()
    results = {}

    def run(key, label, kernel, plain, scale, tol):
        """scale: the error's reference size, a scalar or per entry."""
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        diff = (got - ref).abs()
        abs_err = float(diff.max())
        rel = float((diff / scale).max())
        ms, plain_ms = median_ms(torch, kernel), median_ms(torch, plain)
        print(f"kernel {label}: max rel err {rel:.3e} (tol {tol:.0e}), "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms")
        if not rel <= tol:
            raise AssertionError(f"{label}: relative error {rel:.3e} > {tol}")
        entry = results.setdefault(key, {"max_abs_err": 0.0, "ms": ms,
                                         "plain_ms": plain_ms})
        entry["max_abs_err"] = max(entry["max_abs_err"], abs_err)

    # kernel 1: f64 DIA, both layouts; error relative to max (|A| |x|)
    for m in (10, 100):
        for transposed in (False, True):
            x = randn(m, n) if transposed else randn(n, m)
            scale = spmm.dia_spmm_reference(v64.abs(), offs, x.abs(),
                                            transposed).max()
            run("dia_f64", f"dia_f64 m={m} transposed={transposed}",
                lambda: spmm.dia_spmm(v64, offs, x, transposed),
                lambda: spmm.dia_spmm_reference(v64, offs, x, transposed),
                scale, 1e-14)
    # kernel 2: f32 DIA, transposed (the mixed inner CG)
    xt = randn(BS, n, dtype=torch.float32)
    scale = spmm.dia_spmm_reference(v32.abs(), offs, xt.abs(), True).max()
    run("dia_f32", f"dia_f32 m={BS} transposed=True",
        lambda: spmm.dia_spmm(v32, offs, xt, True),
        lambda: spmm.dia_spmm_reference(v32, offs, xt, True), scale, 1e-5)
    # kernel 3: tall Gram; error relative to ||a_i|| ||b_j|| per entry
    basis = randn(n, 120)
    for p, q in ((120, 10), (100, 100)):
        a, b = basis[:, :p], randn(n, q)
        norms = a.norm(dim=0)[:, None] * b.norm(dim=0)[None, :]
        run("gram", f"tall_gram ({p}x{q})",
            lambda a=a, b=b: osgemm.tall_gram(a, b),
            lambda a=a, b=b: osgemm.tall_gram_reference(a, b), norms, 1e-13)
    # kernel 4: tall expand; error relative to max (|a| |c|)
    a, c = basis, randn(120, 100)
    scale = (a.abs() @ c.abs()).max()
    run("expand", "tall_expand (n x 120)(120 x 100)",
        lambda: osgemm.tall_expand(a, c),
        lambda: osgemm.tall_expand_reference(a, c), scale, 1e-13)
    return results


def phase_slice(torch, rows, cols, vals, n):
    """The headline solve through the public entry point."""
    import scipy.sparse as sps

    import gcge_tpu_torch
    from gcge_tpu_torch.ops import osgemm, spmm

    a_csr = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    kwargs = dict(nev=NEV, device=DEVICE, block_size=BS, max_iter=120,
                  cg_max_iter=30)
    # the first solve in the process also pays the one-time set-up of the
    # CUDA libraries (cuBLAS, cuSOLVER handles); the second is the one
    # checked and counted
    t0 = time.perf_counter()
    gcge_tpu_torch.solve(a_csr, None, verbose=0, **kwargs)
    torch.cuda.synchronize()
    print(f"slice: first solve in the process {time.perf_counter() - t0:.3f} s")
    for counters in (spmm.LAUNCHES, osgemm.LAUNCHES):
        for key in counters:
            counters[key] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ev, evec, nev_conv = gcge_tpu_torch.solve(a_csr, None, verbose=1,
                                              **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**spmm.LAUNCHES, **osgemm.LAUNCHES}
    print(f"slice: wall {wall:.3f} s, nev_conv {nev_conv}, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {launches}")
    if nev_conv < NEV:
        raise AssertionError(f"nev_conv {nev_conv} < {NEV}")
    exact = smallest_eigs(NX, NEV)
    ev_err = float(np.max(np.abs(ev[:NEV] - exact) / np.abs(exact)))
    x = evec[:, :NEV].cpu().numpy()
    r = a_csr @ x - x * ev[None, :NEV]
    res = np.linalg.norm(r, axis=0) / (np.abs(ev[:NEV])
                                       * np.linalg.norm(x, axis=0))
    print(f"slice: eigenvalues vs closed form max rel err {ev_err:.3e} "
          f"(tol 1e-9); host residuals max {res.max():.3e} (tol 2e-8)")
    if not ev_err <= 1e-9:
        raise AssertionError(f"eigenvalue error {ev_err:.3e} > 1e-9")
    if not res.max() <= 2e-8:
        raise AssertionError(f"residual {res.max():.3e} > 2e-8")
    idle = [k for k, c in launches.items() if c <= 0]
    if idle:
        raise AssertionError(f"kernels not launched by the solve: {idle}")
    return launches


KERNELS = (  # key, source, the TPU kernel it replaces
    ("dia_f64", "gcge_tpu_torch/ops/csrc/dia_spmm.cu",
     "gcge_tpu/ops/spmm_pallas.py:207"),
    ("dia_f32", "gcge_tpu_torch/ops/csrc/dia_spmm.cu",
     "gcge_tpu/ops/spmm_pallas.py:68"),
    ("gram", "gcge_tpu_torch/ops/csrc/tall_gemm.cu",
     "gcge_tpu/ops/osgemm_pallas.py:137"),
    ("expand", "gcge_tpu_torch/ops/csrc/tall_gemm.cu",
     "gcge_tpu/ops/osgemm_pallas.py:290"),
)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    phase_build()
    rows, cols, vals, n = build_3d27(NX)
    timing = phase_kernels(torch, rows, cols, vals, n)
    launches = phase_slice(torch, rows, cols, vals, n)
    print(json.dumps({"kernels": [
        {"name": key, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[key], **timing[key]}
        for key, src, rep in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
