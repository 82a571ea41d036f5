"""Kernels 5 and 6 at the irregular solves' operands, on each tile path.

    python3 -m gcge_tpu_torch.benchmarks.csr_irregular [--device cuda|cpu]
        [--mesh 64] [--reps 20]

Builds the irregular cell's matrix (P1 stiffness on a Delaunay mesh of
mesh^3 jittered points, seed 1, in RCM order, as ``chip_smoke.py`` builds
it) as a ``CsrOperator`` and times kernel 6 at the operands the irregular
nev=50 and nev=200 solves hand it (the W coupling ``V[:, m-bs:m]``, the
residual window ``ritz[:, 41:41+bs]``, the refresh ``(n, bs)``, the
gathered window ``(n, 2 bs)``, the initial Rayleigh-Ritz ``V[:, :2 nev]``)
and kernel 5 at their CG operand (``(bs, n)`` with strides ``(1, bs)``),
each on every path of ``onehot.PATHS`` that runs the short rows on tiles,
in turns (forward, then backward), each a median of ``--reps`` calls after
a read of 256 MB that leaves the L2 cold, beside ``torch.sparse.mm``;
prints the largest difference from the library call, relative to its
largest entry, and whether the paths give equal bits.  Run from the root
of another tree (a parent unpacked with ``git archive``, or a scratch copy
with a part of a kernel left out; the script copied into its
``gcge_tpu_torch/benchmarks/``), it times that tree's kernels.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import scipy.sparse as sps
import torch

from gcge_tpu_torch.benchmarks import device_line

# (nev, basis width m, block bs) of the irregular solves
SOLVES = ((50, 120, 10), (200, 480, 40))


def delaunay_rcm(mesh: int):
    """The irregular cell's matrix in RCM order, as scipy CSR."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from gcge_tpu_torch.io.fem import assemble_p1, random_delaunay_mesh

    rows, cols, av, _, n = assemble_p1(*random_delaunay_mesh(mesh ** 3,
                                                             seed=1))
    a = sps.coo_matrix((av, (rows, cols)), shape=(n, n)).tocsr()
    perm = reverse_cuthill_mckee(a, symmetric_mode=True)
    return a[perm][:, perm].tocsr()


def operands(n: int, device, gen):
    """``(label, dtype, x, transposed)`` of each operand of each solve."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           device=device)

    for nev, m, bs in SOLVES:
        tag = f"nev={nev}"
        yield f"{tag} V[:, {m - bs}:{m}]", randn(n, m)[:, m - bs:], False
        yield (f"{tag} ritz[:, 41:{41 + bs}]",
               randn(n, 2 * nev)[:, 41:41 + bs], False)
        yield f"{tag} (n, {bs})", randn(n, bs), False
        yield f"{tag} (n, {2 * bs})", randn(n, 2 * bs), False
        yield f"{tag} V[:, :{2 * nev}]", randn(n, m)[:, :2 * nev], False
        yield f"{tag} CG ({bs}, n)", randn(n, bs).T.float(), True


def cold_median_ms(fn, device, reps: int) -> float:
    """Median time in ms of ``fn()`` over ``reps`` calls, each after a read
    of a buffer five times the L2 cache (CUDA events on a card; the host
    clock on the CPU, where there is no L2 of the card to clear)."""
    fn()
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times))
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=device)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.sum()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main(argv=None) -> int:
    from gcge_tpu_torch.ops import onehot

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", type=int, default=64)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    print(device_line(device))
    t0 = time.perf_counter()
    a = delaunay_rcm(args.mesh)
    n = a.shape[0]
    coo = a.tocoo()
    op = onehot.CsrOperator.from_coo(coo.row, coo.col, coo.data, a.shape,
                                     device=device)
    if op.plan is None:                  # the CPU: the plan for its paths
        op.plan = onehot.csr_plan(op.rowptr, op.colidx, op.values, n)
    print(f"irregular matrix (mesh {args.mesh}^3, RCM): n={n}, nnz={a.nnz}, "
          f"set-up {time.perf_counter() - t0:.1f} s; paths {onehot.PATHS}",
          flush=True)
    paths = [p for p in onehot.PATHS if p != "panel"]
    gen = torch.Generator(device=device).manual_seed(0)
    values32 = op.values.float()
    for label, x, transposed in operands(n, device, gen):
        vals = values32 if x.dtype == torch.float32 else op.values
        m = x.shape[0] if transposed else x.shape[1]
        lib = torch.sparse_csr_tensor(op.rowptr.long(), op.colidx.long(),
                                      vals, op.shape)
        x_nm = (x.T if transposed else x).contiguous()
        ref = torch.sparse.mm(lib, x_nm)

        def run(path, x=x, transposed=transposed, vals=vals):
            return onehot.csr_spmm(op.rowptr, op.colidx, vals, x, transposed,
                                   op.plan, path)

        ys = {p: run(p) for p in paths}
        equal = all(torch.equal(ys[p], ys[paths[0]]) for p in paths)
        got = ys[paths[0]].T if transposed else ys[paths[0]]
        err = float((got - ref).abs().max() / ref.abs().max())
        times = {p: [] for p in paths}
        for p in paths + paths[::-1]:
            times[p].append(cold_median_ms(lambda: run(p), device,
                                           args.reps))
        lib_ms = cold_median_ms(lambda: torch.sparse.mm(lib, x_nm), device,
                                args.reps)
        print(f"{label} {str(x.dtype).split('.')[1]} m={m} strides "
              f"{tuple(x.stride())}: the plan takes "
              f"{onehot.csr_path(op.plan, vals, m)}; " + "; ".join(
                  f"{p} {t[0]:.4f} / {t[1]:.4f} ms" for p, t in
                  times.items())
              + f"; library {lib_ms:.4f} ms; rel err {err:.2e}; paths "
              f"equal bits {equal}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
