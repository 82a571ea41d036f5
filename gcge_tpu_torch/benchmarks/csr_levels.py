"""Kernel 6 at the CSR operators of the cube FEM pair's AMG hierarchy, and
the PAS solves that run on them.

    python3 -m gcge_tpu_torch.benchmarks.csr_levels [--device cuda|cpu]
        [--nx 54] [--widths 10,75] [--solves]

Builds the P1 FEM pair of the unit cube at ``--nx`` (n = (nx - 1)^3) and the
smoothed-aggregation hierarchy that ``solve(A, B, method="pas")`` builds,
then times ``matvec`` of each CSR operator in it (the levels' A, P and R) on
an ``(n, m)`` block of each width, standard normal from seed 0 (10: the
V-cycle of the AMG-preconditioned GCG; 75: PAS's working block at nev=50),
min and median over ``--trials`` of the mean of ``--reps`` calls, beside
``torch.sparse.mm`` on the same CSR matrix; then on each path of
``onehot.PATHS`` it takes (the split path, the wide path's tiles where the
tree has them, the panel path where the plan holds panels;
``csr_spmm(..., path=)``).
Run from the root of an older tree unpacked with ``git archive`` (the
script copied into its ``gcge_tpu_torch/benchmarks/``), it times that
tree's kernels.  ``--solves`` then runs
``pas_solve`` at nev=50 on that hierarchy with ``solve``'s PAS knobs (2
sweeps a level, 16 on the finest, 8 V-cycles a correction), and on a card
again on the hierarchy sharded over a one-rank NCCL row mesh, and prints
their walls (set-up excluded), sweeps and kernel-6 launches.
"""

from __future__ import annotations

import argparse
import socket
import time

import numpy as np
import scipy.sparse as sps
import torch

from gcge_tpu_torch.benchmarks import device_line, min_median_ms

NEV = 50
PAS_KWARGS = dict(sweeps_per_level=2, final_sweeps=16, bamg_cycles=8)


def fem_hierarchy(nx: int, device: torch.device):
    """``(a, hier, seconds)``: the FEM pair's A (scipy CSR) and the PAS
    hierarchy of the pair on ``device``, with the host's set-up time."""
    from gcge_tpu_torch.api import _hierarchy
    from gcge_tpu_torch.io.fem import cube_fem_laplacian

    rows, cols, av, bv, n = cube_fem_laplacian(nx)
    a = sps.coo_matrix((av, (rows, cols)), shape=(n, n)).tocsr()
    b = sps.coo_matrix((bv, (rows, cols)), shape=(n, n)).tocsr()
    t0 = time.perf_counter()
    hier = _hierarchy(a, b, None, 4, "pas", torch.float64, device)
    return a, hier, time.perf_counter() - t0


def time_levels(hier, widths, device, trials: int, reps: int) -> None:
    from gcge_tpu_torch.ops import onehot

    gen = torch.Generator(device=device).manual_seed(0)
    for i, lv in enumerate(hier.levels):
        for what in ("A", "P", "R"):
            op = getattr(lv, f"{what.lower()}_op", None)
            if not isinstance(op, onehot.CsrOperator):
                continue
            lengths = np.diff(op.rowptr.cpu().numpy())
            lib = torch.sparse_csr_tensor(op.rowptr.long(), op.colidx.long(),
                                          op.values, op.shape)
            for m in widths:
                x = torch.randn((op.shape[1], m), generator=gen,
                                dtype=torch.float64, device=device)
                y = op.matvec(x)
                twice = torch.equal(y, op.matvec(x))
                ref = torch.sparse.mm(lib, x)
                err = float((y - ref).abs().max() /
                            ref.abs().max().clamp_min(1e-300))
                lo, med = min_median_ms(lambda: op.matvec(x), device,
                                        trials, reps)
                _, lib_med = min_median_ms(lambda: torch.sparse.mm(lib, x),
                                           device, trials, reps)
                print(f"level {i} {what} {tuple(op.shape)} ({len(op.values)}"
                      f" entries, rows up to {lengths.max()}) m={m}: median "
                      f"{med:.4f} ms (min {lo:.4f}), library {lib_med:.4f} "
                      f"ms, rel err {err:.2e}, equal bits twice {twice}",
                      flush=True)
                paths = [p for p in onehot.PATHS if p != "panel"
                         or getattr(op.plan, "panels", None) is not None]
                if len(paths) < 2:
                    continue
                for path in paths:
                    lo, med = min_median_ms(
                        lambda: onehot.csr_spmm(op.rowptr, op.colidx,
                                                op.values, x, False,
                                                op.plan, path),
                        device, trials, reps)
                    print(f"  {path} path, level {i} {what} m={m}: median "
                          f"{med:.4f} ms (min {lo:.4f})", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def time_solves(hier, device) -> None:
    from gcge_tpu_torch.ops import onehot
    from gcge_tpu_torch.solvers.pas import pas_solve

    def run(tag, h):
        onehot.LAUNCHES["csr_f64"] = 0
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pas_solve(h, NEV, tol_rel=1e-8, verbose=0, **PAS_KWARGS)
        if device.type == "cuda":
            torch.cuda.synchronize()
        print(f"{tag}: wall {time.perf_counter() - t0:.3f} s, sweeps "
              f"{res.sweeps}, nev_conv {res.nev_conv}, kernel-6 launches "
              f"{onehot.LAUNCHES['csr_f64']}", flush=True)
        return res

    res = run("PAS", hier)
    if device.type != "cuda":
        return
    import torch.distributed as dist

    from gcge_tpu_torch.parallel import bootstrap, row_mesh, shard_hierarchy

    bootstrap(f"tcp://127.0.0.1:{_free_port()}", 1, 0, "cuda")
    try:
        mesh = row_mesh()
        dres = run("distributed PAS (one NCCL rank)",
                   shard_hierarchy(hier, mesh))
    finally:
        dist.destroy_process_group()
    print("distributed PAS: equal bits to PAS "
          f"{np.array_equal(dres.eval, res.eval) and torch.equal(dres.evec, res.evec)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nx", type=int, default=54)
    ap.add_argument("--widths", default="10,75")
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--solves", action="store_true")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    print(device_line(device))
    a, hier, setup = fem_hierarchy(args.nx, device)
    print(f"FEM pair nx={args.nx}: n={a.shape[0]}, nnz={a.nnz}; hierarchy "
          f"of {len(hier.levels)} levels, host set-up {setup:.2f} s",
          flush=True)
    time_levels(hier, [int(w) for w in args.widths.split(",")], device,
                args.trials, args.reps)
    if args.solves:
        time_solves(hier, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
