"""The nev sweep with the reference's production settings — the counterpart
of ``examples/nev_sweep.py``.

The reference's cluster rig (``test/submit.sh:34-44``) sweeps the wanted
eigenpair count with ``blockSize = nev/5``, ``nevMax = 2*nev`` and the
tolerances ``-gcge_abs_tol 1 -gcge_rel_tol 1e-8`` on the 3-D 27-point
Laplacian; :func:`main` does the same and prints one timing row a
configuration, each the second of two solves (the first builds the kernels
and sets up the CUDA libraries)::

    python -m gcge_tpu_torch.utils.sweep [-nx 54] [-nevs 50,100,200]
        [-device cuda]
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

from gcge_tpu_torch.solvers.gcg import GCGParams, GCGResult
from gcge_tpu_torch.utils.cli import driver_params, get_flag


def production_params(nev: int, op) -> GCGParams:
    """``submit.sh``'s settings for ``nev`` (block ``nev // 5``, nevMax
    ``2 nev``, tolerances 1 and 1e-8, an inner budget of 30 with the auto
    shift) on ``op`` (B = I), with the command-line driver's defaults for
    the rest (``cli.driver_params``: the fused loop in chunks of 5, and on a
    card the mixed inner CG)."""
    return driver_params(
        GCGParams(nev=nev, block_size=max(nev // 5, 1), verbose=0,
                  tol_abs=1.0, tol_rel=1e-8, cg_max_iter=30,
                  cg_auto_shift=True), op.device, op)


@dataclass
class Row:
    """One configuration of the sweep: the timed solve's result, its wall
    and the untimed warm-up's."""
    nev: int
    block_size: int
    result: GCGResult
    wall_s: float
    warmup_s: float


def run_row(op, params: GCGParams, x0=None) -> Row:
    """The warm-up solve, then the timed one, of ``op`` (B = I), each ended
    by a wait for the device."""
    import torch

    from gcge_tpu_torch.solvers.gcg import gcg_solve

    def timed():
        t0 = time.perf_counter()
        res = gcg_solve(op, None, params, x0=x0)
        if op.device.type == "cuda":
            torch.cuda.synchronize(op.device)
        return res, time.perf_counter() - t0

    _, warmup = timed()
    res, wall = timed()
    return Row(params.nev, params.resolved(op.shape[0]).block_size, res,
               wall, warmup)


def main(argv=None) -> int:
    """The sweep: ``-nx`` (default 54), ``-nevs`` (default ``50,100,200``),
    ``-device`` (default ``cuda``; no card raises)."""
    import torch

    from gcge_tpu_torch.io.stencil import build_3d27
    from gcge_tpu_torch.ops.operators import make_operator

    argv = list(sys.argv[1:] if argv is None else argv)
    device = torch.device(get_flag(argv, "-device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("-device cuda: no CUDA device here (pass "
                           "-device cpu to run the sweep on the CPU)")
    nx = get_flag(argv, "-nx", 54, int)
    nevs = [int(v) for v in get_flag(argv, "-nevs", "50,100,200").split(",")]
    rows, cols, vals, n = build_3d27(nx)
    op = make_operator(rows, cols, vals, (n, n), device=device)
    print(f"n={n} nnz={len(vals)}  (production params: bs=nev/5, "
          f"nevMax=2*nev, tol={{1,1e-8}}; submit.sh:34-44)")
    print(f"{'nev':>6} {'bs':>5} {'wall_s':>9} {'iters':>6} {'conv':>6}")
    for nev in nevs:
        row = run_row(op, production_params(nev, op))
        print(f"{nev:>6} {row.block_size:>5} {row.wall_s:>9.1f} "
              f"{row.result.num_iter:>6} {row.result.nev_conv:>6}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
