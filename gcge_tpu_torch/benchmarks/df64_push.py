"""f64 DIA SpMM measurements — the counterpart of ``benchmarks/df64_push.py``.

    python3 -m gcge_tpu_torch.benchmarks.df64_push [--device cuda|cpu]

1. The FMA probe (kernel 8): is ``a * b - p`` compiled to one fused
   multiply-add, so that it equals the Dekker two-product error bit for bit?
2. The f64 DIA SpMM (kernel 1) on the 27-point stencil at ``--nx`` (54) in
   the transposed ``(bs, n)`` layout at ``--bs`` (10, 24, 40): min and median
   over ``--trials`` of the mean of ``--reps`` calls.

The TPU script also sweeps a budget for the kernel's result planes in fast
memory; the port's kernel has no such guard, so there is nothing to sweep.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from gcge_tpu_torch.benchmarks import device_line, min_median_ms
from gcge_tpu_torch.io.stencil import build_3d27
from gcge_tpu_torch.ops.operators import DiaOperator
from gcge_tpu_torch.ops.probes import PROBE_SHAPE, fma_probe


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nx", type=int, default=54)
    ap.add_argument("--bs", type=int, nargs="+", default=[10, 24, 40])
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    rng = np.random.default_rng(0)
    print(device_line(device))

    a32 = torch.as_tensor(
        (rng.standard_normal(PROBE_SHAPE) * 1.7).astype(np.float32),
        device=device)
    b32 = torch.as_tensor(
        (rng.standard_normal(PROBE_SHAPE) * 0.3).astype(np.float32),
        device=device)
    probe = fma_probe(a32, b32)
    total = PROBE_SHAPE[0] * PROBE_SHAPE[1]
    print(f"FMA probe: (a*b - p) == dekker_err exactly: {probe.fused} "
          f"(dekker err nonzeros: {probe.nonzeros}/{total})", flush=True)

    rows, cols, vals, n = build_3d27(args.nx)
    dia = DiaOperator.from_coo(rows, cols, vals, (n, n), device=device)
    nnz = len(vals)
    for bs in args.bs:
        xt = torch.as_tensor(rng.standard_normal((bs, n)), device=device)
        lo, med = min_median_ms(lambda: dia.matvec_t(xt), device,
                                args.trials, args.reps)
        print(f"f64 dia nx={args.nx} bs={bs:<3d} min {lo:8.4f} ms  median "
              f"{med:8.4f} ms  {nnz / med / 1e6:7.2f} Gnnz/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
