"""The sliced Gram, piece by piece — the counterpart of
``benchmarks/pallas_isolate.py``.

    python3 -m gcge_tpu_torch.benchmarks.pallas_isolate [--device cuda|cpu]

Times the four modes of kernel 9 (loads only, peel only, dot only, full) at
the TPU script's shapes: A 128 rows, B 16 rows, n = 157,464 padded to a
multiple of the 1024-column chunk, hi planes standard normal from seed 0, lo
planes 1e-8 of them.  Min and median over ``--trials`` of the mean of
``--reps`` calls.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from gcge_tpu_torch.benchmarks import device_line, min_median_ms
from gcge_tpu_torch.ops.probes import MODES, slice_gram

LABELS = {"none": "loads_only", "peel": "peel_only", "dot": "dot_only",
          "full": "full"}


def make_planes(p: int, q: int, n: int, nr: int, device, seed: int = 0):
    """``(ahi, alo, bhi, blo)`` on ``device``: n padded up to a multiple of
    ``nr``, the padding filled like the rest."""
    n_pad = -(-n // nr) * nr
    rng = np.random.default_rng(seed)
    ahi = torch.as_tensor(rng.standard_normal((p, n_pad)).astype(np.float32),
                          device=device)
    bhi = torch.as_tensor(rng.standard_normal((q, n_pad)).astype(np.float32),
                          device=device)
    return ahi, ahi * 1e-8, bhi, bhi * 1e-8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--p", type=int, default=128)
    ap.add_argument("--q", type=int, default=16)
    ap.add_argument("--n", type=int, default=157464)
    ap.add_argument("--nr", type=int, default=1024)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    print(device_line(device))
    planes = make_planes(args.p, args.q, args.n, args.nr, device)
    print(f"P={args.p} Q={args.q} n_pad={planes[0].shape[1]} "
          f"chunk={args.nr} ({planes[0].shape[1] // args.nr} chunks)")
    for mode in MODES:
        lo, med = min_median_ms(
            lambda: slice_gram(*planes, mode=mode, nr=args.nr), device,
            args.trials, args.reps)
        print(f"{LABELS[mode]:12s} min {lo:9.4f} ms  median {med:9.4f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
