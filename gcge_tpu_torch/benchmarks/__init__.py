"""Kernel measurement scripts of the port, named after their counterparts in
the repository's ``benchmarks/``: each has a ``main(argv)`` and runs as
``python3 -m gcge_tpu_torch.benchmarks.<name> [--device cuda|cpu]``.

* :mod:`.df64_push` — the FMA probe (kernel 8), then the f64 DIA SpMM
  (kernel 1) at several block sizes;
* :mod:`.pallas_isolate` — the four modes of the sliced-Gram isolation
  kernel (kernel 9);
* :mod:`.csr_levels`, which has no counterpart there — kernel 6 at the CSR
  operators of the cube FEM pair's AMG hierarchy, and the PAS walls;
* :mod:`.csr_irregular`, which has none either — kernels 5 and 6 at the
  irregular solves' operands on each tile path.

They print times; they are not a benchmark harness and define no workload.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def trial_ms(fn, device: torch.device, reps: int) -> float:
    """Mean time in ms of ``reps`` back-to-back calls of ``fn``: CUDA events
    on a card, the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def min_median_ms(fn, device: torch.device, trials: int, reps: int):
    """``(min, median)`` over ``trials`` of :func:`trial_ms`, after one
    warm-up call."""
    fn()
    times = [trial_ms(fn, device, reps) for _ in range(trials)]
    return float(np.min(times)), float(np.median(times))


def device_line(device: torch.device) -> str:
    """What the times were taken on."""
    if device.type == "cuda":
        return f"device: {torch.cuda.get_device_name(device)}"
    return "device: cpu (plain PyTorch versions of the kernels; no time " \
           "here is a time of the card)"
