"""Projected-problem eigensolver — the counterpart of ``gcge_tpu/ops/eighs.py``.

``gcge_tpu`` adds Jacobi and Newton refinement because the TPU's emulated-f64
``eigh`` back-transforms at f32 accuracy; they exist only for the TPU.  The
port solves the small symmetric problems with ``torch.linalg.eigh`` in the
operand's precision and keeps the NaN guard of :func:`safe_eigh`.
"""

from __future__ import annotations

import torch


def safe_eigh(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh`` with a shift and a NaN retry.

    The base call is always shifted by ``1e-10 * max|diag|`` (eigenvectors
    unchanged, the shift subtracted from the eigenvalues), with a single
    escalation to ``1e-7`` when the result holds NaNs — the rule of
    ``gcge_tpu.ops.eighs.safe_eigh``, kept so both packages see the same
    spectra.  The NaN test reads one flag back to the host."""
    m = h.shape[0]
    scale = h.diagonal().abs().max() + 1e-300
    eye = torch.eye(m, dtype=h.dtype, device=h.device)

    def attempt(rel_reg: float):
        reg = rel_reg * scale
        w, u = torch.linalg.eigh(h + reg * eye)
        return w - reg, u

    w, u = attempt(1e-10)
    if bool(torch.isnan(w).any() | torch.isnan(u).any()):
        w, u = attempt(1e-7)
    return w, u


def eigh(h: torch.Tensor, backend: str = "auto"
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition, ascending.

    ``'auto'`` and ``'device'`` run :func:`safe_eigh`.  ``gcge_tpu``'s
    ``'jacobi'``, ``'newton'`` and ``'host'`` backends serve the TPU only and
    are not ported."""
    if backend in ("auto", "device"):
        return safe_eigh(h)
    if backend in ("jacobi", "newton", "host"):
        raise NotImplementedError(
            f"eigh backend {backend!r} exists for the TPU's emulated f64 "
            f"only; use 'auto' or 'device'")
    raise ValueError(f"unknown eigh backend {backend!r}")
