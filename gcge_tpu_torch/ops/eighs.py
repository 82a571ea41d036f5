"""Projected-problem eigensolver — the counterpart of ``gcge_tpu/ops/eighs.py``.

``gcge_tpu`` adds Jacobi and Newton refinement because the TPU's emulated-f64
``eigh`` back-transforms at f32 accuracy; they exist only for the TPU.  The
port solves the small symmetric problems with ``torch.linalg.eigh`` in the
operand's precision and keeps the NaN guard of :func:`safe_eigh`.
"""

from __future__ import annotations

import contextlib

import torch

# calls of safe_eigh since the last reset: each is one wait of the host for
# the device on a card (see host_read_allowed)
CALLS = {"safe_eigh": 0}


@contextlib.contextmanager
def host_read_allowed(device: torch.device):
    """The one region of the fused iteration in which the host waits for
    the device: ``torch.linalg.eigh`` reads cuSOLVER's ``info`` back, and the
    NaN guard reads one flag.  A caller that runs under
    ``torch.cuda.set_sync_debug_mode`` to prove that nothing else waits
    finds the mode lifted here, and restored after."""
    mode = torch.cuda.get_sync_debug_mode() if device.type == "cuda" else 0
    if mode == 0:
        yield
        return
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


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

    CALLS["safe_eigh"] += 1
    with host_read_allowed(h.device):
        w, u = attempt(1e-10)
        if bool(torch.isnan(w).any() | torch.isnan(u).any()):
            w, u = attempt(1e-7)
    return w, u


def check_backend(backend: str) -> None:
    """Raise unless ``backend`` is one :func:`eigh` runs: ``'auto'`` or
    ``'device'``.  ``gcge_tpu``'s ``'jacobi'``, ``'newton'`` and ``'host'``
    backends serve the TPU only and are not ported."""
    if backend in ("auto", "device"):
        return
    if backend in ("jacobi", "newton", "host"):
        raise NotImplementedError(
            f"eigh backend {backend!r} exists for the TPU's emulated f64 "
            f"only; use 'auto' or 'device'")
    raise ValueError(f"unknown eigh backend {backend!r}")


def eigh(h: torch.Tensor, backend: str = "auto", mesh=None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition, ascending: :func:`safe_eigh` for the
    backends :func:`check_backend` accepts.  Under a row mesh every rank
    solves its (identical) ``h`` and then takes rank 0's ``(w, u)``, one
    ``m x m`` broadcast, so that the ranks can never take different
    branches on eigenvalues that differ in the last bit."""
    check_backend(backend)
    w, u = safe_eigh(h)
    if mesh is None:
        return w, u
    wu = mesh.broadcast(torch.cat([w[None, :], u]))
    return wu[0], wu[1:]
