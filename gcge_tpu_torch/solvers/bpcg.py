"""Block preconditioned CG with per-column freeze masks — the counterpart of
``gcge_tpu/solvers/bpcg.py``.

Every column runs in every matvec; a converged column is frozen (its
``alpha``/``beta`` become zero) instead of being compacted out.  The loop is a
Python loop in two forms.  The early-exit form stops when the iteration
budget is spent or no column is active, which reads one flag back to the host
per step.  The fixed-count form (``fixed=True``) runs every budgeted step
and reads nothing back: a step on which no column is active changes none of
``x, r, z, p`` (its ``alpha`` and ``beta`` are zero), so ``x`` and the
residuals equal the early-exit form's, and ``niters`` is a 0-d tensor that
counts the steps on which a column was active.  The fused GCG iteration and
a CUDA graph over a CG stage need this form.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class BlockPCGParams:
    """The reference's BlockPCG knobs."""

    max_iter: int = 50
    rate: float = 1e-2          # stop when res <= rate * initial res (per col)
    tol: float = 1e-12          # absolute/relative floor per column
    tol_type: str = "abs"       # 'abs' | 'rel' | 'user'


@dataclass
class BlockPCGInfo:
    niters: int | torch.Tensor  # iterations executed (0-d tensor: fixed form)
    final_res: torch.Tensor     # (m,) final residual 2-norms
    init_res: torch.Tensor      # (m,) initial residual 2-norms


def _pcg(matvec, b, x0, params, active0, norm_b, precond, axis: int,
         fixed: bool = False):
    """Block PCG over columns (``axis=0`` sums: (n, m) layout) or rows
    (``axis=1`` sums: (m, n) layout)."""
    m = b.shape[1 - axis]
    dtype, device = b.dtype, b.device

    def dots(x, y):
        return (x * y).sum(dim=axis)

    def bc(v):                  # broadcast a per-vector (m,) quantity
        return v[None, :] if axis == 0 else v[:, None]

    if active0 is None:
        active0 = torch.ones(m, dtype=torch.bool, device=device)
    if params.tol_type == "rel":
        nb = torch.sqrt(dots(b, b))
    elif params.tol_type == "user":
        if norm_b is None:
            raise ValueError("tol_type='user' requires norm_b")
        nb = norm_b.abs().to(dtype)
    else:
        nb = torch.ones(m, dtype=dtype, device=device)

    def apply_m(r):
        return r if precond is None else precond(r)

    r = torch.where(bc(active0), b - matvec(x0), 0.0)
    z = apply_m(r)
    rho_cur = dots(r, z)
    res = torch.sqrt(rho_cur if precond is None else dots(r, r))
    init_res = res
    active = active0 & (init_res > params.tol * nb)
    rho_prev = rho_cur
    x, p = x0, torch.zeros_like(r)
    nsteps = torch.zeros((), dtype=torch.int64, device=device) if fixed \
        else 0
    for niter in range(params.max_iter):
        if fixed:
            nsteps = nsteps + active.any()
        elif bool(active.any()):
            nsteps += 1
        else:
            break
        beta = torch.where(
            (niter > 0) & active & (rho_prev > 0),
            rho_cur / torch.where(rho_prev > 0, rho_prev, 1.0), 0.0)
        p = torch.where(bc(active), z + bc(beta) * p, 0.0)
        w = matvec(p)
        ptw = dots(p, w)
        # no positivity guard: GCG's shifted operator is indefinite by
        # design; only division by exact zero is avoided
        alpha = torch.where(active & (ptw != 0),
                            rho_cur / torch.where(ptw != 0, ptw, 1.0), 0.0)
        x = x + bc(alpha) * p
        r = r - bc(alpha) * w
        z = apply_m(r)
        rho_prev, rho_cur = rho_cur, dots(r, z)
        res = torch.sqrt(rho_cur if precond is None else dots(r, r))
        active = active & (res > params.rate * init_res) & \
            (res > params.tol * nb)
    return x, BlockPCGInfo(niters=nsteps, final_res=res, init_res=init_res)


def block_pcg(matvec, b: torch.Tensor, x0: torch.Tensor,
              params: BlockPCGParams = BlockPCGParams(),
              active0: torch.Tensor | None = None,
              norm_b: torch.Tensor | None = None, precond=None,
              fixed: bool = False):
    """Solve ``op @ x = b`` column by column; ``b, x0`` are ``(n, m)``.

    ``active0``: ``(m,)`` bool mask, columns False are never touched.
    ``norm_b``: per-column norms for ``tol_type='user'``.  ``precond``:
    multivector preconditioner ``R -> M^{-1} R``.  ``fixed``: run all
    ``max_iter`` steps and read nothing back to the host.  Returns
    ``(x, BlockPCGInfo)``."""
    return _pcg(matvec, b, x0, params, active0, norm_b, precond, axis=0,
                fixed=fixed)


def block_pcg_t(matvec_t, bt: torch.Tensor, x0t: torch.Tensor,
                params: BlockPCGParams = BlockPCGParams(),
                active0: torch.Tensor | None = None,
                norm_b: torch.Tensor | None = None, precond=None,
                fixed: bool = False):
    """:func:`block_pcg` in the transposed ``(m, n)`` layout — the layout of
    :meth:`DiaOperator.matvec_t` and of the mixed-precision inner CG."""
    return _pcg(matvec_t, bt, x0t, params, active0, norm_b, precond, axis=1,
                fixed=fixed)


def pcg(matvec, b: torch.Tensor, x0: torch.Tensor, max_iter: int = 50,
        rate: float = 1e-2, tol: float = 1e-12):
    """Single-vector CG (the reference's ``PCG``): :func:`block_pcg` on a
    one-column block, stopping on the relative decrease ``rate`` or the
    absolute floor ``tol``.  ``b, x0`` are ``(n,)``; returns
    ``(x, BlockPCGInfo)``."""
    x, info = block_pcg(matvec, b[:, None], x0[:, None],
                        BlockPCGParams(max_iter=max_iter, rate=rate, tol=tol,
                                       tol_type="abs"))
    return x[:, 0], info
