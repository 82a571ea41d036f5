"""PAS — the Parallel Augmented Subspace multilevel eigensolver, the
counterpart of ``gcge_tpu/solvers/pas.py``.

Solve the eigenproblem on the coarsest level with GCG, then walk down the
hierarchy: on each finer level prolong the eigenvectors and improve them by
sweeps of an inverse-power correction (``cycles`` AMG V-cycles on
``A_l N = B_l X diag(lambda)``) followed by a Rayleigh-Ritz step over the
span ``[X | N]``.  Convergence is checked on the finest level only.

``composite_rr=True`` runs the Rayleigh-Ritz through
:class:`AugmentedOperator`, the reference's composite ``PASMAT`` acting on
stacked ``[u; q]`` vectors: the same subspace, the reference's dataflow.

``gcge_tpu``'s fused sweeps exit inside one ``lax.while_loop`` on the
device.  Here one loop runs the sweeps: each finest-level sweep computes
its stopping test on the device and reads one flag back.  ``fuse`` is
accepted for parity and changes nothing.

On a hierarchy sharded over a row mesh (``parallel.dist_mg``) the mesh comes
from ``hier.mesh``.  The coarsest level's GCG runs replicated, without the
mesh, and every rank takes rank 0's pairs (one broadcast); the replicated
levels between run no collective; on level 0 every contraction over rows
(the orthonormalization's Grams, the Rayleigh-Ritz Gram, the residual
norms) is summed over the ranks and the projected eigenpairs are rank 0's,
so every rank takes the same stop.  In the composite Rayleigh-Ritz a stacked
vector ``[u; q]`` has a head ``u`` of ``k`` coefficients and the rank's rows
``q``: rank 0 carries the head, the other ranks a zero head, so that a sum
over the stacked rows counts it once.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from gcge_tpu_torch.ops.eighs import eigh
from gcge_tpu_torch.ops.multivec import col_dots, psum
from gcge_tpu_torch.ops.operators import IdentityOperator, LinearOperator
from gcge_tpu_torch.ops.osgemm import tall_expand, tall_gram
from gcge_tpu_torch.solvers.gcg import GCGParams, gcg_solve
from gcge_tpu_torch.solvers.multigrid import MGHierarchy, _vcycle
from gcge_tpu_torch.solvers.orth import orth_block


class AugmentedOperator(LinearOperator):
    """Galerkin operator on ``span(Xp) (+) V_fine`` over stacked vectors.

    For ``s = [u; q]`` (u the coefficients of the promoted basis ``Xp``, q a
    fine-grid vector) it represents ``t = Xp u + q`` and applies
    ``[Xp^T A t; A t]``: the action of the reference's ``PASMAT`` blocks
    ``[Xp^T A Xp, Xp^T A; A Xp, A]`` with one fine operator application.
    The tall products run through kernels 3 and 4 on the card.

    Under a row mesh ``xp``, ``q`` and ``A t`` are the rank's rows; the head
    ``u`` is rank 0's (the others hold zeros), broadcast where ``t`` needs
    it, and ``Xp^T A t`` is summed over the ranks and kept on rank 0."""

    def __init__(self, a_fine: LinearOperator, xp: torch.Tensor, mesh=None):
        self.a_fine = a_fine
        self.xp = xp                    # (n, k) promoted basis
        self.mesh = mesh

    @property
    def shape(self):
        n, k = self.xp.shape
        return (n + k, n + k)

    @property
    def dtype(self):
        return self.xp.dtype

    @property
    def device(self):
        return self.xp.device

    def matvec(self, s):
        at = self.a_fine.matvec(self.to_fine(s))
        head = psum(tall_gram(self.xp, at), self.mesh)
        if self.mesh is not None and self.mesh.rank != 0:
            head = torch.zeros_like(head)
        return torch.cat([head, at], dim=0)

    def to_fine(self, s):
        """Collapse a composite vector to the fine grid: ``Xp u + q``."""
        k = self.xp.shape[1]
        # broadcast writes in place: a copy keeps s's zero head on the
        # ranks other than 0
        u = s[:k] if self.mesh is None else \
            self.mesh.broadcast(s[:k].clone())
        return tall_expand(self.xp, u) + s[k:]


@dataclass
class PASResult:
    eval: np.ndarray
    evec: torch.Tensor
    nev_conv: int
    level_history: list                 # (level, lam) after each level
    sweeps: list = field(default_factory=list)  # sweeps each finer level took


def _rr_over_span(a_op, b_op, s, nev, zero_tol=1e-13, mesh=None):
    """B-orthonormalize the span ``s`` and Rayleigh-Ritz on it: returns
    ``(lam, x)`` of the ``nev`` smallest pairs.  Deflated columns get a
    large diagonal, so they sort last."""
    bmv = None if b_op is None else b_op.matvec
    q, rank = orth_block(s, bmv, zero_tol=zero_tol, precision="auto",
                         mesh=mesh)
    h = psum(tall_gram(q, a_op.matvec(q)), mesh)
    h = 0.5 * (h + h.T)
    mvalid = (torch.arange(s.shape[1], device=s.device) < rank).to(s.dtype)
    h = h * mvalid[None, :] * mvalid[:, None]
    big = h.abs().sum(dim=1).max() + 1.0
    h = h + torch.diag((1.0 - mvalid) * big)
    w, c = eigh(h, "auto", mesh)
    return w[:nev], tall_expand(q, c[:, :nev])


def _rel_res(a_op, b_op, x, lam, mesh=None):
    """Column-wise residuals ``||A x - lam B x|| / |lam|``."""
    bx = x if b_op is None else b_op.matvec(x)
    r = a_op.matvec(x) - bx * lam[None, :]
    return torch.sqrt(col_dots(r, r, mesh)) / torch.clamp(lam.abs(),
                                                          min=1e-300)


def _pas_sweep(hier_sub, a_op, b_op, x, lam, nev: int, cycles: int,
               smooth_iters=(4, 4, 4, 4), coarse_iters: int = 100,
               composite: bool = False):
    """One PAS sweep: the inverse-power correction by ``cycles`` V-cycles
    from ``x``, then Rayleigh-Ritz over ``[X | N]``; with ``composite`` the
    span is ``[I, 0; 0, N]`` in stacked coordinates, orthonormalized under
    the composite B-metric (semi-definite: the rank-revealing orth deflates
    its null directions) and projected through ``PASMAT``, and the Ritz
    vectors collapsed back with ``to_fine``.  The mesh is
    ``hier_sub.mesh``: ``x`` is the rank's rows where it is set."""
    mesh = hier_sub.mesh
    bx = x if b_op is None else b_op.matvec(x)
    rhs = bx * lam[None, :]
    e = x
    for _ in range(cycles):
        e = _vcycle(hier_sub, 0, rhs, e, smooth_iters, coarse_iters, 1e-16,
                    1e-13)
    if composite:
        n, k = x.shape
        aug_a = AugmentedOperator(a_op, x, mesh)
        aug_b = AugmentedOperator(
            b_op if b_op is not None
            else IdentityOperator(n, x.dtype, device=x.device), x, mesh)
        s = torch.zeros((k + n, 2 * k), dtype=x.dtype, device=x.device)
        if mesh is None or mesh.rank == 0:
            s[:k, :k] = torch.eye(k, dtype=x.dtype, device=x.device)
        s[k:, k:] = e
        lam2, xc = _rr_over_span(aug_a, aug_b, s, nev, mesh=mesh)
        return lam2, aug_a.to_fine(xc)
    return _rr_over_span(a_op, b_op, torch.cat([x, e], dim=1), nev,
                         mesh=mesh)


def pas_solve(hier: MGHierarchy, nev: int,
              coarse_params: GCGParams | None = None,
              sweeps_per_level: int = 2, final_sweeps: int = 8,
              bamg_cycles: int = 6, tol_rel: float = 1e-8, verbose: int = 1,
              fuse: bool = True, composite_rr: bool = False) -> PASResult:
    """The multilevel PAS solver (the reference's ``PAS``).

    ``hier`` carries mass matrices (``build_hierarchy(..., b_vals=...)``),
    or the problem is standard.  The working block is ``nev`` plus a guard
    buffer of ``max(2, nev // 2)`` vectors, so that the ``nev``-th pair is
    not polluted by the unresolved spectrum above it; ``coarse_params.nev``
    can widen it, never narrow it.  ``composite_rr`` routes every
    Rayleigh-Ritz through :class:`AugmentedOperator`.  ``fuse`` is accepted
    and ignored: every finest-level sweep reads one stopping flag back.
    On a sharded hierarchy (``hier.mesh``) every rank calls it, rank 0
    prints, and ``evec`` is the rank's rows."""
    lvls = hier.levels
    top = hier.num_levels - 1
    mesh = hier.mesh
    if mesh is not None and mesh.rank != 0:
        verbose = 0
    nev_work = min(nev + max(2, nev // 2), lvls[top].a_op.shape[0] - 1)
    cp = coarse_params or GCGParams(nev=nev_work, verbose=0, max_iter=300)
    if coarse_params is not None and coarse_params.nev:
        nev_work = min(max(nev_work, coarse_params.nev),
                       lvls[top].a_op.shape[0] - 1)
    if cp.nev != nev_work:
        if verbose and coarse_params is not None:
            print(f"PAS: widening coarse nev {cp.nev} -> {nev_work} "
                  f"(guard buffer; pass coarse_params.nev >= {nev_work} "
                  f"to control it)")
        cp = replace(cp, nev=nev_work)
    nev, nev_out = nev_work, nev
    # replicated unless the coarsest level is level 0 itself
    res = gcg_solve(lvls[top].a_op, lvls[top].b_op, cp,
                    mesh=hier.mesh_at(top))
    x = res.evec[:, :nev]
    lam = torch.as_tensor(res.eval[:nev], device=x.device)
    if mesh is not None and top > 0:
        # every rank solved the same coarse problem; all take rank 0's
        lx = mesh.broadcast(torch.cat([lam[None, :], x]))
        lam, x = lx[0], lx[1:]
    history = [(top, lam.cpu().numpy().copy())]
    taken = []

    for level in range(top - 1, -1, -1):
        x = lvls[level].p_op.matvec(x)
        a_op, b_op = lvls[level].a_op, lvls[level].b_op
        n_sweeps = final_sweeps if level == 0 else sweeps_per_level
        hier_sub = hier.sub(level)
        sweeps = 0
        for _ in range(n_sweeps):
            lam, x = _pas_sweep(hier_sub, a_op, b_op, x, lam, nev,
                                bamg_cycles, composite=composite_rr)
            sweeps += 1
            if level == 0 and bool((_rel_res(a_op, b_op, x, lam, mesh)
                                    [:nev_out] < tol_rel).all()):
                break
        lam_h = lam.cpu().numpy().copy()
        history.append((level, lam_h))
        taken.append(sweeps)
        if verbose:
            print(f"PAS level {level}: lam[0:3] = {lam_h[:3]} ({sweeps} "
                  f"sweeps)")

    rel = _rel_res(lvls[0].a_op, lvls[0].b_op, x, lam, mesh).cpu().numpy()
    nev_conv = int(np.sum(np.cumprod(rel[:nev_out] < tol_rel)))
    return PASResult(eval=lam.cpu().numpy()[:nev_out], evec=x[:, :nev_out],
                     nev_conv=nev_conv, level_history=history, sweeps=taken)
